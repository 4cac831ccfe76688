// Weight-only int4 matmul (w4a16) for Hopper, with a plain C interface.
//
// Replaces: nnstreamer_tpu/ops/int4_matmul.py, matmul_int4 (:193) and its
// Pallas TPU kernel _int4_kernel (:136).
//
// Computes, for b < B and f < F,
//   out[b, f] = scale[f] * sum_{r < d2} ( h[b, r] * lo(p[r, f]) + h[b, d2 + r] * hi(p[r, f]) )
// where p is the split-halves packing of pack_int4: lo = (t & 15) - 8 (the
// low nibble, stored biased), hi = t >> 4 (the high nibble, signed).  The
// TPU kernel's activation-side algebra (h_lo - h_hi/16 and a -8*rowsum
// correction) existed only because Mosaic has no int8 vector ops, and is
// not carried over.  Accumulation is f32 throughout; the scale is applied
// once, at the end; the output is f32 or bf16.
//
// What bounds it on an H100: decode calls it with B = 1..32 rows and reads
// each packed weight byte once for 4*B flops.  At B <= 32 that is under 128
// flop/byte, far below the ~295 flop/byte at which the card's bf16 rate
// would bind, so the time is the weight bytes over the 3.35 TB/s of device
// memory, plus a few microseconds of launch and tail per call.
//
// Two kernels, chosen by the activations' dtype alone in the wrappers:
//
// bf16 activations (the serving path), int4_bf16_kernel, on the tensor
// cores.  It computes out^T[F, B] = W^T h^T with wgmma m64nNk16: the output
// columns are wgmma's 64-row M side, the batch its N side (N = B rounded up
// to 8, 16 or 32).
//   * Dequantise once, into registers.  A (the weights) comes from
//     registers.  The K order inside the kernel is free as long as h^T
//     follows it: each k16 slice is 8 packed rows, first their 8 low
//     nibbles, then their 8 high ones.  The row order inside an M tile is
//     free too (the epilogue writes each row to its own column): a block
//     owns 128 columns as two M tiles, and thread (warp w, group g, lane
//     t of 4) owns columns w*32 + g*4 .. +3, rows g and g+8 of both
//     tiles, so its bytes of a packed row are one aligned 4-byte word; it
//     reads packed rows 2t and 2t+1 of each slice, whose low nibbles pair
//     up in one A register and high nibbles in another.  A byte pair
//     becomes a bf16 pair with a byte permute and one mask-and-or (or xor)
//     into the exponent of 128 (0x4300 | nibble is 128 + nibble), then one
//     bf16x2 subtract of 136: the low nibble is already biased +8, the high
//     one is xor-ed with 8 to bias it.
//   * B (h^T) comes from shared memory as K-major 8 x 8 core matrices
//     without swizzle.  A 4-D tensor map over h, (8 packed rows, batch row,
//     nibble, group of 8 packed rows), lets TMA write that layout directly
//     from the [B, 2*d2] rows: no staging pass, and only the B live rows
//     move (the columns past B read whatever follows and are never stored).
//   * Two rings, fed by a producer warp with TMA: the packed weights in 4
//     stages of 64 x 128-byte tiles (a 2-D tensor map over [d2, F] int8,
//     128-byte swizzle, zero fill past the edges), which the consumer
//     warpgroup hands back as soon as it has read its words, and h^T in 8
//     stages, handed back when the products that read them end.  The next
//     tile's words are read while a tile's products run.  When F is not a
//     multiple of 16 or d2 not of 8 (no tensor map describes the rows), the
//     producer warp copies that part with plain loads into the same layout.
//     Every mbarrier wait traps after 2^26 polls, so a lost transaction
//     fails the launch instead of hanging the card.
//   * Split-K, so that every mat fills the card: the grid is (column tiles,
//     splits), and the host's plan picks the splits and the packed rows per
//     split.  The reduction is deterministic and in a fixed order: each
//     split writes its f32 partials to a workspace, and the last block of a
//     column tile to take a ticket (an int32 counter per tile, reset by that
//     block) sums the partials in split order, applies the scale once and
//     writes the output.  Every thread of that block sums the very elements
//     it holds itself, so no shared memory is needed.  One launch per call;
//     no float atomics.  A row's result depends on nothing but its own
//     activations, and two calls give the same bits.
//
// f32 activations (reference checks against the CPU), int4_f32_kernel, on
// the CUDA cores: wgmma takes no f32 operands (tf32 keeps 10 mantissa
// bits), so f32 inputs keep the earlier design: one block per 128 output
// columns, each lane 4 adjacent columns read as one word, the 8 warps
// splitting the packed rows with 16 row loads in flight each, up to 8
// batch rows staged as f32 in shared memory, a cross-warp sum through
// shared memory.

#include <cuda_bf16.h>

#include "hopper_tma.cuh"

namespace {

using namespace nns;

// an error of the C entry beyond cudaError_t and hopper_tma.cuh's
constexpr int kErrPlan = 10003;       // a launch plan the kernel does not take

// ---------------------------------------------------------------------------
// f32 activations: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;
constexpr int kCols = 32 * kColsPerLane;  // output columns per block
constexpr int kChunk = 256;               // packed rows staged per step
constexpr int kInFlight = 16;             // row loads a warp issues at once

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 4 packed bytes of one row starting at column col0 (col0 < F).  VEC:
// F % 4 == 0, so the 4 bytes are in the row and 4-byte aligned.
template <bool VEC>
__device__ __forceinline__ char4 load4(const int8_t* row, int col0, int F) {
  if (VEC) return *reinterpret_cast<const char4*>(row + col0);
  char4 c;
  c.x = row[col0];
  c.y = row[min(col0 + 1, F - 1)];
  c.z = row[min(col0 + 2, F - 1)];
  c.w = row[min(col0 + 3, F - 1)];
  return c;
}

template <int NB>
__device__ __forceinline__ void accumulate(float (&acc)[NB][kColsPerLane], char4 c,
                                           const float* s_lo, const float* s_hi, int k) {
  const int t[kColsPerLane] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const float wlo = static_cast<float>((t[j] & 15) - 8);
    const float whi = static_cast<float>(t[j] >> 4);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      acc[b][j] = fmaf(s_lo[b * kChunk + k], wlo, fmaf(s_hi[b * kChunk + k], whi, acc[b][j]));
  }
}

template <typename TOut, int NB, bool VEC>
__global__ void __launch_bounds__(kThreads)
int4_f32_kernel(const float* __restrict__ h, const int8_t* __restrict__ packed,
                const float* __restrict__ scale, TOut* __restrict__ out,
                int B, int d2, int F) {
  // The staged activations and the cross-warp reduction never live at
  // the same time, so one buffer serves both.
  constexpr int kStage = 2 * NB * kChunk;
  constexpr int kReduce = kWarps * NB * kCols;
  __shared__ float smem[kStage > kReduce ? kStage : kReduce];
  float* s_lo = smem;               // [NB][kChunk]: h[b, k0 + k]
  float* s_hi = smem + NB * kChunk; // [NB][kChunk]: h[b, d2 + k0 + k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols + lane * kColsPerLane;
  const int din = 2 * d2;

  for (int b0 = 0; b0 < B; b0 += NB) {
    const int nb = min(NB, B - b0);
    float acc[NB][kColsPerLane];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[b][j] = 0.f;

    for (int k0 = 0; k0 < d2; k0 += kChunk) {
      const int kc = min(kChunk, d2 - k0);
      for (int i = tid; i < NB * kChunk; i += kThreads) {
        const int b = i / kChunk, k = i - b * kChunk;
        float lo = 0.f, hi = 0.f;
        if (b < nb && k < kc) {
          const float* row = h + static_cast<size_t>(b0 + b) * din + k0 + k;
          lo = row[0];
          hi = row[d2];
        }
        s_lo[i] = lo;
        s_hi[i] = hi;
      }
      __syncthreads();
      if (col0 < F) {
        for (int kk = warp; kk < kc; kk += kWarps * kInFlight) {
          char4 c[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            const int k = min(kk + u * kWarps, kc - 1);
            c[u] = load4<VEC>(packed + static_cast<size_t>(k0 + k) * F, col0, F);
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            const int k = kk + u * kWarps;
            if (k < kc) accumulate<NB>(acc, c[u], s_lo, s_hi, k);
          }
        }
      }
      __syncthreads();
    }

    float* red = smem;  // [kWarps][NB][kCols]
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j)
        red[(warp * NB + b) * kCols + lane * kColsPerLane + j] = acc[b][j];
    __syncthreads();
    for (int i = tid; i < NB * kCols; i += kThreads) {
      const int b = i / kCols, c = i - b * kCols;
      const int col = blockIdx.x * kCols + c;
      if (b < nb && col < F) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[(w * NB + b) * kCols + c];
        store(out + static_cast<size_t>(b0 + b) * F + col, s * scale[col]);
      }
    }
    __syncthreads();
  }
}

template <typename TOut, bool VEC>
void launch_f32(const float* h, const int8_t* packed, const float* scale, TOut* out,
                int B, int d2, int F, cudaStream_t stream) {
  const dim3 grid((F + kCols - 1) / kCols);
  // rows per pass: the smallest power of two covering min(B, 8)
  if (B >= 5)
    int4_f32_kernel<TOut, 8, VEC><<<grid, kThreads, 0, stream>>>(h, packed, scale, out, B, d2, F);
  else if (B >= 3)
    int4_f32_kernel<TOut, 4, VEC><<<grid, kThreads, 0, stream>>>(h, packed, scale, out, B, d2, F);
  else if (B == 2)
    int4_f32_kernel<TOut, 2, VEC><<<grid, kThreads, 0, stream>>>(h, packed, scale, out, B, d2, F);
  else
    int4_f32_kernel<TOut, 1, VEC><<<grid, kThreads, 0, stream>>>(h, packed, scale, out, B, d2, F);
}

template <typename TOut>
void launch_f32_out(const void* h, const void* packed, const void* scale, void* out,
                    int B, int d2, int F, cudaStream_t stream) {
  const float* hp = static_cast<const float*>(h);
  const int8_t* pp = static_cast<const int8_t*>(packed);
  const float* sp = static_cast<const float*>(scale);
  TOut* op = static_cast<TOut*>(out);
  if (F % 4 == 0)
    launch_f32<TOut, true>(hp, pp, sp, op, B, d2, F, stream);
  else
    launch_f32<TOut, false>(hp, pp, sp, op, B, d2, F, stream);
}

// ---------------------------------------------------------------------------
// bf16 activations: tensor cores (wgmma), weights and activations by TMA,
// split-K
// ---------------------------------------------------------------------------

constexpr int kTileCols = 128;                 // output columns per block: two M tiles
constexpr int kTileRows = 64;                  // packed rows per ring stage
constexpr int kStages = 4;                     // ring depth
constexpr int kWBytes = kTileRows * kTileCols; // packed weights of one stage
constexpr int kProducerWarp = 4;               // warps 0-3: the consumer warpgroup
constexpr int kThreadsBf16 = 5 * 32;
// flags of the C entry
constexpr int kFlagTmaW = 1;     // weights by TMA (else the producer warp copies them)
constexpr int kFlagTmaH = 2;     // activations by TMA (else the producer warp copies them)
constexpr int kFlagOutBf16 = 4;  // bf16 output (else f32)

// Two rings.  A weight stage is the packed weights [64 rows][128 bytes]
// (128-byte swizzle); the consumers read their words and hand it back at
// once.  An activation stage is h^T for the same 64 packed rows, 2 * 64 * B
// bf16 (room for N rows), read by the products and handed back when they
// end, so it has twice the stages: slice q (packed rows 8q .. 8q+7) holds
// the low nibbles' activations h[n, r] and then the high nibbles'
// h[n, d2 + r], element (n, nib, r) at ((2q + nib) * B + n) * 16 +
// 2 * (r % 8) bytes.  wgmma reads it as 8 x 8 core matrices, 8 batch rows
// apart by 128 bytes; rows past B read whatever follows and only feed
// output columns that are never stored, so the copy moves no padding.
constexpr int kHStages = 2 * kStages;
__host__ __device__ constexpr int h_stage_bytes(int n) { return 256 * n; }
// Dynamic shared memory from a 1024-byte aligned base: the two rings, the
// full and empty mbarriers of each stage, and the last-block flag.
__host__ __device__ constexpr int smem_bytes(int n) {
  return kStages * kWBytes + kHStages * h_stage_bytes(n) + 16 * (kStages + kHStages) + 16 +
         1024;
}

// wgmma shared-memory descriptor, K-major without swizzle (8 x 16-byte core
// matrices): start address, leading byte offset (between the two core
// matrices of a k16 slice), stride byte offset (between 8-row groups), all
// in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the compiler from touching wgmma operands between the start of the
// asynchronous product and its wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d[N/2] += A[64 x 16] * B[16 x N]; A in registers, B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte i of two packed words (rows r and r + 1) as two bf16 pairs: lo =
// the low nibbles (stored biased +8), hi = the high nibbles (signed), row r
// in each low half.  0x4300 | v is bf16 128 + v for v < 128, so after the
// mask (and, for the high nibble, an xor with 8 that biases it) one bf16x2
// subtract of 136 gives the signed values.
__device__ __forceinline__ void dequant(uint32_t a, uint32_t b, uint32_t a4, uint32_t b4, int i,
                                        uint32_t& lo, uint32_t& hi) {
  const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t y = (__byte_perm(a, b, sel) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y), bias);
  lo = *reinterpret_cast<uint32_t*>(&v);
  y = (__byte_perm(a4, b4, sel) & 0x000F000Fu) ^ 0x43084308u;
  v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y), bias);
  hi = *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of (row, byte col) in a 128-byte-swizzled weight tile.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

template <int N>
__global__ void __launch_bounds__(kThreadsBf16, N == 32 ? 2 : 3)
int4_bf16_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_h,
                 const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ packed,
                 const float* __restrict__ scale, void* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ tickets, int B, int d2, int F,
                 int rows_per_split, int splits, int flags) {
  constexpr int kHStage = h_stage_bytes(N);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t h_ring = base + kStages * kWBytes;
  const uint32_t full_w = h_ring + kHStages * kHStage, empty_w = full_w + 8 * kStages;
  const uint32_t full_h = empty_w + 8 * kStages, empty_h = full_h + 8 * kHStages;
  int* last_flag = reinterpret_cast<int*>(smem + (empty_h + 8 * kHStages - base));

  const int ft = blockIdx.x, split = blockIdx.y;
  const int col0 = ft * kTileCols;
  const int row0 = split * rows_per_split;               // first packed row
  const int rows = min(rows_per_split, d2 - row0);
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    // full: the producer's lane 0 with the TMA bytes, then its 32 lanes
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_w + 8 * s, 33);
      mbar_init(empty_w + 8 * s, 128);
    }
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(full_h + 8 * s, 33);
      mbar_init(empty_h + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    const bool tma_w = flags & kFlagTmaW, tma_h = flags & kFlagTmaH;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, sh = j % kHStages;
      if (j >= kStages) mbar_wait(empty_w + 8 * s, (j / kStages - 1) & 1);
      if (j >= kHStages) mbar_wait(empty_h + 8 * sh, (j / kHStages - 1) & 1);
      const int r0 = row0 + j * kTileRows;
      const uint32_t dst_w = base + s * kWBytes, dst_h = h_ring + sh * kHStage;
      if (lane == 0) {
        if (tma_w) {
          mbar_expect_tx(full_w + 8 * s, kWBytes);
          tma_load_2d(dst_w, &tm_w, full_w + 8 * s, col0, r0);
        } else {
          mbar_arrive(full_w + 8 * s);
        }
        // h as [d2/8 groups][2 nibbles][B rows][8]: two boxes of 4 groups
        if (tma_h) {
          mbar_expect_tx(full_h + 8 * sh, 256 * B);
          for (int p = 0; p < 2; ++p)
            tma_load_4d(dst_h + p * B * 128, &tm_h, full_h + 8 * sh, 0, 0, 0, r0 / 8 + 4 * p);
        } else {
          mbar_arrive(full_h + 8 * sh);
        }
      }
      if (!tma_w) {  // the tile as TMA would write it; zero past the split's rows and past F
        uint8_t* st = smem + s * kWBytes;
        for (int i = lane; i < kWBytes / 4; i += 32) {
          const int r = i / (kTileCols / 4), c = (i % (kTileCols / 4)) * 4, gr = r0 + r;
          uint32_t word = 0;
          if (gr < row0 + rows) {
            const uint8_t* src = reinterpret_cast<const uint8_t*>(packed) +
                                 static_cast<size_t>(gr) * F + col0 + c;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (col0 + c + q < F) word |= static_cast<uint32_t>(src[q]) << (8 * q);
          }
          *reinterpret_cast<uint32_t*>(st + swz(r, c)) = word;
        }
      }
      if (!tma_h) {  // (n, nib, r) at ((2 * (r / 8) + nib) * B + n) * 16 + 2 * (r % 8)
        uint16_t* dh = reinterpret_cast<uint16_t*>(smem + (dst_h - base));
        for (int i = lane; i < kTileRows * 2 * B; i += 32) {
          const int r = i % kTileRows, nib = (i / kTileRows) & 1, n = i / (2 * kTileRows);
          uint16_t v = 0;
          if (r0 + r < row0 + rows)
            v = reinterpret_cast<const uint16_t*>(h)[static_cast<size_t>(n) * 2 * d2 +
                                                     nib * d2 + r0 + r];
          dh[((2 * (r / 8) + nib) * B + n) * 8 + r % 8] = v;
        }
      }
      mbar_arrive(full_w + 8 * s);
      mbar_arrive(full_h + 8 * sh);
    }
    return;
  }

  // --- the consumer warpgroup ---
  const int w = warp, g = lane >> 2, t = lane & 3;
  const int my_col = w * 32 + g * 4;  // this thread's 4 columns of each packed row
  float acc0[N / 2], acc1[N / 2];     // M tile 0 and 1
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc0[i] = acc1[i] = 0.f;

  // slice q of a tile is packed rows 8q .. 8q+7: this thread reads rows
  // 8q + 2t and 8q + 2t + 1, then hands the weight stage back at once
  uint32_t words[2 * kTileRows / 8];
  auto load_words = [&](int j) {
    const int s = j % kStages;
    mbar_wait(full_w + 8 * s, (j / kStages) & 1);
    const uint8_t* tile = smem + s * kWBytes;
#pragma unroll
    for (int q = 0; q < kTileRows / 8; ++q) {
      words[2 * q] = *reinterpret_cast<const uint32_t*>(tile + swz(8 * q + 2 * t, my_col));
      words[2 * q + 1] = *reinterpret_cast<const uint32_t*>(tile + swz(8 * q + 2 * t + 1, my_col));
    }
    mbar_arrive(empty_w + 8 * s);
  };
  load_words(0);
  for (int j = 0; j < n_tiles; ++j) {
    const int sh = j % kHStages;
    // A fragments of slice q: register 0 (M row g) and 1 (row g + 8) hold
    // the low nibbles of packed rows 8q + 2t, 8q + 2t + 1, registers 2 and
    // 3 their high nibbles; bytes 0, 1 are M tile 0's rows g, g + 8,
    // bytes 2, 3 M tile 1's
    uint32_t a[kTileRows / 8][8];
#pragma unroll
    for (int q = 0; q < kTileRows / 8; ++q) {
      const uint32_t x = words[2 * q], y = words[2 * q + 1], x4 = x >> 4, y4 = y >> 4;
      dequant(x, y, x4, y4, 0, a[q][0], a[q][2]);
      dequant(x, y, x4, y4, 1, a[q][1], a[q][3]);
      dequant(x, y, x4, y4, 2, a[q][4], a[q][6]);
      dequant(x, y, x4, y4, 3, a[q][5], a[q][7]);
    }
    mbar_wait(full_h + 8 * sh, (j / kHStages) & 1);
    pin(acc0);
    pin(acc1);
    wgmma_fence();
    const uint32_t h_base = h_ring + sh * kHStage;
#pragma unroll
    for (int q = 0; q < kTileRows / 8; ++q) {
      const uint64_t db = gmma_desc(h_base + q * B * 32, B * 16, 128);
      wgmma_rs(acc0, &a[q][0], db);
      wgmma_rs(acc1, &a[q][4], db);
    }
    wgmma_commit();
    if (j + 1 < n_tiles) load_words(j + 1);  // while the products run
    wgmma_wait();
    pin(acc0);
    pin(acc1);
#pragma unroll
    for (int q = 0; q < kTileRows / 8; ++q) pin(a[q]);
    mbar_arrive(empty_h + 8 * sh);  // the products have read stage sh of h
  }

  // Thread (w, g, t) holds columns col0 + my_col + 0..3 for batch rows
  // 8jj + 2t + e: column +0 is tile 0's row g, +1 tile 0's row g + 8, +2 and
  // +3 tile 1's; batch row 8jj + 2t + e is accumulator 4jj + e (row g) or
  // 4jj + 2 + e (row g + 8).
  const int col = col0 + my_col;
  const int f_pad = gridDim.x * kTileCols;
  if (splits > 1) {
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = 8 * jj + 2 * t + e;
        if (b < B)
          *reinterpret_cast<float4*>(ws + (static_cast<size_t>(split) * B + b) * f_pad + col) =
              make_float4(acc0[4 * jj + e], acc0[4 * jj + 2 + e], acc1[4 * jj + e],
                          acc1[4 * jj + 2 + e]);
      }
    __threadfence();
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (tid == 0) *last_flag = atomicAdd(tickets + ft, 1) == splits - 1;
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (!*last_flag) return;
    __threadfence();
    if (tid == 0) tickets[ft] = 0;  // ready for the next launch
  }
  // the sums: the partials in split order (each split's loads issued
  // together), or this block's own accumulators
  float4 v[N / 8][2];
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = 8 * jj + 2 * t + e;
      v[jj][e] = make_float4(acc0[4 * jj + e], acc0[4 * jj + 2 + e], acc1[4 * jj + e],
                             acc1[4 * jj + 2 + e]);
      if (splits > 1 && b < B)
        v[jj][e] = __ldcg(reinterpret_cast<const float4*>(ws + static_cast<size_t>(b) * f_pad + col));
    }
  for (int sp = 1; sp < splits; ++sp)
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = 8 * jj + 2 * t + e;
        if (b < B) {
          const float4 p = __ldcg(reinterpret_cast<const float4*>(
              ws + (static_cast<size_t>(sp) * B + b) * f_pad + col));
          v[jj][e].x += p.x;
          v[jj][e].y += p.y;
          v[jj][e].z += p.z;
          v[jj][e].w += p.w;
        }
      }
  const float4 sc = make_float4(scale[min(col, F - 1)], scale[min(col + 1, F - 1)],
                                scale[min(col + 2, F - 1)], scale[min(col + 3, F - 1)]);
  const bool out_bf16 = flags & kFlagOutBf16;
  const bool vec_out = F % 4 == 0 && col + 3 < F;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = 8 * jj + 2 * t + e;
      if (b >= B) continue;
      const float4 u = v[jj][e];
      const float4 y = make_float4(u.x * sc.x, u.y * sc.y, u.z * sc.z, u.w * sc.w);
      const size_t o = static_cast<size_t>(b) * F + col;
      if (out_bf16) {
        __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out) + o;
        if (vec_out) {
          const __nv_bfloat162 p0 = __floats2bfloat162_rn(y.x, y.y), p1 = __floats2bfloat162_rn(y.z, y.w);
          uint2 pk;
          pk.x = *reinterpret_cast<const uint32_t*>(&p0);
          pk.y = *reinterpret_cast<const uint32_t*>(&p1);
          *reinterpret_cast<uint2*>(op) = pk;
        } else {
          const float yy[4] = {y.x, y.y, y.z, y.w};
          for (int q = 0; q < 4 && col + q < F; ++q) op[q] = __float2bfloat16(yy[q]);
        }
      } else {
        float* op = static_cast<float*>(out) + o;
        if (vec_out) {
          *reinterpret_cast<float4*>(op) = y;
        } else {
          const float yy[4] = {y.x, y.y, y.z, y.w};
          for (int q = 0; q < 4 && col + q < F; ++q) op[q] = yy[q];
        }
      }
    }
}

// packed [d2, F] int8 as a 2-D tensor map (columns innermost), boxes of
// 128 columns x 64 rows, 128-byte swizzle; reads past d2 or F fill zeros.
int weight_map(CUtensorMap* map, const void* packed, int d2, int F) {
  EncodeTiled enc = encoder();
  if (!enc) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(F)};
  const cuuint32_t box[2] = {kTileCols, kTileRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(packed), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// h [B, 2*d2] bf16 (d2 % 8 == 0) as a 4-D tensor map over (8 packed rows,
// batch row, nibble, group of 8 packed rows), innermost first, boxes of
// (8, B, 2, 4): in shared memory [4 groups][2 nibbles][B rows][8], the
// layout wgmma reads.  Groups past d2 / 8 fill zeros.
int act_map(CUtensorMap* map, const void* h, int B, int d2) {
  EncodeTiled enc = encoder();
  if (!enc) return kErrNoEncoder;
  const cuuint64_t dims[4] = {8, static_cast<cuuint64_t>(B), 2, static_cast<cuuint64_t>(d2 / 8)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d2) * 4, static_cast<cuuint64_t>(d2) * 2,
                                 16};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(B), 2, 4};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(h), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int N>
int launch_bf16(const CUtensorMap& tm_w, const CUtensorMap& tm_h, const void* h,
                const void* packed, const void* scale, void* out, void* ws, void* tickets,
                int B, int d2, int F, int rows_per_split, int splits, int flags,
                cudaStream_t stream) {
  constexpr int bytes = smem_bytes(N);
  const cudaError_t e = cudaFuncSetAttribute(
      int4_bf16_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((F + kTileCols - 1) / kTileCols, splits);
  int4_bf16_kernel<N><<<grid, kThreadsBf16, bytes, stream>>>(
      tm_w, tm_h, static_cast<const __nv_bfloat16*>(h), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), out, static_cast<float*>(ws),
      static_cast<int*>(tickets), B, d2, F, rows_per_split, splits, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 activations, on the tensor cores.  h [B, 2*d2] bf16, packed [d2, F]
// int8, scale [F] f32, out [B, F] (bf16 with kFlagOutBf16, else f32), all
// contiguous on the current device; ws: f32 [splits, B, ceil(F/128)*128]
// (unused when splits == 1); tickets: int32 [ceil(F/128)], zero, and left
// zero.  The plan (n = B rounded up to 8, 16 or 32; splits; packed rows
// per split, a multiple of 64) comes from the wrapper.  flags: kFlagTmaW
// (F % 16 == 0 and packed 16-byte aligned), kFlagTmaH (d2 % 8 == 0 and h
// 16-byte aligned), kFlagOutBf16.  Launches on `stream` and returns
// cudaGetLastError() or an error of its own.
extern "C" int nns_int4_matmul_bf16(const void* h, const void* packed, const void* scale,
                                    void* out, void* ws, void* tickets, int B, int d2, int F,
                                    int n, int splits, int rows_per_split, int flags,
                                    void* stream) {
  if (B <= 0 || d2 <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > n || rows_per_split <= 0 || rows_per_split % kTileRows || splits <= 0 ||
      static_cast<long long>(splits) * rows_per_split < d2 ||
      static_cast<long long>(splits - 1) * rows_per_split >= d2 || splits > 65535)
    return kErrPlan;
  CUtensorMap tm_w = {}, tm_h = {};
  if (flags & kFlagTmaW) {
    const int rc = weight_map(&tm_w, packed, d2, F);
    if (rc) return rc;
  }
  if (flags & kFlagTmaH) {
    if (d2 % 8) return kErrPlan;
    const int rc = act_map(&tm_h, h, B, d2);
    if (rc) return rc;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_bf16<8>(tm_w, tm_h, h, packed, scale, out, ws, tickets, B, d2, F, rows_per_split, splits, flags, s);
    case 16: return launch_bf16<16>(tm_w, tm_h, h, packed, scale, out, ws, tickets, B, d2, F, rows_per_split, splits, flags, s);
    case 32: return launch_bf16<32>(tm_w, tm_h, h, packed, scale, out, ws, tickets, B, d2, F, rows_per_split, splits, flags, s);
    default: return kErrPlan;
  }
}

// f32 activations, on the CUDA cores.  h [B, 2*d2] f32, packed [d2, F]
// int8, scale [F] f32, out [B, F] (f32, or bf16 when out_bf16); all
// contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int nns_int4_matmul_f32(const void* h, const void* packed, const void* scale,
                                   void* out, int B, int d2, int F, int out_bf16,
                                   void* stream) {
  if (B <= 0 || d2 <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch_f32_out<__nv_bfloat16>(h, packed, scale, out, B, d2, F, s);
  else
    launch_f32_out<float>(h, packed, scale, out, B, d2, F, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nns_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled is not available from the driver";
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled refused the weight tensor map";
  if (err == kErrPlan) return "the launch plan is not one the int4 kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
