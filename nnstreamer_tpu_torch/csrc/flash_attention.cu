// Flash attention (blockwise, online softmax) for Hopper, with a plain C
// interface.
//
// Replaces: nnstreamer_tpu/ops/attention.py, flash_attention (:210) and its
// Pallas TPU kernel _flash_kernel (:114).
//
// Computes o = softmax(q k^T * scale [+ causal mask]) v for q [B, Sq, H, D]
// and UNREPEATED k/v [B, Skv, Hkv, D] (GQA: query head h reads kv head
// h / (H / Hkv)).  Causal queries align to the back of kv: query i sees
// keys j <= i + (Skv - Sq).  Softmax runs online in f32; a row whose keys
// are all masked emits zeros (the exp(-inf - -inf) guard of the TPU
// kernel).  Any Sq and Skv are taken, ragged tiles are masked in the
// kernel, and D is 32, 64 or 128; the TPU kernel's Sq % block_q,
// Skv % block_k and D % 128 gates were Mosaic limits and are gone.
//
// What bounds it on an H100: prefill at the llama2_7b shapes (H = Hkv = 32,
// D = 128, S up to 1024) does 4*D flops per (query, key) pair on 4*D bytes
// per row of q, k, v and o.  At the 1023-row bucket the bytes (10.0 us at
// 3.35 TB/s) and the operations (8.7 us at 989 TFLOP/s bf16) nearly
// balance; shorter prompts lean to bytes.  Both products must therefore
// run on the tensor cores: on the CUDA cores (67 TFLOP/s in f32) the
// operations alone would take 128 us.
//
// Two kernels, chosen by dtype alone in nns_flash_attention:
//
// bf16 (the serving path), flash_bf16_kernel:
//   * a row is one (query position, head of the group) pair: row r of a
//     (batch, kv head) is query r / G, head kvh * G + r % G, so the G heads
//     of a group share every K/V tile the block loads;
//   * a block owns 128 rows of one (batch, kv head): two consumer
//     warpgroups of 64 rows and one producer warp.  Blocks are numbered so
//     that the longest causal rows launch first;
//   * the producer streams 128-key K and V tiles by TMA (4-D tensor maps
//     over [B, Skv, Hkv, D], 128-byte swizzle, the ragged tail zero-filled)
//     into a 2-stage ring, with one mbarrier per tile kind and stage and
//     one that the consumers release; tile j + 1 loads while tile j is
//     multiplied;
//   * S = Q K^T is wgmma m64n128k16 from shared memory (Q staged once per
//     block by the consumers in the swizzled layout TMA writes), f32
//     accumulators.  The online softmax runs on them in registers: a row's
//     values sit in the 4 lanes of a quad, so its max takes 2 shuffles and
//     its sum is reduced once, at the end;
//   * O += P V is wgmma with A = P from registers (the S accumulator
//     fragment packed to bf16 pairs is the A fragment of the next k16
//     slice) and B = V read from its [keys][D] tile through the transposed
//     (MN-major) descriptor: V is never transposed in memory;
//   * a causal block stops at its last row's diagonal, and a warpgroup
//     masks only the tiles that cross its own diagonal or the end of kv.
//   D = 32 runs as D = 64: TMA fills the missing columns with zeros.
//
// f32 (reference checks against the CPU), flash_f32_kernel, on the CUDA
// cores: wgmma takes no f32 operands (tf32 keeps 10 mantissa bits), so f32
// inputs keep the earlier design: one block per (batch, kv head, 16 rows),
// 32-key K/V tiles staged in shared memory, a warp per 4 rows with one key
// per lane, warp shuffles for the row max and sum.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper_tma.cuh"

namespace {

using namespace nns;

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32 inputs: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kKeys = 32;                     // keys per tile, one per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Skv, int H, int Hkv, int causal, float scale) {
  constexpr int kDL = D / 32;   // adjacent output columns per lane
  constexpr int kKS = D + 4;    // padded K row (16-byte aligned)
  __shared__ __align__(16) float s_q[kRows][D];
  __shared__ __align__(16) float s_k[kKeys][kKS];
  __shared__ __align__(16) float s_v[kKeys][D];

  const int G = H / Hkv;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y - b * Hkv;
  const int n_rows = Sq * G;  // row r = query position r / G, head kvh*G + r % G
  const int row0 = blockIdx.x * kRows;
  const int q_offset = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid * 4; i < kRows * D; i += kThreads * 4) {
    const int r = i / D, d = i - r * D, row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const int qp = row / G, h = kvh * G + row - qp * G;
      x = *reinterpret_cast<const float4*>(q + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D + d);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    *reinterpret_cast<float4*>(&s_q[r][d]) = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDL];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDL; ++i) acc[rr][i] = 0.f;
    qpos[rr] = min(row0 + warp * kRowsPerWarp + rr, n_rows - 1) / G;
  }

  int kv_end = Skv;
  if (causal) {
    const int last_q = (min(row0 + kRows, n_rows) - 1) / G;
    kv_end = min(Skv, last_q + q_offset + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and s_q is staged)
    for (int i = tid * 4; i < kKeys * D; i += kThreads * 4) {
      const int j = i / D, d = i - j * D, kj = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kj < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + kj) * Hkv + kvh) * D + d;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&s_k[j][d]) = kx;
      *reinterpret_cast<float4*>(&s_v[j][d]) = vx;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(&s_k[lane][d]);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qd = *reinterpret_cast<const float4*>(&s_q[warp * kRowsPerWarp + rr][d]);
        s[rr] = fmaf(qd.x, kd.x, fmaf(qd.y, kd.y, fmaf(qd.z, kd.z, fmaf(qd.w, kd.w, s[rr]))));
      }
    }

    const int kj = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool ok = kj < Skv && (!causal || kj <= qpos[rr] + q_offset);
      const float sc = ok ? s[rr] : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      // exp(-inf - -inf) would be nan: shift by 0 while a row is all masked
      const float shift = isinf(m_new) ? 0.f : m_new;
      p[rr] = expf(sc - shift);
      const float alpha = expf((isinf(m[rr]) ? shift : m[rr]) - shift);
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < kDL; ++i) acc[rr][i] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) pj[rr] = __shfl_sync(kFull, p[rr], j);
      float vv[kDL];
      const float* vrow = &s_v[j][lane * kDL];
      if constexpr (kDL == 4) {
        const float4 t = *reinterpret_cast<const float4*>(vrow);
        vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
      } else if constexpr (kDL == 2) {
        const float2 t = *reinterpret_cast<const float2*>(vrow);
        vv[0] = t.x; vv[1] = t.y;
      } else {
        vv[0] = vrow[0];
      }
#pragma unroll
      for (int i = 0; i < kDL; ++i)
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr][i] = fmaf(pj[rr], vv[i], acc[rr][i]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= n_rows) continue;
    const int qp = row / G, h = kvh * G + row - qp * G;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    float* orow = o + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D + lane * kDL;
#pragma unroll
    for (int i = 0; i < kDL; ++i) orow[i] = acc[rr][i] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (wgmma), K/V by TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 64;                        // rows per consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups per block
constexpr int kBlockRows = kBM * kConsumers;   // rows per block
constexpr int kBN = 128;                       // keys per tile
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kPanel = 64;                     // bf16 columns per 128-byte row
constexpr int kProducerWarp = kConsumers * 4;
constexpr int kThreadsBf16 = kConsumers * 128 + 32;

// Dynamic shared memory of one block, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).  Q, each K tile and
// each V tile are stored as DP / 64 panels of [rows][64] bf16, every row
// 128 bytes, 16-byte chunk c of row r at chunk c ^ (r % 8).
template <int D>
struct Layout {
  static constexpr int DP = D < kPanel ? kPanel : D;   // padded head dim
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kQPanel = kBlockRows * 128;      // bytes
  static constexpr int kTilePanel = kBN * 128;
  static constexpr int kTile = kTilePanel * kPanels;    // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQPanel * kPanels;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;     // 3 x kStages mbarriers
  static constexpr int kAlloc = kBar + 3 * kStages * 8 + 1024;
};

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: between 64-column panels; unused K-major), stride
// byte offset 1024 (between 8-row groups), all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d[64] (+)= A[64 x 16] * B[16 x 128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d[32] += A[64 x 16] * B[16 x 64]; A in registers, B MN-major in
// shared memory (the transpose flag).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64 x 16] * B[16 x 128]; A in registers, B MN-major in
// shared memory (the transpose flag).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                  int Sq, int Skv, int H, int Hkv, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int DP = L::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int G = H / Hkv;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x - b * Hkv;
  const int n_rows = Sq * G;  // row r = query position r / G, head kvh*G + r % G
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest first
  const int q_offset = Skv - Sq;
  // keys row r sees: 0 .. lim(r); -1 for none (or a row past the end)
  auto lim = [&](int row) {
    if (row >= n_rows) return -1;
    return causal ? min(Skv - 1, row / G + q_offset) : Skv - 1;
  };
  const int n_tiles = (lim(min(row0 + kBlockRows, n_rows) - 1) + kBN) / kBN;
  const int active = min(kConsumers, (n_rows - row0 + kBM - 1) / kBM);

  const uint32_t full_k = base + L::kBar, full_v = full_k + 8 * kStages,
                 empty = full_v + 8 * kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, (j / kStages - 1) & 1);
        const uint32_t kd = base + L::kK + s * L::kTile, vd = base + L::kV + s * L::kTile;
        mbar_expect_tx(full_k + 8 * s, L::kTile);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(kd + p * L::kTilePanel, &tm_k, full_k + 8 * s, p * kPanel, kvh, j * kBN, b);
        mbar_expect_tx(full_v + 8 * s, L::kTile);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(vd + p * L::kTilePanel, &tm_v, full_v + 8 * s, p * kPanel, kvh, j * kBN, b);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  if (wg >= active) return;

  // --- consumer warpgroup wg: rows wrow0 .. wrow0 + 63 ---
  const int t = tid & 127, w = t >> 5;
  const int wrow0 = row0 + wg * kBM;
  {  // stage the warpgroup's Q rows, swizzled as TMA writes them
    constexpr int kChunks = DP / 8;  // 16-byte chunks per row
    for (int i = t; i < kBM * kChunks; i += 128) {
      const int r = i / kChunks, c = i - r * kChunks, row = wrow0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_rows && c * 8 < D) {
        const int qp = row / G, h = kvh * G + row - qp * G;
        x = *reinterpret_cast<const uint4*>(
            q + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D + c * 8);
      }
      const int rb = wg * kBM + r;  // row within the block's Q tile
      *reinterpret_cast<uint4*>(smem + L::kQ + (c >> 3) * L::kQPanel + rb * 128 +
                                (((c & 7) ^ (rb & 7)) << 4)) = x;
    }
  }
  // generic-proxy writes of Q, then read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");

  // this thread's accumulator rows: r_lo and r_lo + 8 of the warpgroup
  const int r_lo = w * 16 + (lane >> 2);
  const int lim0 = lim(wrow0 + r_lo), lim1 = lim(wrow0 + r_lo + 8);
  const int wg_first = lim(wrow0);                          // fewest keys
  const int wg_tiles = (lim(min(wrow0 + kBM, n_rows) - 1) + kBN) / kBN;
  const uint32_t q_base = base + L::kQ + wg * kBM * 128;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(full_k + 8 * s, parity);
    if (j < wg_tiles) {
      // S = Q K^T over the head dim, k16 slices (D = 32 needs only two)
      float sc[kBN / 2];
      const uint32_t k_base = base + L::kK + s * L::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (D < 64 ? D : DP) / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 bf16 = 32 bytes along a row
        wgmma_ss_n128(sc, gmma_desc(q_base + (kk >> 2) * L::kQPanel + off, 16),
                      gmma_desc(k_base + (kk >> 2) * L::kTilePanel + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      pin(sc);

      // online softmax, log2 domain; element i of sc is row r_lo (+8 when
      // bit 1 of i is set), key j*kBN + (i/4)*8 + 2*(lane%4) + i%2
      const bool masked = (j + 1) * kBN - 1 > wg_first;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (masked) {
          const int key = j * kBN + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
          if (key > ((i & 2) ? lim1 : lim0)) x = -INFINITY;
        }
        sc[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // exp(-inf - -inf) would be nan: shift by 0 while a row is all masked
      const float sh0 = n0 == -INFINITY ? 0.f : n0, sh1 = n1 == -INFINITY ? 0.f : n1;
      const float al0 = fast_exp2((m0 == -INFINITY ? sh0 : m0) - sh0);
      const float al1 = fast_exp2((m1 == -INFINITY ? sh1 : m1) - sh1);
      m0 = n0;
      m1 = n1;
      uint32_t pa[kBN / 4];  // P as bf16 pairs: pa[4*kk .. 4*kk+3] is slice kk
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 2; i += 2) {
        const float sh = (i & 2) ? sh1 : sh0;
        const float p0 = fast_exp2(sc[i] - sh), p1 = fast_exp2(sc[i + 1] - sh);
        if (i & 2) sum1 += p0 + p1;
        else sum0 += p0 + p1;
        __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
        pa[i >> 1] = *reinterpret_cast<uint32_t*>(&pk);
      }
      l0 = l0 * al0 + sum0;  // this thread's share; the quad sums at the end
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;

      // O += P V, V [keys][DP] read MN-major: LBO steps 64 columns, SBO 8 keys
      mbar_wait(full_v + 8 * s, parity);
      const uint32_t v_base = base + L::kV + s * L::kTile;
      pin(acc);
      pin(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<DP>(acc, pa + 4 * kk, gmma_desc(v_base + kk * 16 * 128, L::kTilePanel));
      wgmma_commit();
      wgmma_wait();
      pin(acc);
      pin(pa);
    } else {
      mbar_wait(full_v + 8 * s, parity);  // past this warpgroup's diagonal
    }
    mbar_arrive(empty + 8 * s);
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wrow0 + r_lo + 8 * half;
    if (row >= n_rows) continue;
    const int qp = row / G, h = kvh * G + row - qp * G;
    __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
    const float inv = half ? inv1 : inv0;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = c * 8 + 2 * (lane & 3);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * c + 2 * half] * inv, acc[4 * c + 2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// [B, Skv, Hkv, D] bf16 as a 4-D tensor map (innermost first), boxes of
// 64 head-dim columns x 1 head x kBN keys, 128-byte swizzle; reads past
// Skv or D fill zeros.
int kv_map(CUtensorMap* map, const void* ptr, int B, int Skv, int Hkv, int D) {
  EncodeTiled enc = encoder();
  if (!enc) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Skv), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(Hkv) * D * 2,
                                 static_cast<cuuint64_t>(Skv) * Hkv * D * 2};
  const cuuint32_t box[4] = {kPanel, 1, kBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                int Skv, int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  int rc = kv_map(&tm_k, k, B, Skv, Hkv, D);
  if (!rc) rc = kv_map(&tm_v, v, B, Skv, Hkv, D);
  if (rc) return rc;
  constexpr int bytes = Layout<D>::kAlloc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_rows = static_cast<long long>(Sq) * (H / Hkv);
  const dim3 grid(B * Hkv, static_cast<unsigned>((n_rows + kBlockRows - 1) / kBlockRows));
  flash_bf16_kernel<D><<<grid, kThreadsBf16, bytes, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, H, Hkv, causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
               int H, int Hkv, int D, int causal, float scale, cudaStream_t stream) {
  if (B * Hkv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq * (H / Hkv) + kRows - 1) / kRows, B * Hkv);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  switch (D) {
    case 32:
      flash_f32_kernel<32><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H, Hkv, causal, scale);
      break;
    case 64:
      flash_f32_kernel<64><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H, Hkv, causal, scale);
      break;
    case 128:
      flash_f32_kernel<128><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H, Hkv, causal, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, Hkv, D], o like q; all f32, or all bf16 when
// `bf16`; contiguous on the current device, 16-byte aligned.  bf16 launches
// the tensor-core kernel, f32 the CUDA-core kernel: the dtype alone
// chooses.  Launches on `stream` and returns cudaGetLastError() (or an
// error of its own when the tensor maps cannot be built).
extern "C" int nns_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H, int Hkv,
                                   int D, int causal, float scale, int bf16,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_f32(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, scale, s);
  switch (D) {
    case 32: return launch_bf16<32>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, s);
    case 64: return launch_bf16<64>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, s);
    case 128: return launch_bf16<128>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nns_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled is not available from the driver";
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled refused the K/V tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
