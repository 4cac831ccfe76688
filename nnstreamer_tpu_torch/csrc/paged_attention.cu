// Paged attention for Hopper (decode steps and short suffixes), with a
// plain C interface.
//
// Replaces: nnstreamer_tpu/ops/attention.py, paged_attention (:429) and its
// Pallas TPU kernel _paged_kernel (:343).
//
// Computes, for the T query rows of each batch row b (T = 1 for a decode
// step, T = k + 1 for a speculative verify step),
//   o[b, t, h] = softmax(q[b, t, h] . K_b^T * scale, keys <= L - T + t) V_b
// where L = lens[b] and K_b / V_b are the first L positions of row b's
// blocks in a shared pool [n_pool, bs, Hkv, D]: position p lives in pool
// block tables[b, p / bs] at offset p % bs.  Query head h reads kv head
// h / G, G = H / Hkv (GQA).  Table entries are clipped into the pool (a
// sentinel is never dereferenced for a live position).  A query row with
// no position to attend (L - T + t < 0; every row when L == 0) gives zeros.
// D is 32, 64 or 128; G is 1, 2, 4 or 8; G * T is at most 64.
//
// What bounds it on an H100: every live K/V row is read once and takes
// 4 * D flops per query row of its kv head, about G * T flops per byte,
// far below the 295 flops/byte ridge: bytes (each row's live positions at
// Hkv * D * 2 * itemsize bytes).  The earlier kernel reached 10-21% of
// that bound: one block per (row, kv head) left most SMs idle behind the
// longest row, its warps had 16 loads in flight and no copy overlapped
// compute, and every score was a 5-step shuffle sum per query head.
// Design (flash-decoding):
//   * split: a row's positions are cut into partitions of part_len (a
//     multiple of bs and of 16; 256 at bs = 16), and the grid has one block
//     per (row, kv head, partition) over a full table.  A block past its
//     row's L exits at once.  The plan of a row depends only on its own L,
//     never on the other rows, so a row's result does not either;
//   * each block writes f32 partials (max, sum, unnormalised output) for
//     the G * T query rows of its kv head to a workspace the caller
//     allocates; a second kernel, launched by the same C call, one block
//     per query row, reads the row's ceil(L / part_len) partitions' partials
//     and writes the normalised output, every sum in a fixed order.  No
//     float atomics and no counters: the result is bitwise repeatable and a
//     call holds no device state.  The merge is a programmatic dependent
//     launch (griddepcontrol), so its launch overlaps the split's tail;
//   * bf16, paged_split_bf16: one producer warp stages the partition's
//     table entries in shared memory and keeps a ring of 8 K and V tiles
//     of 16 positions in flight by TMA (one tensor map per
//     pool over [n_pool, bs, Hkv, D], boxes of 64 columns x gcd(bs, 16)
//     positions of one kv head, 128-byte swizzle), on mbarriers.  Four
//     consumer warps run the products on the tensor cores with mma.sync
//     m16n8k16 in the FlashAttention-2 register layout: the query rows of
//     the kv head are the A operand (16 rows per M tile, Q kept in
//     registers), K comes by ldmatrix, S stays in registers and becomes
//     P's A fragment for O += P V with V by ldmatrix.trans.  A row max or
//     sum over keys is 2 shuffles.  With one or two M tiles, 4 or 2 warps
//     share an M tile and take its tiles in turn, each writing its own
//     partial (the merge reads `splits` partials per partition);
//   * f32, paged_split_f32 (reference checks): CUDA-core products in the
//     same split/merge design (tf32 would keep 10 mantissa bits): a warp
//     per query row, lane i owning D / 32 adjacent columns, 8 positions at
//     a time, scores as warp sums.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper_tma.cuh"

namespace {

using namespace nns;

constexpr unsigned kFull = 0xffffffffu;
// an error of the C entry beyond cudaError_t and hopper_tma.cuh's
constexpr int kErrPlan = 10003;   // a launch plan the kernel does not take
// table width the C entry takes (the earlier kernel staged whole tables)
constexpr int kMaxTable = 4096;
constexpr int kMaxRows = 64;      // G * T query rows of a kv head: 4 M tiles
constexpr int kTile = 16;         // positions per ring stage (P V's k16)
constexpr int kConsumers = 4;     // consumer warps of a bf16 block
constexpr int kThreadsBf16 = (kConsumers + 1) * 32;
constexpr int kPanel = 64;        // bf16 columns per 128-byte shared row
constexpr int kWarpsF32 = 4;
constexpr int kKeysF32 = 8;       // positions per f32 warp step

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The merge is launched as a programmatic dependent of the split kernel:
// its blocks may be scheduled once every split block has started, which
// hides the second launch's latency, and wait for the whole split grid to
// finish, its partials visible, before they read anything.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_split() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The row limits of one (row, partition): clipped context, and the last
// position query row r may attend (L - T + t, t = r / G; -1 or less for
// none).  Rows at or past `rows` pad an M tile: they see the whole context.
struct RowLimits {
  int L, L_raw, T, G, rows;
  __device__ int lim(int r) const {
    return r < rows ? min(L - 1, L_raw - T + r / G) : L - 1;
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), K/V by TMA
// ---------------------------------------------------------------------------

// Dynamic shared memory of one block, from a 1024-byte aligned base: the K
// and V rings, each tile DP / 64 panels of [16 positions][64 columns] bf16,
// 128 bytes a row, 16-byte chunk c of row r at chunk c ^ (r % 8) (what the
// 128-byte swizzle of TMA writes); then the full and empty mbarrier of each
// stage and the partition's table entries.
template <int D>
struct Ring {
  static constexpr int DP = D < kPanel ? kPanel : D;  // D = 32 loads 64 columns, zero-filled
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kTilePanel = kTile * 128;
  static constexpr int kTileBytes = kTilePanel * kPanels;
  // a multiple of every split count: the tiles of a stage then always go
  // to the same warps, so no warp waits on a stage more than one phase
  // ahead of it (an mbarrier's parity tells only two phases apart)
  static constexpr int kStages = 8;
  static constexpr int kK = 0;
  static constexpr int kV = kStages * kTileBytes;
  static constexpr int kBar = 2 * kStages * kTileBytes;
  static constexpr int kTbl = kBar + 2 * kStages * 8;
  static int bytes(int entries) { return kTbl + 4 * entries + 1024; }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` (8 columns) of tile row `row`.
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  return (chunk >> 3) * (kTile * 128) + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 2)
paged_split_bf16(const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __nv_bfloat16* __restrict__ q, const int* __restrict__ tables,
                 const int* __restrict__ lens, float* __restrict__ ws_acc,
                 float* __restrict__ ws_ml, int T, int G, int Hkv, int bs, int box_rows,
                 int max_blocks, int n_pool, int part_len, int n_parts, int splits,
                 float scale_log2) {
  using R = Ring<D>;
  launch_dependents();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* s_tbl = reinterpret_cast<int*>(smem_raw + (base - raw) + R::kTbl);

  const int part = blockIdx.x % n_parts, bh = blockIdx.x / n_parts;
  const int kvh = bh % Hkv, b = bh / Hkv;
  const int L_raw = max(lens[b], 0);
  const RowLimits lim{min(L_raw, max_blocks * bs), L_raw, T, G, G * T};
  const int p0 = part * part_len;
  if (p0 >= lim.L) return;  // past the row's context: no partial
  const int n_tiles = (min(lim.L, p0 + part_len) - p0 + kTile - 1) / kTile;
  const int m_tiles = (lim.rows + 15) / 16;

  const uint32_t full = base + R::kBar, empty = full + 8 * R::kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 32 * m_tiles);  // the warps of one tile, one per M tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer: the entries of positions p0 .. p0 + 16 * n_tiles - 1 (p0 is
    // block aligned), clipped into the pool; a tile past the table's end
    // reads the last pool block and is masked
    const int e0 = p0 / bs, n_ent = (n_tiles * kTile + bs - 1) / bs;
    for (int i = lane; i < n_ent; i += 32) {
      const int e = e0 + i;
      s_tbl[i] = e < max_blocks
                     ? min(max(tables[static_cast<size_t>(b) * max_blocks + e], 0), n_pool - 1)
                     : n_pool - 1;
    }
    __syncwarp();
    if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % R::kStages;
        if (j >= R::kStages) mbar_wait(empty + 8 * s, (j / R::kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * R::kTileBytes);
        const uint32_t kd = base + R::kK + s * R::kTileBytes, vd = base + R::kV + s * R::kTileBytes;
        for (int r0 = 0; r0 < kTile; r0 += box_rows) {
          const int pos = p0 + j * kTile + r0;
          const int blk = s_tbl[pos / bs - e0], off = pos % bs;
#pragma unroll
          for (int p = 0; p < R::kPanels; ++p) {
            const uint32_t o = p * R::kTilePanel + r0 * 128;
            tma_load_4d(kd + o, &tm_k, full + 8 * s, p * kPanel, kvh, off, blk);
            tma_load_4d(vd + o, &tm_v, full + 8 * s, p * kPanel, kvh, off, blk);
          }
        }
      }
    }
    return;
  }

  // consumer warp: M tile mt, every splits-th tile of the partition from sub
  const int mt = warp / splits, sub = warp - mt * splits;
  if (mt >= m_tiles) return;
  const int H = Hkv * G, c = lane & 3;
  const int ra = mt * 16 + (lane >> 2), rb = ra + 8;  // this thread's rows
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qb = q + static_cast<size_t>(b) * T * H * D;
    auto word = [&](int r, int col) -> uint32_t {
      if (r >= lim.rows) return 0u;
      const int t = r / G, h = kvh * G + r - t * G;
      return *reinterpret_cast<const uint32_t*>(qb + (static_cast<size_t>(t) * H + h) * D + col);
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + 2 * c;
      qa[kk][0] = word(ra, col);
      qa[kk][1] = word(rb, col);
      qa[kk][2] = word(ra, col + 8);
      qa[kk][3] = word(rb, col + 8);
    }
  }
  const int lim0 = lim.lim(ra), lim1 = lim.lim(rb);
  const int wmin = lim.lim(mt * 16);  // the M tile's fewest positions
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // ldmatrix lane addresses: x4 of K gives (keys 0-7 | 8-15) x (columns
  // 0-7 | 8-15) of a k16 slice; x4.trans of V gives (keys 0-7 | 8-15) x
  // (columns 0-7 | 8-15) of two n8 tiles
  const int k_row = ((lane >> 4) << 3) + (lane & 7), k_chunk = (lane >> 3) & 1;
  const int v_row = (((lane >> 3) & 1) << 3) + (lane & 7), v_chunk = lane >> 4;

  for (int j = sub; j < n_tiles; j += splits) {
    const int s = j % R::kStages;
    mbar_wait(full + 8 * s, (j / R::kStages) & 1);
    const uint32_t kt = base + R::kK + s * R::kTileBytes, vt = base + R::kV + s * R::kTileBytes;
    // S = Q K^T: sc[n] holds keys n * 8 .. n * 8 + 7 of the tile
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + tile_off(k_row, 2 * kk + k_chunk));
      mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
      mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
    }
    // online softmax, log2 domain; element e of sc[n] is row (e < 2 ? ra :
    // rb), key k0 + n * 8 + 2 * c + (e & 1)
    const int k0 = p0 + j * kTile;
    const bool masked = k0 + kTile - 1 > wmin;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (masked && k0 + n * 8 + 2 * c + (e & 1) > (e < 2 ? lim0 : lim1)) x = -INFINITY;
        sc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
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
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = fast_exp2(sc[n][e] - (e < 2 ? sh0 : sh1));
    l0 = l0 * al0 + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);  // the quad sums at the end
    l1 = l1 * al1 + (p[0][2] + p[0][3] + p[1][2] + p[1][3]);
    // P's A fragment is S's accumulator layout: keys 2c, 2c+1 | 8+2c, 9+2c
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // O += P V over this tile's 16 keys
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + tile_off(v_row, 2 * np + v_chunk));
      mma_bf16(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();
    mbar_arrive(empty + 8 * s);
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  // partial (part, sub) of this (row, kv head): m, l, then acc[D]
  const size_t first = ((static_cast<size_t>(b) * Hkv + kvh) * n_parts + part) * splits + sub;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= lim.rows) continue;
    const size_t at = first * lim.rows + r;
    if (c == 0)
      *reinterpret_cast<float2*>(ws_ml + 2 * at) = make_float2(half ? m1 : m0, half ? l1 : l0);
    float* acc = ws_acc + at * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc + n * 8 + 2 * c) =
          make_float2(o[n][2 * half], o[n][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the same split and merge
// ---------------------------------------------------------------------------

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <int D>
__global__ void __launch_bounds__(kWarpsF32 * 32)
paged_split_f32(const float* __restrict__ q, const float* __restrict__ k_pool,
                const float* __restrict__ v_pool, const int* __restrict__ tables,
                const int* __restrict__ lens, float* __restrict__ ws_acc,
                float* __restrict__ ws_ml, int T, int G, int Hkv, int bs, int max_blocks,
                int n_pool, int part_len, int n_parts, float scale_log2) {
  constexpr int kDL = D / 32;  // columns per lane
  using V = Vec<float, kDL>;
  extern __shared__ int s_ent[];  // the partition's table entries
  launch_dependents();

  const int part = blockIdx.x % n_parts, bh = blockIdx.x / n_parts;
  const int kvh = bh % Hkv, b = bh / Hkv;
  const int L_raw = max(lens[b], 0);
  const RowLimits lim{min(L_raw, max_blocks * bs), L_raw, T, G, G * T};
  const int p0 = part * part_len;
  if (p0 >= lim.L) return;
  const int p1 = min(lim.L, p0 + part_len);
  const int e0 = p0 / bs;
  for (int i = threadIdx.x; i < (p1 - p0 + bs - 1) / bs; i += blockDim.x)
    s_ent[i] = min(max(tables[static_cast<size_t>(b) * max_blocks + e0 + i], 0), n_pool - 1);
  __syncthreads();

  const int H = Hkv * G, lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < lim.rows; r += kWarpsF32) {
    const int t = r / G, h = kvh * G + r - t * G;
    const int end = min(p1, lim.lim(r) + 1);  // this row's positions: p0 .. end - 1
    const V x = *reinterpret_cast<const V*>(
        q + ((static_cast<size_t>(b) * T + t) * H + h) * D + lane * kDL);
    float qr[kDL], acc[kDL], m = -INFINITY, l = 0.f;
#pragma unroll
    for (int i = 0; i < kDL; ++i) {
      qr[i] = x.v[i] * scale_log2;
      acc[i] = 0.f;
    }
    for (int k0 = p0; k0 < end; k0 += kKeysF32) {
      V kc[kKeysF32], vc[kKeysF32];
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) {  // a ragged step re-reads its last live row
        const int kp = min(k0 + j, end - 1);
        const size_t at =
            ((static_cast<size_t>(s_ent[kp / bs - e0]) * bs + kp % bs) * Hkv + kvh) * D + lane * kDL;
        kc[j] = *reinterpret_cast<const V*>(k_pool + at);
        vc[j] = *reinterpret_cast<const V*>(v_pool + at);
      }
      float sc[kKeysF32], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) {
        float part_dot = 0.f;
#pragma unroll
        for (int i = 0; i < kDL; ++i) part_dot = fmaf(qr[i], kc[j].v[i], part_dot);
        sc[j] = k0 + j < end ? warp_sum(part_dot) : -INFINITY;
        mx = fmaxf(mx, sc[j]);
      }
      const float m_new = fmaxf(m, mx);  // finite: the step holds a live position
      const float alpha = exp2f(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kDL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) {
        const float pj = exp2f(sc[j] - m_new);
        psum += pj;
#pragma unroll
        for (int i = 0; i < kDL; ++i) acc[i] = fmaf(pj, vc[j].v[i], acc[i]);
      }
      l = l * alpha + psum;
      m = m_new;
    }
    const size_t at = ((static_cast<size_t>(b) * Hkv + kvh) * n_parts + part) * lim.rows + r;
    if (lane == 0) *reinterpret_cast<float2*>(ws_ml + 2 * at) = make_float2(m, l);
#pragma unroll
    for (int i = 0; i < kDL; ++i) ws_acc[at * D + lane * kDL + i] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// merge: a query row's partials, in a fixed order
// ---------------------------------------------------------------------------

constexpr int kMergeWarps = 4;

// max (or sum) over the block's threads, in a fixed order
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // s_red is free again
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = s_red[0];
#pragma unroll
  for (int w = 1; w < kMergeWarps; ++w) x = kMax ? fmaxf(x, s_red[w]) : x + s_red[w];
  return x;
}

// One block per query row (row b, query t, head h): the row's max over its
// ceil(L / part_len) * splits partials, their weighted sums of l, and the
// weighted sum of their outputs, each warp summing every 4th partial over
// all D columns; every sum in a fixed order.
template <typename OutT, int D>
__global__ void __launch_bounds__(kMergeWarps * 32)
paged_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
            const int* __restrict__ lens, OutT* __restrict__ o, int T, int G, int Hkv,
            int span, int part_len, int n_parts, int splits) {
  constexpr int kDL = D / 32;
  using V = Vec<float, kDL>;
  __shared__ float s_red[kMergeWarps];
  __shared__ __align__(16) float s_num[kMergeWarps][D];
  wait_for_split();
  const int rows = G * T;
  const int r = blockIdx.x % rows, bh = blockIdx.x / rows;
  const int kvh = bh % Hkv, b = bh / Hkv;
  const int L = min(max(lens[b], 0), span);
  const int n_sub = (L + part_len - 1) / part_len * splits;
  const size_t first = (static_cast<size_t>(b) * Hkv + kvh) * n_parts * splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto ml = [&](int s) { return ws_ml + 2 * ((first + s) * rows + r); };

  float mx = -INFINITY;
  for (int s = threadIdx.x; s < n_sub; s += blockDim.x) mx = fmaxf(mx, ml(s)[0]);
  mx = block_reduce<true>(mx, s_red);
  // mx == -inf: no partial saw a position, and the row gives zeros
  const float shift = mx == -INFINITY ? 0.f : mx;
  float den = 0.f;
  for (int s = threadIdx.x; s < n_sub; s += blockDim.x) den += exp2f(ml(s)[0] - shift) * ml(s)[1];
  den = block_reduce<false>(den, s_red);

  float num[kDL];
#pragma unroll
  for (int i = 0; i < kDL; ++i) num[i] = 0.f;
#pragma unroll 4
  for (int s = warp; s < n_sub; s += kMergeWarps) {
    const float w = exp2f(ml(s)[0] - shift);  // 0 for a partial that saw none
    const V a = *reinterpret_cast<const V*>(ws_acc + ((first + s) * rows + r) * D + lane * kDL);
#pragma unroll
    for (int i = 0; i < kDL; ++i) num[i] = fmaf(w, a.v[i], num[i]);
  }
#pragma unroll
  for (int i = 0; i < kDL; ++i) s_num[warp][lane * kDL + i] = num[i];
  __syncthreads();
  const int t = r / G, h = kvh * G + r - t * G;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float x = s_num[0][d];
#pragma unroll
    for (int w = 1; w < kMergeWarps; ++w) x += s_num[w][d];
    store(o + ((static_cast<size_t>(b) * T + t) * Hkv * G + h) * D + d, den > 0.f ? x / den : 0.f);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// A pool [n_pool, bs, Hkv, D] bf16 as a 4-D tensor map (innermost first),
// boxes of 64 head-dim columns x 1 head x box_rows positions x 1 block,
// 128-byte swizzle; columns past D (D = 32) fill zeros.
int pool_map(CUtensorMap* map, const void* ptr, int n_pool, int bs, int Hkv, int D, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(bs), static_cast<cuuint64_t>(n_pool)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(Hkv) * D * 2,
                                 static_cast<cuuint64_t>(bs) * Hkv * D * 2};
  const cuuint32_t box[4] = {kPanel, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

struct Args {
  const void *q, *k, *v;
  const int *tables, *lens;
  void* o;
  float *ws_acc, *ws_ml;
  int B, T, G, Hkv, bs, max_blocks, n_pool, part_len, n_parts, splits;
  float scale_log2;
  cudaStream_t stream;
};

template <typename OutT, int D>
int launch_merge(const Args& a) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv * a.G * a.T);
  cfg.blockDim = dim3(kMergeWarps * 32);
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_merge<OutT, D>, static_cast<const float*>(a.ws_acc),
      static_cast<const float*>(a.ws_ml), a.lens, static_cast<OutT*>(a.o), a.T, a.G, a.Hkv,
      a.max_blocks * a.bs, a.part_len, a.n_parts, a.splits);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a) {
  const int box_rows = gcd_int(a.bs, kTile);
  CUtensorMap tm_k, tm_v;
  int rc = pool_map(&tm_k, a.k, a.n_pool, a.bs, a.Hkv, D, box_rows);
  if (!rc) rc = pool_map(&tm_v, a.v, a.n_pool, a.bs, a.Hkv, D, box_rows);
  if (rc) return rc;
  const int bytes = Ring<D>::bytes(a.part_len / a.bs);
  const cudaError_t e = cudaFuncSetAttribute(
      paged_split_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_split_bf16<D><<<a.B * a.Hkv * a.n_parts, kThreadsBf16, bytes, a.stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(a.q), a.tables, a.lens, a.ws_acc, a.ws_ml,
      a.T, a.G, a.Hkv, a.bs, box_rows, a.max_blocks, a.n_pool, a.part_len, a.n_parts, a.splits,
      a.scale_log2);
  rc = static_cast<int>(cudaGetLastError());
  return rc ? rc : launch_merge<__nv_bfloat16, D>(a);
}

template <int D>
int launch_f32(const Args& a) {
  const size_t bytes = static_cast<size_t>(a.part_len / a.bs) * sizeof(int);
  paged_split_f32<D><<<a.B * a.Hkv * a.n_parts, kWarpsF32 * 32, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.tables, a.lens, a.ws_acc, a.ws_ml, a.T, a.G, a.Hkv,
      a.bs, a.max_blocks, a.n_pool, a.part_len, a.n_parts, a.scale_log2);
  const int rc = static_cast<int>(cudaGetLastError());
  return rc ? rc : launch_merge<float, D>(a);
}

}  // namespace

// q [B, T, H, D]; k/v pools [n_pool, bs, Hkv, D]; o like q; all f32, or all
// bf16 when `bf16`; tables [B, max_blocks] int32; lens [B] int32; ws an f32
// workspace of B * Hkv * n_parts * splits * G * T * (D + 2) floats; all
// contiguous on the current device, q and the pools 16-byte aligned.  The
// plan (part_len, n_parts, splits) comes from the caller: part_len a
// multiple of bs and of 16, n_parts * part_len >= max_blocks * bs, splits
// consumer warps per M tile for bf16 (1 for f32).  Launches the split and
// the merge kernel on `stream` and returns cudaGetLastError() (or an error
// of its own when the plan or the tensor maps are refused).
extern "C" int nns_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* lens, void* o, void* ws,
                                   int B, int T, int H, int Hkv, int D, int bs, int max_blocks,
                                   int n_pool, int part_len, int n_parts, int splits,
                                   float scale, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 || max_blocks <= 0 ||
      max_blocks > kMaxTable || n_pool <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv, rows = G * T;
  const int m_tiles = (rows + 15) / 16, m_pow2 = m_tiles > 2 ? 4 : m_tiles;
  if ((G != 1 && G != 2 && G != 4 && G != 8) || rows > kMaxRows || part_len <= 0 ||
      part_len % kTile || part_len % bs ||
      static_cast<long long>(n_parts) * part_len < static_cast<long long>(max_blocks) * bs ||
      splits < 1 || (bf16 ? splits * m_pow2 > kConsumers || kConsumers % splits : splits != 1))
    return kErrPlan;
  float* acc = static_cast<float*>(ws);
  const size_t n_partials = static_cast<size_t>(B) * Hkv * n_parts * splits * rows;
  const Args a{q, k_pool, v_pool, static_cast<const int*>(tables), static_cast<const int*>(lens),
               o, acc, acc + n_partials * D, B, T, G, Hkv, bs, max_blocks, n_pool, part_len,
               n_parts, splits, scale * 1.4426950408889634f, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return bf16 ? launch_bf16<32>(a) : launch_f32<32>(a);
    case 64: return bf16 ? launch_bf16<64>(a) : launch_f32<64>(a);
    case 128: return bf16 ? launch_bf16<128>(a) : launch_f32<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nns_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled is not available from the driver";
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled refused a pool tensor map";
  if (err == kErrPlan) return "the launch plan is not one the paged kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
