// Paged decode attention for Hopper, with a plain C interface.
//
// Replaces: nnstreamer_tpu/ops/attention.py, paged_attention (:429) and its
// Pallas TPU kernel _paged_kernel (:343).
//
// Computes, for one query token per row (T == 1),
//   o[b, h] = softmax(q[b, h] . K_b^T * scale) V_b
// where K_b / V_b are the first L = lens[b] positions of row b's blocks in a
// shared pool [n_pool, bs, Hkv, D]: logical position p of row b lives in
// pool block tables[b, p / bs] at offset p % bs.  Query head h reads kv head
// h / (H / Hkv) (GQA).  Table entries are clipped into the pool (a sentinel
// is never dereferenced for a live position).  Softmax runs online in f32.
// A row with L == 0 reads no block and writes zeros.  D is 32, 64 or 128;
// the TPU kernel's D % 128 gate was a Mosaic DMA limit and is gone.
//
// What bounds it on an H100: decode reads every live K/V row once and does
// 4*D flops per (query head, key) on them, about G flops per byte, far below
// the ridge: it is bound by bytes (each row's ceil(L/bs) blocks at
// Hkv * D * 2 * itemsize bytes per position).  Design:
//   * one thread block per (row, kv head): the G = H / Hkv query heads of the
//     group share every K/V row the block loads (each block read once per
//     group, the TPU kernel's contract);
//   * the row's live table entries are staged in shared memory once;
//   * each of the 4 warps takes tiles of kKeys positions round robin and
//     keeps its own online-softmax state per query head.  Lane i owns D/32
//     adjacent columns: it loads them for every position of the tile (the
//     warp reads each K/V row as one contiguous segment), all loads issued
//     unconditionally before any use so they are in flight together (a
//     ragged tile re-reads its last live row and masks it).  Scores are warp
//     sums of the lanes' partial dot products; the value sum needs no
//     shuffles, since every lane holds every score;
//   * the 4 warps' (max, sum, acc) are merged through shared memory.
// A long context on few rows leaves most SMs idle (B * Hkv blocks); splitting
// a row's blocks across thread blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// table entries a block may stage (dynamic shared memory, 4 bytes each; with
// the 16 KB merge buffer at G = 8, D = 128 the block stays under 48 KB)
constexpr int kMaxTable = 4096;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ o, int Hkv,
                       int bs, int max_blocks, int n_pool, float scale) {
  constexpr int kDL = D / 32;                       // columns per lane
  constexpr int kKeys = sizeof(T) == 2 ? 16 : 8;    // positions per warp tile
  using V = Vec<T, kDL>;
  extern __shared__ int s_tbl[];                    // the row's live table entries
  __shared__ float s_m[kWarps][G], s_l[kWarps][G];
  __shared__ __align__(16) float s_acc[kWarps][G][D];

  const int H = Hkv * G;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x - b * Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = max(0, min(lens[b], max_blocks * bs));
  const int nb = (L + bs - 1) / bs;
  for (int i = threadIdx.x; i < nb; i += kThreads)
    s_tbl[i] = min(max(tables[static_cast<size_t>(b) * max_blocks + i], 0), n_pool - 1);

  float qr[G][kDL], m[G], l[G], acc[G][kDL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const V x = *reinterpret_cast<const V*>(
        q + (static_cast<size_t>(b) * H + kvh * G + g) * D + lane * kDL);
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDL; ++i) {
      qr[g][i] = to_float(x.v[i]) * scale;
      acc[g][i] = 0.f;
    }
  }
  __syncthreads();  // s_tbl staged

  const int n_tiles = (L + kKeys - 1) / kKeys;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int k0 = t * kKeys;
    V kc[kKeys], vc[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int kp = min(k0 + j, L - 1);
      const int page = kp / bs, off = kp - page * bs;
      const size_t base =
          ((static_cast<size_t>(s_tbl[page]) * bs + off) * Hkv + kvh) * D + lane * kDL;
      kc[j] = *reinterpret_cast<const V*>(k_pool + base);
      vc[j] = *reinterpret_cast<const V*>(v_pool + base);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kKeys];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kDL; ++i) part = fmaf(qr[g][i], to_float(kc[j].v[i]), part);
        s[j] = k0 + j < L ? warp_sum(part) : -INFINITY;
        tile_max = fmaxf(tile_max, s[j]);
      }
      // the tile holds at least one live position, so m_new is finite
      const float m_new = fmaxf(m[g], tile_max);
      const float alpha = expf(m[g] - m_new);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kDL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
#pragma unroll
        for (int i = 0; i < kDL; ++i) acc[g][i] = fmaf(p, to_float(vc[j].v[i]), acc[g][i]);
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kDL; ++i) s_acc[warp][g][lane * kDL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // L == 0: no warp saw a position, emit zeros
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(s_m[w][g] - mx);  // 0 for a warp with no tile
        num = fmaf(s_acc[w][g][d], f, num);
        den = fmaf(s_l[w][g], f, den);
      }
    }
    store(o + (static_cast<size_t>(b) * H + kvh * G + g) * D + d,
          den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const int* tables,
             const int* lens, void* o, int B, int Hkv, int G, int bs,
             int max_blocks, int n_pool, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  const size_t smem = static_cast<size_t>(max_blocks) * sizeof(int);
  const dim3 grid(B * Hkv);
  switch (G) {
    case 1:
      paged_attention_kernel<T, D, 1><<<grid, kThreads, smem, stream>>>(qp, kp, vp, tables, lens, op, Hkv, bs, max_blocks, n_pool, scale);
      break;
    case 2:
      paged_attention_kernel<T, D, 2><<<grid, kThreads, smem, stream>>>(qp, kp, vp, tables, lens, op, Hkv, bs, max_blocks, n_pool, scale);
      break;
    case 4:
      paged_attention_kernel<T, D, 4><<<grid, kThreads, smem, stream>>>(qp, kp, vp, tables, lens, op, Hkv, bs, max_blocks, n_pool, scale);
      break;
    case 8:
      paged_attention_kernel<T, D, 8><<<grid, kThreads, smem, stream>>>(qp, kp, vp, tables, lens, op, Hkv, bs, max_blocks, n_pool, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* lens, void* o, int B, int Hkv, int G, int D, int bs,
           int max_blocks, int n_pool, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, tables, lens, o, B, Hkv, G, bs, max_blocks, n_pool, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, tables, lens, o, B, Hkv, G, bs, max_blocks, n_pool, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, tables, lens, o, B, Hkv, G, bs, max_blocks, n_pool, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, 1, H, D]; k/v pools [n_pool, bs, Hkv, D]; o like q; f32, or bf16
// when bf16; tables [B, max_blocks] int32; lens [B] int32; all contiguous on
// the current device.  H / Hkv is 1, 2, 4 or 8.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int nns_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lens, void* o, int B, int H,
                                   int Hkv, int D, int bs, int max_blocks,
                                   int n_pool, float scale, int bf16,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 || max_blocks <= 0 ||
      max_blocks > kMaxTable || n_pool <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(tables);
  const int* lp = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tp, lp, o, B, Hkv, G, D, bs, max_blocks, n_pool, scale, s);
  return launch<float>(q, k_pool, v_pool, tp, lp, o, B, Hkv, G, D, bs, max_blocks, n_pool, scale, s);
}

extern "C" const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
