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
// per row of q, k, v and o, so with S in the hundreds the work is far past
// the memory ridge and is bound by operations.  This first kernel does them
// in f32 on the CUDA cores (67 TFLOP/s), not on the tensor cores (989 bf16);
// moving the two products to wgmma is the step after this one.  Design:
//   * one block per (batch, kv head, tile of 16 query rows), where a row is
//     one (query position, head of the group) pair, so the G heads of a
//     group share every K/V tile the block loads;
//   * K/V tiles of 32 keys are staged in shared memory as f32, read from
//     device memory 4 elements at a time, K with a row padded by 4 so that
//     each lane reading its own key 16 bytes at a time is conflict-free;
//   * each warp owns 4 rows; lane j scores key j of the tile against the
//     warp's rows (16-byte shared loads, 16 FMAs per 5 loads), the row max
//     and sum are warp shuffles, and each lane accumulates D/32 adjacent
//     output columns, read from the V tile as one vector;
//   * a causal block stops loading tiles past its last row's diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kKeys = 32;                     // keys per tile, one per lane
constexpr unsigned kFull = 0xffffffffu;

// 4 adjacent elements as f32; p is 4-element aligned (8 bytes for bf16,
// 16 for f32: the wrapper checks the base pointers).
__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
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
      x = load4f(q + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D + d);
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
        kx = load4f(k + off);
        vx = load4f(v + off);
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
    T* orow = o + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D + lane * kDL;
#pragma unroll
    for (int i = 0; i < kDL; ++i) store(orow + i, acc[rr][i] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int Hkv, int D, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid((Sq * (H / Hkv) + kRows - 1) / kRows, B * Hkv);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (D) {
    case 32:
      flash_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H, Hkv, causal, scale);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H, Hkv, causal, scale);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Skv, H, Hkv, causal, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, Hkv, D], o like q; f32, or bf16 when bf16;
// all contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int nns_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H, int Hkv,
                                   int D, int causal, float scale, int bf16,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Hkv <= 0 || H % Hkv ||
      B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, scale, s);
  return launch<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, scale, s);
}

extern "C" const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
