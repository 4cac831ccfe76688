// Weight-only int4 matmul (w4a16) for Hopper, with a plain C interface.
//
// Replaces: nnstreamer_tpu/ops/int4_matmul.py, matmul_int4 (:193) and its
// Pallas TPU kernel _int4_kernel (:136).
//
// Computes, for b < B and f < F,
//   out[b, f] = scale[f] * sum_{r < d2} ( h[b, r] * lo(p[r, f]) + h[b, d2 + r] * hi(p[r, f]) )
// where p is the split-halves packing of pack_int4: lo = (t & 15) - 8 (the
// low nibble, stored biased), hi = t >> 4 (the high nibble, signed, by an
// arithmetic shift).  The nibbles are unpacked directly; the TPU kernel's
// activation-side algebra (h_lo - h_hi/16 and a -8*rowsum correction)
// existed only because Mosaic has no int8 vector ops, and is not carried
// over.  Accumulation is f32 throughout; the scale is applied once at the
// end; the output is f32 or bf16.
//
// What bounds it on an H100: decode calls it with B = 1..32 rows, and it
// reads each packed weight byte once for 4*B flops.  At B <= 32 that is
// under 128 flop/byte, far below the ~295 flop/byte at which the card's
// bf16 rate would bind, so the time is the weight bytes over the 3.35 TB/s
// of device memory.  Design against that:
//   * one block per tile of 128 output columns; each lane owns 4 adjacent
//     columns and reads them as one 4-byte word, so a warp reads 128
//     contiguous bytes of a packed row;
//   * the block's 8 warps split the packed rows between them, and each
//     warp keeps 16 row loads in flight before it computes on them.  The
//     loads are unconditional (a row past the end re-reads the last row
//     and is masked in the arithmetic): a load whose result meets a branch
//     or a select is waited for there, which serialized them;
//   * the activations for up to 8 batch rows are staged in shared memory
//     as f32, 256 packed rows at a time (any Din fits), and read there as
//     broadcasts; more than 8 rows run as further passes over the weights;
//   * the warps' partial sums are reduced through shared memory, which
//     the staging buffer is reused for.
// Known cost: at F = 4096 there are only 32 blocks for 132 SMs, too few
// loads in flight to reach the memory rate; splitting the rows across
// blocks is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;
constexpr int kCols = 32 * kColsPerLane;  // output columns per block
constexpr int kChunk = 256;               // packed rows staged per step
constexpr int kInFlight = 16;             // row loads a warp issues at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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

template <typename TIn, typename TOut, int NB, bool VEC>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const TIn* __restrict__ h, const int8_t* __restrict__ packed,
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
          const TIn* row = h + static_cast<size_t>(b0 + b) * din + k0 + k;
          lo = to_f32(row[0]);
          hi = to_f32(row[d2]);
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

template <typename TIn, typename TOut, bool VEC>
void launch(const void* h, const void* packed, const void* scale, void* out,
            int B, int d2, int F, cudaStream_t stream) {
  const dim3 grid((F + kCols - 1) / kCols);
  const TIn* hp = static_cast<const TIn*>(h);
  const int8_t* pp = static_cast<const int8_t*>(packed);
  const float* sp = static_cast<const float*>(scale);
  TOut* op = static_cast<TOut*>(out);
  // rows per pass: the smallest power of two covering min(B, 8)
  if (B >= 5)
    int4_matmul_kernel<TIn, TOut, 8, VEC><<<grid, kThreads, 0, stream>>>(hp, pp, sp, op, B, d2, F);
  else if (B >= 3)
    int4_matmul_kernel<TIn, TOut, 4, VEC><<<grid, kThreads, 0, stream>>>(hp, pp, sp, op, B, d2, F);
  else if (B == 2)
    int4_matmul_kernel<TIn, TOut, 2, VEC><<<grid, kThreads, 0, stream>>>(hp, pp, sp, op, B, d2, F);
  else
    int4_matmul_kernel<TIn, TOut, 1, VEC><<<grid, kThreads, 0, stream>>>(hp, pp, sp, op, B, d2, F);
}

template <typename TIn, typename TOut>
void launch(const void* h, const void* packed, const void* scale, void* out,
            int B, int d2, int F, cudaStream_t stream) {
  if (F % 4 == 0)
    launch<TIn, TOut, true>(h, packed, scale, out, B, d2, F, stream);
  else
    launch<TIn, TOut, false>(h, packed, scale, out, B, d2, F, stream);
}

}  // namespace

// h [B, 2*d2] (f32, or bf16 when h_bf16), packed [d2, F] int8, scale [F]
// f32, out [B, F] (f32, or bf16 when out_bf16); all contiguous on the
// current device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int nns_int4_matmul(const void* h, const void* packed, const void* scale,
                               void* out, int B, int d2, int F, int h_bf16,
                               int out_bf16, void* stream) {
  if (B <= 0 || d2 <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(h, packed, scale, out, B, d2, F, s);
  else if (h_bf16)
    launch<__nv_bfloat16, float>(h, packed, scale, out, B, d2, F, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(h, packed, scale, out, B, d2, F, s);
  else
    launch<float, float>(h, packed, scale, out, B, d2, F, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
