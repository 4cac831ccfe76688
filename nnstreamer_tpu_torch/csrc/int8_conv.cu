// Integer convolution, int8 x int8 -> int32, NHWC, for Hopper, with a plain
// C interface.
//
// Replaces no TPU kernel.  The JAX package runs a fully-quantized .tflite
// graph's CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED as XLA integer
// convolutions and dots (lax.conv_general_dilated / lax.dot_general with
// preferred_element_type=int32, nnstreamer_tpu/models/tflite.py:685 and
// :742), outside any Pallas call.  Through PyTorch there is no int8
// convolution on the card (cuDNN's is not exposed), and a float32
// convolution stops summing integers exactly once |acc| passes 2^24 (a
// 3x3 conv over 512 channels reaches ~7.5e7), so the port computes these
// sums here, exactly, as the JAX package does.
//
// Computes, for an input already padded (the caller pads with the input's
// zero point, so every window is full and the call is VALID),
//   out[b, y, x, o] = sum_{ky, kx, c < Cg} x[b, y*sh + ky*dh, x*sw + kx*dw, g*Cg + c]
//                                          * w[o, ky, kx, c]
// with g = o / (O / groups) and Cg = Cin / groups: x [B, Hp, Wp, Cin] int8,
// w [O, kh, kw, Cg] int8 (TFLite's OHWI; a depthwise [1, kh, kw, cin*mult]
// kernel is [cin*mult, kh, kw, 1] with groups = cin), out [B, OH, OW, O]
// int32.  A FULLY_CONNECTED layer is a 1x1 conv over [B, 1, 1, K].
// int32 sums wrap as XLA's do; no MobileNet-class layer comes near 2^31.
//
// What bounds it on an H100: MobileNet-v1's layers at batch 64 do 2*K
// operations for each output of 4 bytes, K = 27 .. 9,216, so the int8
// tensor-core rate (1,979 TOPS) and the memory rate (3.35 TB/s) meet at
// K ~ 1,200: the pointwise layers and the FC are bound by operations, the
// depthwise layers and the first conv by bytes.  This first kernel is
// simple and right, not fast: it runs on the CUDA cores (__dp4a, four int8
// products a lane an instruction), far from the tensor cores' rate.  IMMA
// (mma.sync s8) or wgmma s8 with TMA is later work; PERF.md holds its times
// against the bound.
//
// Two kernels, chosen by the wrapper (ops/int8_conv.py, int8_conv_route):
//   * gemm (groups = 1 and Cin % 4 == 0): an implicit GEMM, M = B*OH*OW
//     output pixels by N = O channels over K = kh*kw*Cin.  A block of 256
//     threads owns a 64 x 64 output tile and walks K in chunks of 32 bytes:
//     each thread loads two 4-byte words of the input patches and two of the
//     weights (a word never crosses a channel run, since Cin % 4 == 0), the
//     chunk goes to shared memory as [word][row], and each thread sums a 4 x
//     4 sub-tile with __dp4a, reading its four rows and four columns as one
//     16-byte load each.  The next chunk's words are loaded into registers
//     while the current one is summed.
//   * direct (any groups, any Cin: the first 3-channel conv, depthwise
//     layers, the ones-weight box sums): one thread per output, an int32
//     multiply-add loop over its window; neighbouring threads take
//     neighbouring output channels, so a depthwise layer's input bytes are
//     read coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kErrShape = 1001;
constexpr int kErrRoute = 1002;

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kChunkWords = 8;  // 32 bytes of K a chunk
constexpr int kThreads = 256;

struct Geometry {
  int B, Hp, Wp, Cin, O, kh, kw, sh, sw, dh, dw, groups, OH, OW;
};

// Idx: the index type, 32-bit where the output's element count fits (the
// divisions that split an index are then 32-bit ones).
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    int8_conv_direct_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                            int32_t* __restrict__ out, Geometry g) {
  const Idx total = static_cast<Idx>(g.B) * g.OH * g.OW * g.O;
  const int cg = g.Cin / g.groups;
  const int og = g.O / g.groups;
  for (Idx idx = blockIdx.x * static_cast<Idx>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<Idx>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(idx % g.O);
    Idx p = idx / g.O;
    const int ox = static_cast<int>(p % g.OW);
    p /= g.OW;
    const int oy = static_cast<int>(p % g.OH);
    const int b = static_cast<int>(p / g.OH);
    const int8_t* xb = x + ((static_cast<long long>(b) * g.Hp + oy * g.sh) * g.Wp + ox * g.sw)
                               * g.Cin + (o / og) * cg;
    const int8_t* wb = w + static_cast<long long>(o) * g.kh * g.kw * cg;
    int acc = 0;
    for (int ky = 0; ky < g.kh; ++ky) {
      for (int kx = 0; kx < g.kw; ++kx) {
        const int8_t* xp = xb + (static_cast<long long>(ky) * g.dh * g.Wp + kx * g.dw) * g.Cin;
        const int8_t* wp = wb + (ky * g.kw + kx) * cg;
        for (int c = 0; c < cg; ++c) acc += static_cast<int>(xp[c]) * static_cast<int>(wp[c]);
      }
    }
    out[idx] = acc;
  }
}

// The offset, in bytes, of K position k inside one output pixel's window.
__device__ __forceinline__ long long window_offset(int k, const Geometry& g) {
  const int run = g.kw * g.Cin;
  const int ky = k / run;
  const int rem = k - ky * run;
  const int kx = rem / g.Cin;
  const int c = rem - kx * g.Cin;
  return (static_cast<long long>(ky) * g.dh * g.Wp + kx * g.dw) * g.Cin + c;
}

__global__ void __launch_bounds__(kThreads)
    int8_conv_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                          int32_t* __restrict__ out, Geometry g) {
  __shared__ __align__(16) int a_s[kChunkWords][kTileM];
  __shared__ __align__(16) int b_s[kChunkWords][kTileN];

  const long long M = static_cast<long long>(g.B) * g.OH * g.OW;
  const int N = g.O;
  const int K = g.kh * g.kw * g.Cin;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int t = threadIdx.x;

  // This thread's two load slots: rows (or columns) t/8 and t/8 + 32 of
  // the tile, word t%8 of the chunk.
  const int word = t % kChunkWords;
  const int lrow[2] = {t / kChunkWords, t / kChunkWords + kThreads / kChunkWords};
  const int8_t* xrow[2];
  const int8_t* wrow[2];
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + lrow[r];
    xrow[r] = nullptr;
    if (m < M) {
      const int ox = static_cast<int>(m % g.OW);
      const long long p = m / g.OW;
      const int oy = static_cast<int>(p % g.OH);
      const int b = static_cast<int>(p / g.OH);
      xrow[r] = x + ((static_cast<long long>(b) * g.Hp + oy * g.sh) * g.Wp + ox * g.sw) * g.Cin;
    }
    const int n = n0 + lrow[r];
    wrow[r] = n < N ? w + static_cast<long long>(n) * K : nullptr;
  }

  int a_reg[2], b_reg[2];
  auto load = [&](int k0) {
    const int k = k0 + 4 * word;
    const bool in_k = k < K;
    const long long off = in_k ? window_offset(k, g) : 0;
    for (int r = 0; r < 2; ++r) {
      a_reg[r] = (in_k && xrow[r]) ? *reinterpret_cast<const int*>(xrow[r] + off) : 0;
      b_reg[r] = (in_k && wrow[r]) ? *reinterpret_cast<const int*>(wrow[r] + k) : 0;
    }
  };
  auto stash = [&]() {
    for (int r = 0; r < 2; ++r) {
      a_s[word][lrow[r]] = a_reg[r];
      b_s[word][lrow[r]] = b_reg[r];
    }
  };

  // Each thread sums rows ty*4 .. +3 and columns tx*4 .. +3 of the tile.
  const int tx = t % 16, ty = t / 16;
  int acc[4][4] = {};
  load(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += 4 * kChunkWords) {
    const bool more = k0 + 4 * kChunkWords < K;
    if (more) load(k0 + 4 * kChunkWords);
#pragma unroll
    for (int kk = 0; kk < kChunkWords; ++kk) {
      const int4 a = *reinterpret_cast<const int4*>(&a_s[kk][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&b_s[kk][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// route 0: the direct kernel, 1: the implicit GEMM (groups = 1, Cin % 4 == 0,
// x and w 4-byte aligned).  Returns cudaGetLastError() after the launch, or
// an error of this file's own for a shape or route it does not take.
extern "C" int nns_int8_conv(const void* x, const void* w, void* out, int B, int Hp, int Wp,
                             int Cin, int O, int kh, int kw, int sh, int sw, int dh, int dw,
                             int groups, int OH, int OW, int route, void* stream) {
  const Geometry g{B, Hp, Wp, Cin, O, kh, kw, sh, sw, dh, dw, groups, OH, OW};
  if (B <= 0 || Hp <= 0 || Wp <= 0 || Cin <= 0 || O <= 0 || kh <= 0 || kw <= 0 || sh <= 0 ||
      sw <= 0 || dh <= 0 || dw <= 0 || groups <= 0 || OH <= 0 || OW <= 0 ||
      Cin % groups || O % groups || (OH - 1) * sh + (kh - 1) * dh >= Hp ||
      (OW - 1) * sw + (kw - 1) * dw >= Wp)
    return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(B) * OH * OW;
  if (route == 1) {
    if (groups != 1 || Cin % 4 || reinterpret_cast<uintptr_t>(x) % 4 ||
        reinterpret_cast<uintptr_t>(w) % 4)
      return kErrRoute;
    const long long m_tiles = (M + kTileM - 1) / kTileM;
    const int n_tiles = (O + kTileN - 1) / kTileN;
    if (m_tiles > 0x7fffffffLL || n_tiles > 65535) return kErrShape;
    int8_conv_gemm_kernel<<<dim3(static_cast<unsigned>(m_tiles), n_tiles), kThreads, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<int32_t*>(out), g);
  } else if (route == 0) {
    const long long total = M * O;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    if (total < (1LL << 31) - static_cast<long long>(blocks) * kThreads)
      int8_conv_direct_kernel<unsigned><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<int32_t*>(out), g);
    else
      int8_conv_direct_kernel<long long><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<int32_t*>(out), g);
  } else {
    return kErrRoute;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nns_error_string(int err) {
  if (err == kErrShape) return "the int8 conv kernel does not take this geometry";
  if (err == kErrRoute) return "the int8 conv route does not take this input";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
