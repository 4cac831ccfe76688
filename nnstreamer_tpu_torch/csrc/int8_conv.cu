// Integer convolution of a fully-quantized .tflite layer, NHWC, for Hopper,
// with the requantization fused in: uint8 or int8 activation in, the next
// activation out (or the int32 sum), one launch a layer.  Plain C interface.
//
// Replaces no TPU kernel.  The JAX package runs a fully-quantized graph's
// CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED as XLA integer convolutions
// and dots (lax.conv_general_dilated / lax.dot_general with
// preferred_element_type=int32, nnstreamer_tpu/models/tflite.py:685 and
// :742) requantized by _requant_acc (:628), outside any Pallas call.  PyTorch
// has no int8 convolution on the card, and a float32 one stops summing
// integers exactly past 2^24, so the port computes these layers here.
//
// For each output (b, y, x, o), with g = o / (O / groups), Cg = Cin / groups:
//   v   = sum_{ky, kx, c < Cg} x8[b, y*sh - pt + ky*dh, x*sw - pl + kx*dw, g*Cg + c]
//                               * w[o, ky, kx, c]
//         + cb[o] - wz[o] * sum_x[b, y, x, g]          (int32, wrapping as XLA's adds)
//   out = clamp(rint(f32(v) * mult[o]) + zp, lo, hi)   (f32: the JAX package's order)
// x is the layer's unpadded activation [B, H, W, Cin], uint8 (x8 = x - 128,
// done as an XOR of 0x80 on every byte) or int8 (x8 = x); a tap outside the
// image reads pad8, the input zero point in the int8 domain (SAME padding in
// the kernel).  w is [O, kh, kw, Cg] int8 (TFLite's OHWI; a depthwise
// [1, kh, kw, cin*mult] kernel is [cin*mult, kh, kw, 1] with groups = cin); a
// FULLY_CONNECTED layer is a 1x1 conv over [B, 1, 1, K].  cb = correction +
// bias, folded in int32 at open (models/tflite.py _prepare_conv); wz and
// sum_x (the box sum of a weight zero point, this same kernel's int32 output
// over a ones weight) are null where every weight zero point is 0.  The f32
// steps are __int2float_rn, __fmul_rn, rintf (half to even) and __fadd_rn,
// never contracted into an FMA; the clamp and the cast back are exact.
// out_kind 0 writes v as int32 (the box sum, and int8_conv's plain sums).
//
// What bounds it on an H100 (3.35 TB/s, 1,979 int8 TOPS): MobileNet-v1 at
// batch 64 with a one-byte output moves 1 byte in and 1 byte out an output
// for 2*K operations, K = 9 .. 9,216, so every layer but the two widest 1x1
// at 7x7 is bound by bytes; the forward's bound is ~0.2 ms.  Four kernels,
// chosen by the wrapper (ops/int8_conv.py, int8_conv_kernel):
//   * gemm (groups = 1, Cin % 4 == 0: the pointwise layers, the FC, a k x k
//     conv over such channels): an implicit GEMM on the int8 tensor cores,
//     mma.sync m16n8k32 s8, M = B*OH*OW pixels by N = O channels over K =
//     kh*kw*Cin.  Stages of 64 or 128 bytes of K go through a ring of 4 to 6
//     shared-memory stages filled by cp.async (16-byte copies where Cin % 16
//     == 0, else 4-byte ones, each inside one tap; zero-filled past M, N and
//     K; a pad tap is stored as the pad word), rows XOR-swizzled
//     so ldmatrix reads them without bank conflicts; the uint8 shift is an
//     XOR of each A fragment.  The epilogue requantizes the accumulators,
//     stages the tile's bytes in shared memory and writes them as 16-byte
//     rows.  Tiles by shape (a sweep on the H100): 128x64 for N <= 64, 64x16
//     for M <= 1024 (the FC: 63 blocks stream its weights), 64x128 for M <=
//     4096, else 128x128; with 4-byte copies 128x48 (3 stages), or 128x64
//     where N <= 64 is not a multiple of 48.
//   * depthwise (groups = Cin = O, 3x3, Cin % 4 == 0, column stride 1 or 2):
//     one thread, four adjacent channels of four pixels along x; its 36
//     weight bytes come as 9 words and stay in registers, the three input
//     rows' columns are 4-byte loads (a pad tap the pad word) shared by the
//     four pixels, taps 0-3 and 4-7 are transposed into per-channel words
//     (PRMT) for __dp4a, tap 8 meets a weight word masked to its channel; 4
//     output bytes are one store.
//   * dense (groups = 1, kh = 3, kw*Cin <= 12, unit column dilation, O % 8 ==
//     0, O <= 64: the first 3-channel conv): the block stages every weight
//     in shared memory, 12 words a channel (zero past kw*Cin), read as
//     16-byte broadcasts; a thread takes one pixel and all its channels, so
//     the window is loaded once: each row is aligned 4-byte loads
//     funnel-shifted into place (the image's edge built byte by byte), then
//     9 __dp4a a channel; 8 output bytes a store.
//   * direct (anything else: grouped convs, depthwise multipliers, odd
//     channel counts): one thread an output.
// A box sum takes whichever kernel its ones weight's shape takes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kErrShape = 1001;
constexpr int kErrRoute = 1002;
constexpr int kErrAlign = 1003;

enum Route { kDirect = 0, kGemm = 1, kDepthwise = 2, kDense = 3 };
enum OutKind { kOutInt32 = 0, kOutInt8 = 1, kOutUint8 = 2 };

struct Conv {
  const uint8_t* x;
  const int8_t* w;
  void* out;
  const int* cb;       // [O] or null
  const float* mult;   // [O]; null for an int32 output
  const int* wz;       // [O] or null
  const int* sum_x;    // [B, OH, OW, groups] when wz is set
  int B, H, W, Cin, O, kh, kw, sh, sw, dh, dw, groups, OH, OW, pt, pl;
  uint32_t flip;  // 0x80808080 for a uint8 input (the shift into int8), else 0
  int pad8;       // the pad tap's value, int8 domain
  int out_kind, zp, lo, hi;
};

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// The JAX package's f32 requantization of one int32 sum; the result is an
// integer in [lo, hi], cast exactly (y + 1.5 * 2^23 holds it in its low bits).
__device__ __forceinline__ int requant(int v, float mult, float zpf, float lo, float hi) {
  float y = __fadd_rn(rintf(__fmul_rn(__int2float_rn(v), mult)), zpf);
  y = fminf(fmaxf(y, lo), hi);
  return __float_as_int(__fadd_rn(y, kMagic)) - kMagicBits;
}

// cb and the weight-zero-point term of output channel o at pixel m.
__device__ __forceinline__ int fused_sum(const Conv& p, int acc, int o, long long m) {
  int v = acc;
  if (p.cb) v = wrap_add(v, __ldg(p.cb + o));
  if (p.wz)
    v = wrap_sub(v, wrap_mul(__ldg(p.wz + o),
                             __ldg(p.sum_x + m * p.groups + o / (p.O / p.groups))));
  return v;
}

// ---------------------------------------------------------------------------
// gemm: implicit GEMM on mma.sync m16n8k32 s8
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void st_shared_word(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(v));
}
__device__ __forceinline__ void st_shared_word4(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v), "r"(v), "r"(v),
               "r"(v));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// D = A * B + D, int32 accumulators wrapping (no .satfinite), as XLA's sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The byte offset of 16-byte chunk ch of row r inside a [rows][BK] tile:
// chunks XOR-swizzled so that eight consecutive rows' same chunk hit all
// 32 banks (ldmatrix reads 8 rows of one chunk at a time).
template <int BK>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  const int phys = BK == 128 ? ch ^ (r & 7) : ch ^ ((r >> 1) & 3);
  return static_cast<uint32_t>(r * BK + (phys << 4));
}

template <int BM, int BN, int BK, int STAGES>
constexpr int gemm_smem() {
  return STAGES * (BM + BN) * BK > BM * (BN + 16) ? STAGES * (BM + BN) * BK : BM * (BN + 16);
}

// Fills one ring stage: A (BM pixels' K bytes) and B (BN weight rows),
// chunk-swizzled rows for ldmatrix, by cp.async, zero past M, N and K, the
// pad word for a pad tap.  VEC: bytes a copy, 16 (Cin % 16 == 0: a chunk
// lies in one tap) or 4 (Cin % 4 == 0: each of a chunk's four words lies in
// one tap, and a pixel's or a weight row's start is only 4-byte aligned).
// POINTWISE: a 1x1 stride-1 unpadded conv, whose A row m is the contiguous
// pixel m (no window arithmetic).  Each thread owns rows lrow + i *
// kRowsPerPass at one chunk.
template <int BM, int BN, int BK, int kThreads, bool POINTWISE, int VEC>
struct TileLoader {
  static_assert(VEC == 16 || VEC == 4, "copy size");
  static constexpr int kChunks = BK / 16;
  static constexpr int kRowsPerPass = kThreads / kChunks;
  static constexpr int A_IT = BM / kRowsPerPass, B_IT = (BN + kRowsPerPass - 1) / kRowsPerPass;
  static_assert(A_IT >= 1 && A_IT * kRowsPerPass == BM, "tile");
  const Conv& p;
  const uint32_t a_s, b_s;
  const int K, run, chunk, lrow;
  const uint32_t pad4;
  const uint8_t* a_ptr[A_IT];
  int a_iy[A_IT], a_ix[A_IT];
  bool a_ok[A_IT];
  const int8_t* b_ptr[B_IT];
  bool b_ok[B_IT];

  __device__ TileLoader(const Conv& p_, uint32_t a_s_, uint32_t b_s_, long long m0, int n0,
                        int tid)
      : p(p_), a_s(a_s_), b_s(b_s_), K(p_.kh * p_.kw * p_.Cin), run(p_.kw * p_.Cin),
        chunk(tid % kChunks), lrow(tid / kChunks),
        // a pad tap as stored: the XOR at fragment load turns it into pad8
        pad4((static_cast<uint32_t>(p_.pad8 & 0xFF) * 0x01010101u) ^ p_.flip) {
    const long long M = static_cast<long long>(p.B) * p.OH * p.OW;
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const long long m = m0 + lrow + i * kRowsPerPass;
      a_ok[i] = m < M;
      a_ptr[i] = p.x;
      a_iy[i] = a_ix[i] = 0;
      if (a_ok[i]) {
        if (POINTWISE) {
          a_ptr[i] = p.x + m * p.Cin;
        } else {
          const int ox = static_cast<int>(m % p.OW);
          const long long t = m / p.OW;
          const int oy = static_cast<int>(t % p.OH);
          const int b = static_cast<int>(t / p.OH);
          a_ptr[i] = p.x + static_cast<long long>(b) * p.H * p.W * p.Cin;
          a_iy[i] = oy * p.sh - p.pt;
          a_ix[i] = ox * p.sw - p.pl;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int r = lrow + i * kRowsPerPass, n = n0 + r;
      b_ok[i] = r < BN && n < p.O;
      b_ptr[i] = p.w + static_cast<long long>(b_ok[i] ? n : 0) * K;
    }
  }

  __device__ __forceinline__ void load(int stage, int kt) const {
    const int k = kt * BK + chunk * 16;
    if constexpr (VEC == 16)
      load16(stage, k);
    else
      load4(stage, k);
  }

  __device__ __forceinline__ void load16(int stage, int k) const {
    const bool in_k = k < K;
    int ky = 0, kx = 0, c = k;
    if (!POINTWISE && in_k) {
      ky = k / run;
      const int rem = k - ky * run;
      kx = rem / p.Cin;
      c = rem - kx * p.Cin;
    }
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int r = lrow + i * kRowsPerPass;
      const uint32_t dst = a_s + stage * BM * BK + swz<BK>(r, chunk);
      if (POINTWISE) {
        const bool ok = a_ok[i] && in_k;
        cp_async16(dst, ok ? a_ptr[i] + k : p.x, ok ? 16 : 0);
      } else {
        const int iy = a_iy[i] + ky * p.dh, ix = a_ix[i] + kx * p.dw;
        if (!a_ok[i] || !in_k)
          cp_async16(dst, p.x, 0);
        else if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
          cp_async16(dst, a_ptr[i] + (static_cast<long long>(iy) * p.W + ix) * p.Cin + c, 16);
        else
          st_shared_word4(dst, pad4);
      }
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int r = lrow + i * kRowsPerPass;
      if (r >= BN) break;
      const uint32_t dst = b_s + stage * BN * BK + swz<BK>(r, chunk);
      const bool ok = b_ok[i] && in_k;
      cp_async16(dst, ok ? static_cast<const void*>(b_ptr[i] + k) : p.w, ok ? 16 : 0);
    }
  }

  // The chunk as four words k + 4j, each with its own tap (ky, kx, c).
  __device__ __forceinline__ void load4(int stage, int k) const {
    int ky[4], kx[4], c[4];
    bool in_k[4];
    int y = 0, x = 0, cc = k;
    if (!POINTWISE && k < K) {
      y = k / run;
      const int rem = k - y * run;
      x = rem / p.Cin;
      cc = rem - x * p.Cin;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in_k[j] = k + 4 * j < K;
      ky[j] = y, kx[j] = x, c[j] = cc;
      cc += 4;
      if (!POINTWISE && cc == p.Cin) {
        cc = 0;
        if (++x == p.kw) x = 0, ++y;
      }
    }
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int r = lrow + i * kRowsPerPass;
      const uint32_t dst = a_s + stage * BM * BK + swz<BK>(r, chunk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (POINTWISE) {
          const bool ok = a_ok[i] && in_k[j];
          cp_async4(dst + 4 * j, ok ? a_ptr[i] + k + 4 * j : p.x, ok ? 4 : 0);
          continue;
        }
        const int iy = a_iy[i] + ky[j] * p.dh, ix = a_ix[i] + kx[j] * p.dw;
        if (!a_ok[i] || !in_k[j])
          cp_async4(dst + 4 * j, p.x, 0);
        else if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
          cp_async4(dst + 4 * j,
                    a_ptr[i] + (static_cast<long long>(iy) * p.W + ix) * p.Cin + c[j], 4);
        else
          st_shared_word(dst + 4 * j, pad4);
      }
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int r = lrow + i * kRowsPerPass;
      if (r >= BN) break;
      const uint32_t dst = b_s + stage * BN * BK + swz<BK>(r, chunk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = b_ok[i] && in_k[j];
        cp_async4(dst + 4 * j, ok ? static_cast<const void*>(b_ptr[i] + k + 4 * j) : p.w,
                  ok ? 4 : 0);
      }
    }
  }
};

// The mma.sync m16n8k32 A fragment of rows r0 .. r0 + 15 and k32 slice ks
// of an A stage, as int8.
template <int BK>
__device__ __forceinline__ void load_a(uint32_t (&af)[4], uint32_t a_st, int r0, int ks, int lane,
                                       uint32_t flip) {
  ldmatrix_x4(af, a_st + swz<BK>(r0 + (lane & 15), ks * 2 + (lane >> 4)));
  if (flip) {
#pragma unroll
    for (int e = 0; e < 4; ++e) af[e] ^= flip;
  }
}

// The tile's epilogue.  Accumulator (mi, ni, 2h + e) of warp (wm, wn) is
// row wm*WM + mi*16 + g + 8h, column wn*WN + ni*8 + 2*t4 + e: add cb and the
// weight-zero-point term, requantize, stage the bytes in shared memory and
// write them as 16-byte rows (bytes at a ragged N), or write the int32
// sums.  The caller has finished with the ring (smem is reused).
template <int BM, int BN, int WM, int WN, int MI, int NI, int kThreads>
__device__ __forceinline__ void gemm_epilogue(const Conv& p, int (&acc)[MI][NI][4], uint8_t* smem,
                                              long long m0, int n0, int wm, int wn, int tid) {
  const long long M = static_cast<long long>(p.B) * p.OH * p.OW;
  const int N = p.O;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  if (p.out_kind == kOutInt32) {
    int* out = static_cast<int*>(p.out);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * WM + mi * 16 + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * WN + ni * 8 + 2 * t4 + e;
            if (n < N) out[m * N + n] = fused_sum(p, acc[mi][ni][2 * h + e], n, m);
          }
      }
    return;
  }

  constexpr int CS = BN + 16;  // staging row stride: 16-byte rows, rotated banks
  uint8_t* cs = smem;
  const float zpf = static_cast<float>(p.zp);
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  int cbv[NI][2], wzv[NI][2];
  float mv[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * WN + ni * 8 + 2 * t4 + e;
      const bool ok = n < N;
      cbv[ni][e] = ok && p.cb ? __ldg(p.cb + n) : 0;
      wzv[ni][e] = ok && p.wz ? __ldg(p.wz + n) : 0;
      mv[ni][e] = ok ? __ldg(p.mult + n) : 0.0f;
    }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * WM + mi * 16 + g + 8 * h;
      const long long m = m0 + r;
      const int sx = p.wz && m < M ? __ldg(p.sum_x + m) : 0;  // groups == 1
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        int q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = wrap_sub(wrap_add(acc[mi][ni][2 * h + e], cbv[ni][e]),
                                 wrap_mul(wzv[ni][e], sx));
          q[e] = requant(v, mv[ni][e], zpf, lo, hi);
        }
        *reinterpret_cast<uint16_t*>(cs + r * CS + wn * WN + ni * 8 + 2 * t4) =
            static_cast<uint16_t>((q[0] & 0xFF) | ((q[1] & 0xFF) << 8));
      }
    }
  __syncthreads();
  uint8_t* out = static_cast<uint8_t*>(p.out);
  if ((N & 15) == 0 && n0 + BN <= N) {
    constexpr int kOutChunks = BN / 16;
    for (int c = tid; c < BM * kOutChunks; c += kThreads) {
      const int r = c / kOutChunks, cc = c % kOutChunks;
      const long long m = m0 + r;
      if (m < M)
        *reinterpret_cast<uint4*>(out + m * N + n0 + cc * 16) =
            *reinterpret_cast<const uint4*>(cs + r * CS + cc * 16);
    }
  } else {
    for (int c = tid; c < BM * BN; c += kThreads) {
      const int r = c / BN, col = c % BN;
      const long long m = m0 + r;
      const int n = n0 + col;
      if (m < M && n < N) out[m * N + n] = cs[r * CS + col];
    }
  }
}

// mma.sync: warps WARPS_M x WARPS_N, each a (BM / WARPS_M) x (BN / WARPS_N)
// tile of m16n8k32 products.  BK: bytes of K a stage (64 or 128); VEC: bytes
// a copy (TileLoader).
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, bool POINTWISE, int VEC>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32) int8_conv_gemm(Conv p) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(NI % 2 == 0, "tile");
  static_assert(BK == 64 || BK == 128, "stage depth");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t a_s = smem_u32(smem);
  const uint32_t b_s = a_s + STAGES * BM * BK;
  const int KT = (p.kh * p.kw * p.Cin + BK - 1) / BK;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const TileLoader<BM, BN, BK, kThreads, POINTWISE, VEC> loader(p, a_s, b_s, m0, n0, tid);

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) loader.load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) loader.load(nk % STAGES, nk);
    cp_async_commit();
    const int stage = kt % STAGES;
    const uint32_t a_st = a_s + stage * BM * BK, b_st = b_s + stage * BN * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) load_a<BK>(af[mi], a_st, wm * WM + mi * 16, ks, lane, p.flip);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        const int mat = lane >> 3;
        const int r = wn * WN + (2 * nj + (mat >> 1)) * 8 + (lane & 7);
        uint32_t t[4];
        ldmatrix_x4(t, b_st + swz<BK>(r, ks * 2 + (mat & 1)));
        bf[2 * nj][0] = t[0];
        bf[2 * nj][1] = t[1];
        bf[2 * nj + 1][0] = t[2];
        bf[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  gemm_epilogue<BM, BN, WM, WN, MI, NI, kThreads>(p, acc, smem, m0, n0, wm, wn, tid);
}

// ---------------------------------------------------------------------------
// depthwise 3x3: four channels of one pixel a thread
// ---------------------------------------------------------------------------

constexpr int kDwPX = 4;  // output pixels a thread, along x

// One tap word of each of four channels -> per channel, the four taps in
// one word (a 4x4 byte transpose): out[j] = {a.bj, b.bj, c.bj, d.bj}.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);
  const uint32_t t2 = __byte_perm(c, d, 0x5140), t3 = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// SW: the column stride (1 or 2); the column dilation is 1.
template <int SW>
__global__ void __launch_bounds__(256) int8_conv_depthwise3x3(Conv p) {
  constexpr int NC = (kDwPX - 1) * SW + 3;  // input columns of kDwPX outputs
  const int Q = p.O >> 2;
  const int OWG = (p.OW + kDwPX - 1) / kDwPX;
  const unsigned total = static_cast<unsigned>(p.B * p.OH) * OWG * Q;
  const unsigned lin = blockIdx.x * 256u + threadIdx.x;
  if (lin >= total) return;
  const int q = lin % Q;
  unsigned t = lin / Q;
  const int ox0 = (t % OWG) * kDwPX;
  t /= OWG;
  const int row = t;  // b * OH + oy
  const int oy = row % p.OH, b = row / p.OH;

  // channel 4q + j's nine taps are bytes 9j .. 9j + 8 of these 36
  const uint32_t* wq = reinterpret_cast<const uint32_t*>(p.w) + 9 * q;
  uint32_t wr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) wr[i] = __ldg(wq + i);
  const uint32_t w03[4] = {wr[0], __funnelshift_r(wr[2], wr[3], 8),
                           __funnelshift_r(wr[4], wr[5], 16), __funnelshift_r(wr[6], wr[7], 24)};
  const uint32_t w47[4] = {wr[1], __funnelshift_r(wr[3], wr[4], 8),
                           __funnelshift_r(wr[5], wr[6], 16), __funnelshift_r(wr[7], wr[8], 24)};
  const uint32_t w8[4] = {wr[2] & 0xFFu, wr[4] & 0xFF00u, wr[6] & 0xFF0000u,
                          wr[8] & 0xFF000000u};

  // the three input rows' NC columns, four channels a word
  const int iy0 = oy * p.sh - p.pt, ix0 = ox0 * SW - p.pl;
  const uint32_t pad4 = static_cast<uint32_t>(p.pad8 & 0xFF) * 0x01010101u;
  const uint32_t* xb =
      reinterpret_cast<const uint32_t*>(p.x + static_cast<long long>(b) * p.H * p.W * p.O) + q;
  uint32_t X[3][NC];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = iy0 + ky * p.dh;
    const bool row_in = iy >= 0 && iy < p.H;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ix = ix0 + c;
      X[ky][c] = row_in && ix >= 0 && ix < p.W
                     ? __ldg(xb + (static_cast<long long>(iy) * p.W + ix) * Q) ^ p.flip
                     : pad4;
    }
  }

  const int o0 = 4 * q;
  int cbv[4] = {0, 0, 0, 0}, wzv[4] = {0, 0, 0, 0};
  if (p.cb) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(p.cb + o0));
    cbv[0] = c.x, cbv[1] = c.y, cbv[2] = c.z, cbv[3] = c.w;
  }
  if (p.wz) {
    const int4 z = __ldg(reinterpret_cast<const int4*>(p.wz + o0));
    wzv[0] = z.x, wzv[1] = z.y, wzv[2] = z.z, wzv[3] = z.w;
  }
  float4 mu = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.out_kind != kOutInt32) mu = __ldg(reinterpret_cast<const float4*>(p.mult + o0));
  const float zpf = static_cast<float>(p.zp);
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
#pragma unroll
  for (int j = 0; j < kDwPX; ++j) {
    if (ox0 + j >= p.OW) break;
    const int c = j * SW;
    uint32_t c03[4], c47[4];
    transpose4(X[0][c], X[0][c + 1], X[0][c + 2], X[1][c], c03);
    transpose4(X[1][c + 1], X[1][c + 2], X[2][c], X[2][c + 1], c47);
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __dp4a(static_cast<int>(c03[e]), static_cast<int>(w03[e]), cbv[e]);
      v[e] = __dp4a(static_cast<int>(c47[e]), static_cast<int>(w47[e]), v[e]);
      v[e] = __dp4a(static_cast<int>(X[2][c + 2]), static_cast<int>(w8[e]), v[e]);
    }
    const long long m = static_cast<long long>(row) * p.OW + ox0 + j;
    if (p.wz) {  // groups == O: sum_x has O channels
      const int4 s = __ldg(reinterpret_cast<const int4*>(p.sum_x + m * p.O + o0));
      v[0] = wrap_sub(v[0], wrap_mul(wzv[0], s.x));
      v[1] = wrap_sub(v[1], wrap_mul(wzv[1], s.y));
      v[2] = wrap_sub(v[2], wrap_mul(wzv[2], s.z));
      v[3] = wrap_sub(v[3], wrap_mul(wzv[3], s.w));
    }
    if (p.out_kind == kOutInt32) {
      *reinterpret_cast<int4*>(static_cast<int*>(p.out) + m * p.O + o0) =
          make_int4(v[0], v[1], v[2], v[3]);
      continue;
    }
    *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(p.out) + m * p.O + o0) =
        (requant(v[0], mu.x, zpf, lo, hi) & 0xFF) |
        ((requant(v[1], mu.y, zpf, lo, hi) & 0xFF) << 8) |
        ((requant(v[2], mu.z, zpf, lo, hi) & 0xFF) << 16) |
        (static_cast<uint32_t>(requant(v[3], mu.w, zpf, lo, hi) & 0xFF) << 24);
  }
}

// ---------------------------------------------------------------------------
// dense: few input channels (the first conv), eight output channels a thread
// ---------------------------------------------------------------------------

constexpr int kDenseMaxO = 64;
constexpr int kDenseKH = 3;
constexpr int kDenseRW = 3;   // words a window row: kw * Cin <= 12 bytes
constexpr int kDenseWO = 12;  // words an output channel's weights take in shared memory

__global__ void __launch_bounds__(256) int8_conv_dense(Conv p) {
  constexpr int KH = kDenseKH, RW = kDenseRW;
  // [o][ky * RW + j], zero past kw * Cin and past KH * RW: three 16-byte reads
  // a channel, the same address across the warp
  __shared__ __align__(16) uint32_t ws[kDenseMaxO * kDenseWO];
  __shared__ int cb_s[kDenseMaxO], wz_s[kDenseMaxO];
  __shared__ float mult_s[kDenseMaxO];
  const int L = p.kw * p.Cin;
  uint8_t* wsb = reinterpret_cast<uint8_t*>(ws);
  for (int i = threadIdx.x; i < p.O * kDenseWO * 4; i += blockDim.x) {
    const int o = i / (kDenseWO * 4), rest = i % (kDenseWO * 4);
    const int ky = rest / (RW * 4), byte = rest % (RW * 4);
    wsb[i] = ky < KH && byte < L
                 ? static_cast<uint8_t>(p.w[(static_cast<long long>(o) * KH + ky) * L + byte])
                 : 0;
  }
  for (int o = threadIdx.x; o < p.O; o += blockDim.x) {
    cb_s[o] = p.cb ? p.cb[o] : 0;
    wz_s[o] = p.wz ? p.wz[o] : 0;
    mult_s[o] = p.mult ? p.mult[o] : 0.0f;
  }
  __syncthreads();

  const uint32_t pad_raw = static_cast<uint32_t>((p.pad8 ^ p.flip) & 0xFF);
  const unsigned M = static_cast<unsigned>(p.B) * p.OH * p.OW;  // < 2^31 (the launcher)
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(p.x);
  const float zpf = static_cast<float>(p.zp);
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  for (unsigned m = blockIdx.x * blockDim.x + threadIdx.x; m < M; m += gridDim.x * blockDim.x) {
    const int ox = m % p.OW;
    const unsigned t = m / p.OW;
    const int oy = t % p.OH;
    const int b = t / p.OH;
    const int iy0 = oy * p.sh - p.pt, ix0 = ox * p.sw - p.pl;
    const bool cols_in = ix0 >= 0 && ix0 + p.kw - 1 < p.W;
    uint32_t R[KH * RW];
#pragma unroll
    for (int ky = 0; ky < KH; ++ky) {
      const int iy = iy0 + ky * p.dh;
      const bool row_in = iy >= 0 && iy < p.H;
      if (cols_in && row_in) {
        // the row's L bytes from aligned words, no word past its last byte
        const long long off = ((static_cast<long long>(b) * p.H + iy) * p.W + ix0) * p.Cin;
        const long long w0 = off >> 2, wl = (off + L - 1) >> 2;
        const int shift = static_cast<int>(off & 3) * 8;
        uint32_t lw[RW + 1];
#pragma unroll
        for (int i = 0; i <= RW; ++i) lw[i] = w0 + i <= wl ? __ldg(xw + w0 + i) : 0u;
#pragma unroll
        for (int j = 0; j < RW; ++j)
          R[ky * RW + j] = __funnelshift_r(lw[j], lw[j + 1], shift) ^ p.flip;
      } else {
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          uint32_t word = 0;
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            if (i >= L) break;
            const int kx = i / p.Cin, c = i - kx * p.Cin, ix = ix0 + kx;
            const uint32_t byte =
                row_in && ix >= 0 && ix < p.W
                    ? p.x[((static_cast<long long>(b) * p.H + iy) * p.W + ix) * p.Cin + c]
                    : pad_raw;
            word |= byte << (8 * e);
          }
          R[ky * RW + j] = word ^ p.flip;
        }
      }
    }
    const int sx = p.wz ? __ldg(p.sum_x + m) : 0;  // groups == 1
    uint32_t packed[kDenseMaxO / 4];
    int sums[4];
#pragma unroll
    for (int o = 0; o < kDenseMaxO; ++o) {
      if (o >= p.O) break;
      const uint4* wo = reinterpret_cast<const uint4*>(ws + o * kDenseWO);
      const uint4 a = wo[0], c = wo[1], d = wo[2];
      const uint32_t wv[9] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, d.x};
      int v = wrap_sub(cb_s[o], wrap_mul(wz_s[o], sx));
#pragma unroll
      for (int j = 0; j < KH * RW; ++j)
        v = __dp4a(static_cast<int>(R[j]), static_cast<int>(wv[j]), v);
      if (p.out_kind == kOutInt32) {  // four sums a 16-byte store
        sums[o % 4] = v;
        if (o % 4 == 3)
          *reinterpret_cast<int4*>(static_cast<int*>(p.out) + static_cast<long long>(m) * p.O +
                                   o - 3) = make_int4(sums[0], sums[1], sums[2], sums[3]);
        continue;
      }
      const uint32_t q = static_cast<uint32_t>(requant(v, mult_s[o], zpf, lo, hi) & 0xFF);
      packed[o / 4] = (o % 4 ? packed[o / 4] : 0u) | q << (8 * (o % 4));
    }
    if (p.out_kind == kOutInt32) continue;
    uint8_t* out = static_cast<uint8_t*>(p.out) + static_cast<long long>(m) * p.O;
#pragma unroll
    for (int o = 0; o < kDenseMaxO; o += 8) {
      if (o >= p.O) break;
      *reinterpret_cast<uint2*>(out + o) = make_uint2(packed[o / 4], packed[o / 4 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// direct: one thread an output, any geometry
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) int8_conv_direct(Conv p) {
  const long long M = static_cast<long long>(p.B) * p.OH * p.OW;
  const long long total = M * p.O;
  const int cg = p.Cin / p.groups, og = p.O / p.groups;
  const int flipb = static_cast<int>(p.flip & 0xFF);
  const float zpf = static_cast<float>(p.zp);
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  for (long long idx = blockIdx.x * 256LL + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * 256) {
    const int o = static_cast<int>(idx % p.O);
    const long long m = idx / p.O;
    const int ox = static_cast<int>(m % p.OW);
    const long long t = m / p.OW;
    const int oy = static_cast<int>(t % p.OH);
    const int b = static_cast<int>(t / p.OH);
    const uint8_t* xb = p.x + static_cast<long long>(b) * p.H * p.W * p.Cin + (o / og) * cg;
    const int8_t* wo = p.w + static_cast<long long>(o) * p.kh * p.kw * cg;
    int acc = 0;
    for (int ky = 0; ky < p.kh; ++ky) {
      const int iy = oy * p.sh - p.pt + ky * p.dh;
      for (int kx = 0; kx < p.kw; ++kx) {
        const int ix = ox * p.sw - p.pl + kx * p.dw;
        const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
        const uint8_t* xp = xb + (static_cast<long long>(iy) * p.W + ix) * p.Cin;
        const int8_t* wp = wo + (ky * p.kw + kx) * cg;
        for (int c = 0; c < cg; ++c) {
          const int xv = in ? static_cast<int>(static_cast<int8_t>(xp[c] ^ flipb)) : p.pad8;
          acc = wrap_add(acc, xv * static_cast<int>(wp[c]));
        }
      }
    }
    const int v = fused_sum(p, acc, o, m);
    if (p.out_kind == kOutInt32)
      static_cast<int*>(p.out)[idx] = v;
    else
      static_cast<uint8_t*>(p.out)[idx] =
          static_cast<uint8_t>(requant(v, __ldg(p.mult + o), zpf, lo, hi) & 0xFF);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, int VEC>
int launch_gemm(const Conv& p, bool pointwise, cudaStream_t s) {
  const long long M = static_cast<long long>(p.B) * p.OH * p.OW;
  const long long m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (p.O + BN - 1) / BN;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535) return kErrShape;
  constexpr int kSmem = gemm_smem<BM, BN, BK, STAGES>();
  auto kern = pointwise ? int8_conv_gemm<BM, BN, BK, WARPS_M, WARPS_N, STAGES, true, VEC>
                        : int8_conv_gemm<BM, BN, BK, WARPS_M, WARPS_N, STAGES, false, VEC>;
  // The dynamic shared memory limit is an attribute of the kernel on one
  // device: a bit per device ordinal records where it was raised (the first
  // launch there, before any capture).  Two threads racing both set it,
  // which is harmless; an ordinal past 63 sets it at every launch.
  static std::atomic<unsigned long long> sized[2];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(sized[pointwise].load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[pointwise].fetch_or(bit, std::memory_order_release);
  }
  kern<<<dim3(static_cast<unsigned>(m_tiles), n_tiles), WARPS_M * WARPS_N * 32, kSmem, s>>>(p);
  return 0;
}

int launch(const Conv& p, int route, cudaStream_t s) {
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || p.Cin <= 0 || p.O <= 0 || p.kh <= 0 || p.kw <= 0 ||
      p.sh <= 0 || p.sw <= 0 || p.dh <= 0 || p.dw <= 0 || p.groups <= 0 || p.OH <= 0 ||
      p.OW <= 0 || p.pt < 0 || p.pl < 0 || p.Cin % p.groups || p.O % p.groups ||
      p.out_kind < kOutInt32 || p.out_kind > kOutUint8 ||
      (p.out_kind != kOutInt32 && !p.mult) || (p.wz && !p.sum_x))
    return kErrShape;
  const long long M = static_cast<long long>(p.B) * p.OH * p.OW;
  const bool all_aligned = aligned16(p.x) && aligned16(p.w) && aligned16(p.out) &&
                           aligned16(p.cb) && aligned16(p.mult) && aligned16(p.wz) &&
                           aligned16(p.sum_x);
  int rc = 0;
  if (route == kGemm) {
    if (p.groups != 1 || p.Cin % 4) return kErrRoute;
    if (!all_aligned) return kErrAlign;
    const bool pointwise = p.kh == 1 && p.kw == 1 && p.sh == 1 && p.sw == 1 && p.pt == 0 &&
                           p.pl == 0 && p.OH == p.H && p.OW == p.W;
    // tiles by shape, from a sweep of twelve on the H100 (PERF.md)
    if (p.Cin % 16)  // channels in fours: 4-byte copies, tiles 48 wide but where N <= 64 is not 48k
      rc = p.O <= 64 && p.O % 48 ? launch_gemm<128, 64, 64, 2, 2, 4, 4>(p, pointwise, s)
                                 : launch_gemm<128, 48, 64, 4, 1, 3, 4>(p, pointwise, s);
    else if (p.O <= 64)
      rc = launch_gemm<128, 64, 64, 2, 2, 4, 16>(p, pointwise, s);
    else if (M <= 1024)  // an FC: narrow tiles, so that more SMs stream its weights
      rc = launch_gemm<64, 16, 128, 4, 1, 6, 16>(p, pointwise, s);
    else if (M <= 4096)  // few rows: smaller tiles fill the SMs
      rc = launch_gemm<64, 128, 64, 2, 2, 4, 16>(p, pointwise, s);
    else
      rc = launch_gemm<128, 128, 64, 4, 2, 4, 16>(p, pointwise, s);
  } else if (route == kDepthwise) {
    if (p.groups != p.Cin || p.O != p.Cin || p.kh != 3 || p.kw != 3 || p.Cin % 4 ||
        p.dw != 1 || (p.sw != 1 && p.sw != 2))
      return kErrRoute;
    if (!all_aligned) return kErrAlign;
    const long long total = static_cast<long long>(p.B) * p.OH *
                            ((p.OW + kDwPX - 1) / kDwPX) * (p.O / 4);
    if (total > 0xffff0000LL) return kErrShape;
    const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
    if (p.sw == 1)
      int8_conv_depthwise3x3<1><<<blocks, 256, 0, s>>>(p);
    else
      int8_conv_depthwise3x3<2><<<blocks, 256, 0, s>>>(p);
  } else if (route == kDense) {
    if (p.groups != 1 || p.kh != kDenseKH || p.kw * p.Cin > 4 * kDenseRW || p.dw != 1 ||
        p.O % 8 || p.O > kDenseMaxO)
      return kErrRoute;
    if (!all_aligned) return kErrAlign;
    if (M >= 0x7fffffffLL) return kErrShape;
    long long blocks = (M + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    int8_conv_dense<<<static_cast<unsigned>(blocks), 256, 0, s>>>(p);
  } else if (route == kDirect) {
    long long blocks = (M * p.O + 255) / 256;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    int8_conv_direct<<<static_cast<unsigned>(blocks), 256, 0, s>>>(p);
  } else {
    return kErrRoute;
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One integer conv layer, requantized: x [B, H, W, Cin] uint8 (x_unsigned)
// or int8, unpadded; pads pt (top) and pl (left), the bottom and right pads
// implied by OH and OW; out [B, OH, OW, O] int8 (out_kind 1), uint8 (2) or
// the int32 sum (0).  cb, wz and sum_x may be null; mult may be null for an
// int32 output.  route: 0 direct, 1 gemm, 2 depthwise, 3 dense.  Returns
// cudaGetLastError() after the launch, or an error of this file's own for
// a shape, route or alignment it does not take.
extern "C" int nns_int8_conv_requant(const void* x, const void* w, void* out, const void* cb,
                                     const void* mult, const void* wz, const void* sum_x,
                                     int B, int H, int W, int Cin, int O, int kh, int kw,
                                     int sh, int sw, int dh, int dw, int groups, int OH, int OW,
                                     int pt, int pl, int x_unsigned, int pad8, int out_kind,
                                     int zp, int lo, int hi, int route, void* stream) {
  Conv p{static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w), out,
         static_cast<const int*>(cb), static_cast<const float*>(mult),
         static_cast<const int*>(wz), static_cast<const int*>(sum_x),
         B, H, W, Cin, O, kh, kw, sh, sw, dh, dw, groups, OH, OW, pt, pl,
         x_unsigned ? 0x80808080u : 0u, pad8, out_kind, zp, lo, hi};
  if (pad8 < -128 || pad8 > 127) return kErrShape;
  return launch(p, route, static_cast<cudaStream_t>(stream));
}

extern "C" const char* nns_error_string(int err) {
  if (err == kErrShape) return "the int8 conv kernel does not take this geometry";
  if (err == kErrRoute) return "the int8 conv route does not take this input";
  if (err == kErrAlign) return "the int8 conv kernel wants 16-byte aligned tensors";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
