// Q1: the int8 convolution of a quantized ConvBN (yolov5-face int8).
//
// Replaces no Pallas kernel: the JAX package's quantized ConvBN
// (models/layers.py:80-106) convolves its int8 codes with
// lax.conv_general_dilated(int8, int8, preferred_element_type=int32),
// which XLA lowers itself. PyTorch has no int8 x int8 -> int32 convolution
// on CUDA, and an f32 convolution of the codes is not exact (a 3x3 layer
// over 256 channels sums up to 2304 * 127^2 > 2^24), so the port carries
// its own. The function is that of ops/int8_conv.conv_int8_plain:
//
//   s    = max(absmax(x), 1e-6) * f32(1/127)  (dynamic) or ascale (static)
//   xq   = clamp(rint(x / s), -127, 127)                      int8 codes
//   acc  = sum over taps and channels of xq * w                int32, exact
//   pre  = fma(float(acc), s * wscale[co], bias[co])           one rounding
//   out  = pre * (1 / (1 + expf(-pre))) (SiLU, JAX's form) or pre
//
// Three launches on the caller's stream, no host sync between them:
//   (a) absmax_kernel: a partial absmax per block (dynamic mode only);
//   (b) quantize_kernel: every block reduces the partials to s (block 0
//       stores it for (c)), then writes the codes, four to a thread;
//   (c) conv_gemm_kernel (groups == 1): an implicit GEMM, M = output pixels,
//       N = C_out, K = k * k * C_in; 64 x 64 output tiles, K in steps of 32
//       codes staged in shared memory as 4-code words, 16 outputs a thread
//       accumulated with __dp4a. Where C_in % 4 == 0 a word is 4 channels
//       of one tap, read as one 32-bit load; otherwise (the stem's C_in =
//       3) the loader packs each code on its own with its own bounds test.
//       Zero padding reads code 0, as in JAX. Or conv_dw_kernel (groups ==
//       C_in == C_out, the ShuffleV2 depthwise layers): one output a
//       thread, channels adjacent, scalar int products over the k x k taps.
//       Both finish with the fused epilogue: dequantize + bias (one fmaf),
//       then SiLU or none.
//
// What bounds it on an H100: the codes' operations are few (2 * M * N * K
// int8 ops over 1979 TOPS), and x (f32, read twice), the codes and the f32
// output move through device memory, so it is bound by bytes at these
// widths. This first version is simple and right: dp4a on the CUDA cores,
// not the tensor cores (mma.sync s8 / wgmma), and the quantize pass is not
// fused into the convolution's loads.
//
// The epilogue is written with explicit roundings (__fmul_rn, __fmaf_rn,
// __fdiv_rn, __frcp_rn, __float2int_rn) so that nvcc's FMA contraction
// cannot change a value: the pre-activation equals the plain version bit
// for bit, and SiLU differs from it only where expf differs from PyTorch's
// exp on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;           // output pixels of a tile
constexpr int kBN = 64;           // output channels of a tile
constexpr int kBKW = 8;           // 4-code words of K a step (32 codes)
constexpr float kRecip127 = 1.0f / 127.0f;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kThreads / 32) ? red[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;  // every thread of the block holds the maximum
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long n,
              float* __restrict__ partial) {
  __shared__ float red[kThreads / 32];
  float m = 0.0f;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    m = fmaxf(m, fabsf(x[i]));
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__device__ __forceinline__ int code(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(127, max(-127, q));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ partial, int nparts,
                const float* __restrict__ ascale, float* __restrict__ s_out,
                int8_t* __restrict__ xq) {
  __shared__ float red[kThreads / 32];
  float s;
  if (ascale != nullptr) {
    s = *ascale;
  } else {
    float m = 0.0f;
    for (int i = threadIdx.x; i < nparts; i += kThreads)
      m = fmaxf(m, partial[i]);
    m = block_max(m, red);
    s = __fmul_rn(fmaxf(m, 1e-6f), kRecip127);
    if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  }
  const long long n4 = n / 4;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const float* p = x + 4 * i;
    const int q0 = code(p[0], s), q1 = code(p[1], s), q2 = code(p[2], s),
              q3 = code(p[3], s);
    reinterpret_cast<char4*>(xq)[i] =
        make_char4((char)q0, (char)q1, (char)q2, (char)q3);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4)
    xq[4 * n4 + threadIdx.x] = (int8_t)code(x[4 * n4 + threadIdx.x], s);
}

__device__ __forceinline__ float epilogue(int acc, float s, float ws,
                                          float b, int act) {
  const float pre = __fmaf_rn(__int2float_rn(acc), __fmul_rn(s, ws), b);
  return act ? __fmul_rn(pre, __frcp_rn(__fadd_rn(1.0f, expf(-pre)))) : pre;
}

// implicit GEMM for groups == 1; VEC: C % 4 == 0 (a word = 4 channels of
// one tap, one aligned 32-bit load)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                 const float* __restrict__ wscale,
                 const float* __restrict__ bias,
                 const float* __restrict__ s_ptr, float* __restrict__ out,
                 int B, int H, int W, int C, int Cout, int k, int stride,
                 int pad, int Ho, int Wo, int act) {
  __shared__ int As[kBKW][kBM + 1];
  __shared__ int Bs[kBKW][kBN + 1];
  const int M = B * Ho * Wo;
  const int K = k * k * C;
  const int KW = (K + 3) / 4;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tx = tid % 16, ty = tid / 16;

  // each thread loads 2 words of A and of B a step: row = idx / 8, word
  // idx % 8 of the step
  int a_base[2], a_iy0[2], a_ix0[2];
  bool a_ok[2];
  for (int r = 0; r < 2; ++r) {
    const int row = (tid + kThreads * r) >> 3;
    const int m = m0 + row;
    a_ok[r] = m < M;
    const int mm = a_ok[r] ? m : 0;
    const int ox = mm % Wo, oy = (mm / Wo) % Ho, b = mm / (Wo * Ho);
    a_base[r] = b * H;
    a_iy0[r] = oy * stride - pad;
    a_ix0[r] = ox * stride - pad;
  }

  int acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kw0 = 0; kw0 < KW; kw0 += kBKW) {
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + kThreads * r;
      const int row = idx >> 3, kk = idx & 7;
      const int word = kw0 + kk;
      int va = 0;
      if (a_ok[r] && word < KW) {
        if (VEC) {
          const int kb = word * 4;
          const int tap = kb / C, ci = kb - tap * C;
          const int ky = tap / k, kx = tap - ky * k;
          const int iy = a_iy0[r] + ky, ix = a_ix0[r] + kx;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            va = *reinterpret_cast<const int*>(
                xq + ((size_t)(a_base[r] + iy) * W + ix) * C + ci);
        } else {
          for (int j = 0; j < 4; ++j) {
            const int kb = word * 4 + j;
            if (kb >= K) break;
            const int tap = kb / C, ci = kb - tap * C;
            const int ky = tap / k, kx = tap - ky * k;
            const int iy = a_iy0[r] + ky, ix = a_ix0[r] + kx;
            if (iy >= 0 && iy < H && ix >= 0 && ix < W)
              va |= (int)(uint8_t)xq[((size_t)(a_base[r] + iy) * W + ix) * C +
                                     ci]
                    << (8 * j);
          }
        }
      }
      As[kk][row] = va;
      const int n = n0 + row;
      int vb = 0;
      if (n < Cout && word < KW) {
        if (VEC) {
          vb = *reinterpret_cast<const int*>(w + (size_t)n * K + word * 4);
        } else {
          for (int j = 0; j < 4; ++j) {
            const int kb = word * 4 + j;
            if (kb >= K) break;
            vb |= (int)(uint8_t)w[(size_t)n * K + kb] << (8 * j);
          }
        }
      }
      Bs[kk][row] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s = *s_ptr;
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= Cout) continue;
    const float ws = wscale[n], bn = bias[n];
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M) out[(size_t)m * Cout + n] = epilogue(acc[i][j], s, ws, bn,
                                                      act);
    }
  }
}

// depthwise: groups == C == Cout, weights [C, k, k, 1]
__global__ void __launch_bounds__(kThreads)
conv_dw_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
               const float* __restrict__ wscale,
               const float* __restrict__ bias,
               const float* __restrict__ s_ptr, float* __restrict__ out,
               int B, int H, int W, int C, int k, int stride, int pad, int Ho,
               int Wo, int act) {
  const float s = *s_ptr;
  const long long total = (long long)B * Ho * Wo * C;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const int c = (int)(idx % C);
    long long p = idx / C;
    const int ox = (int)(p % Wo);
    p /= Wo;
    const int oy = (int)(p % Ho);
    const int b = (int)(p / Ho);
    int acc = 0;
    for (int ky = 0; ky < k; ++ky) {
      const int iy = oy * stride - pad + ky;
      if (iy < 0 || iy >= H) continue;
      for (int kx = 0; kx < k; ++kx) {
        const int ix = ox * stride - pad + kx;
        if (ix < 0 || ix >= W) continue;
        acc += (int)xq[((size_t)(b * H + iy) * W + ix) * C + c] *
               (int)w[(c * k + ky) * k + kx];
      }
    }
    out[idx] = epilogue(acc, s, wscale[c], bias[c], act);
  }
}

}  // namespace

// x: [B, H, W, C] f32 NHWC; w: [Cout, k, k, C / groups] int8; ascale:
// device scalar or null (dynamic: partial [nparts] and s_out [1] scratch);
// xq: [B, H, W, C] int8 scratch; out: [B, Ho, Wo, Cout] f32. groups is 1
// or C (== Cout). Returns cudaGetLastError() after the launches.
extern "C" int conv_int8_launch(const float* x, const int8_t* w,
                                const float* wscale, const float* bias,
                                const float* ascale, float* partial,
                                int nparts, float* s_out, int8_t* xq,
                                float* out, int B, int H, int W, int C,
                                int Cout, int k, int stride, int pad,
                                int groups, int Ho, int Wo, int act,
                                cudaStream_t stream) {
  const long long n = (long long)B * H * W * C;
  if (ascale == nullptr)
    absmax_kernel<<<nparts, kThreads, 0, stream>>>(x, n, partial);
  const long long n4 = (n + 3) / 4;
  const int qblocks =
      (int)(((n4 + kThreads - 1) / kThreads) < 4096
                ? (n4 + kThreads - 1) / kThreads
                : 4096);
  quantize_kernel<<<qblocks, kThreads, 0, stream>>>(x, n, partial, nparts,
                                                    ascale, s_out, xq);
  const float* s_ptr = ascale != nullptr ? ascale : s_out;
  if (groups == 1) {
    const dim3 grid((B * Ho * Wo + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
    if (C % 4 == 0)
      conv_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(
          xq, w, wscale, bias, s_ptr, out, B, H, W, C, Cout, k, stride, pad,
          Ho, Wo, act);
    else
      conv_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(
          xq, w, wscale, bias, s_ptr, out, B, H, W, C, Cout, k, stride, pad,
          Ho, Wo, act);
  } else {
    const long long total = (long long)B * Ho * Wo * C;
    const long long blocks = (total + kThreads - 1) / kThreads;
    conv_dw_kernel<<<(int)(blocks < 65536 ? blocks : 65536), kThreads, 0,
                     stream>>>(xq, w, wscale, bias, s_ptr, out, B, H, W, C,
                               k, stride, pad, Ho, Wo, act);
  }
  return (int)cudaGetLastError();
}
