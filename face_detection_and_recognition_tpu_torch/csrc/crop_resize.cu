// Crop + bilinear resize (half-pixel centres) of K boxes from each of B
// NHWC frames, all frames in one launch:
//   out[b, k, o, p, c] = bilinear sample of img[b] at the box's (o, p) grid
// with the two box semantics of the JAX package's ops/crop.py: clamp
// (crop_and_resize, the box is clipped to the frame and so are the samples)
// and pad (crop_and_resize_padded, MTCNN: taps outside the frame read 0).
// Invalid slots read nothing and sample 0. An optional epilogue then clips
// every value to [0, 255] and subtracts a per-channel mean, in that order:
// the engine's clamp and mean subtraction of its crops, fused into the
// store (invalid slots come out as clip(0) - mean = -mean).
//
// The output is f32, or bfloat16 for a bf16 engine's age/gender crops. The
// bf16 store rounds twice, as the JAX engine does: its crop is clipped and
// cast to bf16, and its classifier casts that back to f32 and subtracts the
// mean in f32, which the first convolution casts to bf16 again. So a bf16
// element is bf16_rn(f32(bf16_rn(clip(v))) - mean) (bf16_rn(clip(v))
// without a mean), each rounding to nearest even as PyTorch's f32 -> bf16
// conversion rounds (a NaN becomes 0x7FC0). Half the bytes of the f32 store
// for the ensemble's largest tensor; every step before the store is the
// f32 mode's.
//
// Replaces crop_gemm_pallas / _crop_kernel / _crop_kernel_windowed
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:237-501). The
// TPU has no fast gather, so that kernel built hat-weight matrices and ran
// two MXU GEMMs per channel (bf16-pass precision, ~0.4% of the pixel range);
// the windowed variant only cut the GEMMs to the image windows a box
// touches. A GPU gathers natively: this is a direct 4-tap sampler that
// computes exactly the JAX "gather" path (ops/crop.py:129-146, :187-208).
//
// Work split: one CTA per (row tile, box, frame); a tile's output is one
// contiguous span of rows * ow * C floats. The CTA first writes the column
// taps of all ow output columns and the row taps of its rows into shared
// memory, 16 bytes a tap pair. Then each thread walks down one output
// column over 8 rows (ow threads a group of 8 rows, so a tile of 227-wide
// crops is 8 rows). Bilinear sampling is separable, and the source rows of
// consecutive output rows only move down, so the thread keeps the
// horizontal sums (a * (1 - wx) + b * wx) of the current pair of source
// rows in registers and samples a source row once however many output
// rows share it: a 227-row crop of a 100-row box reads each source row
// for about two output rows, which halves the sampling against a sampler
// that takes every pixel's four taps anew. The vertical sum and the
// epilogue go into a staging copy of the span in shared memory (lanes on
// consecutive columns, stride C words: conflict-free for C = 3). Last, the
// CTA stores the span with 16-byte stores: the staging copy is shifted by
// the span's offset within its 16-byte line, so that every aligned piece
// of the output is an aligned piece of the copy, and only the unaligned
// head and tail (at most 3 floats each) are scalar. A 227 x 227 x 3 f32
// slot is 12 mod 16 bytes long, so most spans have both.
//
// Loads: for uint8 frames with C = 3 (the engine's), the two column taps
// of a row lie in 6 bytes, read as the 2 or 3 aligned 32-bit words that
// hold them (each word holds one of the 6 bytes, so no read leaves the
// frame) instead of 6 single-byte loads, and each byte becomes a float by
// a byte permute and one subtraction (window_byte), not by the integer
// conversion, which Hopper issues at a quarter of the f32 rate.
//
// Bound on the H100: bytes. The f32 output (B*K*oh*ow*C*4) dominates; the
// uint8 reads of the box regions are a fraction of it (half of it with a
// bf16 output). Frames are read in
// their own type (uint8 or f32): the uint8 -> f32 conversion is exact, so
// the caller never makes an f32 copy of the batch.
//
// Exactness: every rounding is spelled out with __fmul_rn / __fadd_rn /
// __fsub_rn / __fmaf_rn / __frcp_rn in the plain version's order, so nvcc
// can neither contract nor reorder it:
//   ys  = fma((o + 0.5) * ch, rcp(oh), y1) - 0.5
//   out = (a * (1 - wx) + b * wx) * (1 - wy) + (c * (1 - wx) + d * wx) * wy
// The coordinate is the one XLA compiles from the JAX source's
// y1 + (o + 0.5) * ch / oh - 0.5 on the CPU (the division by the constant
// becomes a reciprocal multiply fused with the add): a one-ulp change of a
// coordinate moves a sample by up to ulp * 255 across a sharp edge, so the
// port keeps the reference's rounding. Reusing a source row's sums
// changes no operation: they are the plain version's top and bottom sums
// of that row and column (a row outside the frame gives 0 * (1 - wx) +
// 0 * wx = 0, as its taps read 0). The clip keeps a NaN, as torch.clamp
// does, and the mean is one __fsub_rn. The kernel then equals
// crop_resize_plain on the card bit for bit.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;
constexpr int kRowsPerThread = 8;  // output rows a thread walks down

// The two taps of one output column (row): their element offsets in a
// source row, C * x (in the frame, y * W * C), -1 = outside the frame (pad
// mode), and their weights 1 - w and w. 16 bytes: one shared load.
struct Taps {
  int o0, o1;
  float w0, w1;
};

struct Epilogue {
  int clip;                   // clip to [0, 255]
  int sub;                    // then subtract mean[c] (0 without a mean)
  float hi;                   // 255 with the clip, +inf without
  float mean[kMaxChannels];
};

// One tap pair along an axis: the two source indices (clamp mode: inside
// the frame; pad mode: clipped into [-1, n], where -1 and n stand for any
// index outside it) and the weight w of the second.
struct AxisTap {
  int i0, i1;
  float w;
};

// Taps of output index o along one axis. lo: the box start (floored, and
// clipped in clamp mode); len: the box extent in pixels; n_out: the output
// extent; n: the frame extent along this axis.
__device__ __forceinline__ AxisTap axis_tap(int o, float lo, float len,
                                            int n_out, int n, bool clamp) {
  const float of = __fadd_rn((float)o, 0.5f);
  float s = __fsub_rn(
      __fmaf_rn(__fmul_rn(of, len), __frcp_rn((float)n_out), lo), 0.5f);
  float f0, f1;
  if (clamp) {
    s = fminf(fmaxf(s, lo), __fsub_rn(__fadd_rn(lo, len), 1.0f));
    f0 = fminf(fmaxf(floorf(s), 0.0f), (float)(n - 1));
    f1 = fminf(fmaxf(__fadd_rn(f0, 1.0f), 0.0f), (float)(n - 1));
  } else {
    f0 = floorf(s);
    f1 = __fadd_rn(f0, 1.0f);
  }
  // clip in floats: a box far outside the frame never overflows an int
  return {(int)fminf(fmaxf(f0, -1.0f), (float)n),
          (int)fminf(fmaxf(f1, -1.0f), (float)n), __fsub_rn(s, f0)};
}

// Element offset of index i along an axis of n steps of stride elements;
// -1 when i lies outside.
__device__ __forceinline__ int tap_offset(int i, int n, int stride) {
  return (i >= 0 && i < n) ? i * stride : -1;
}

// Box start and extent along one axis, as ops/crop.py computes them.
__device__ __forceinline__ void axis_box(float b0, float b1, int n, bool clamp,
                                         float* lo, float* len) {
  if (clamp) {
    const float x1 = fminf(fmaxf(floorf(b0), 0.0f), (float)(n - 1));
    const float x2 =
        fminf(fmaxf(floorf(b1), __fadd_rn(x1, 1.0f)), (float)n);
    *lo = x1;
    *len = __fsub_rn(x2, x1);
  } else {
    const float x1 = floorf(b0);
    *lo = x1;
    *len = fmaxf(__fsub_rn(floorf(b1), x1), 1.0f);
  }
}

// The 6 bytes p[0..5]: bytes 0-3 in x, 4-5 in the low half of y. Read as
// the aligned 32-bit words that hold them: two, or three when p is 3 mod 4.
__device__ __forceinline__ uint2 load6(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned sh = (unsigned)(a & 3) * 8;
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1);
  const uint32_t w2 = sh == 24 ? __ldg(w + 2) : 0u;
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// Byte b (0..5) of a load6 window, as a float: the byte is placed under the
// exponent of 2^23 (a PRMT from x and y = bytes 4-5 | 0x4B000000), and 2^23
// is subtracted. Exact, and two full-rate instructions where an integer
// conversion would be one at a quarter of the rate.
__device__ __forceinline__ float window_byte(uint32_t x, uint32_t y,
                                             unsigned b) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, y, 0x7660u + b)),
                   8388608.0f);
}

// The C channels of both column taps tx of the source row at element
// offset ro (-1: outside the frame, pad mode) into v0 and v1; a tap
// outside reads 0.
template <typename T, int C>
__device__ __forceinline__ void row_taps(const T* frame, int ro,
                                         const Taps& tx, int W, float* v0,
                                         float* v1) {
  if constexpr (sizeof(T) == 1 && C == 3) {
    // clamp mode: tap 1 is the pixel after tap 0, or tap 0 itself at the
    // last column; pad mode: the pixel after it when both lie inside. So
    // tap 1 is the second pixel of the 6 bytes at pixel min(x0, W - 2),
    // and tap 0 the first, or the second at the last column.
    if (ro >= 0 && tx.o0 >= 0 && tx.o1 >= 0 && W >= 2) {
      const int xb = min(tx.o0, 3 * (W - 2));
      const uint2 q = load6(frame + (ro + xb));
      const uint32_t y = (q.y & 0xffffu) | 0x4B000000u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v1[c] = window_byte(q.x, y, 3 + c);
        v0[c] = tx.o0 == xb ? window_byte(q.x, y, c) : v1[c];
      }
      return;
    }
  }
  const bool in0 = ro >= 0 && tx.o0 >= 0, in1 = ro >= 0 && tx.o1 >= 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v0[c] = in0 ? (float)__ldg(frame + ro + tx.o0 + c) : 0.0f;
    v1[c] = in1 ? (float)__ldg(frame + ro + tx.o1 + c) : 0.0f;
  }
}

// The epilogue. From uint8 frames a sample is a sum of products of
// non-negative values and weights in [0, 1]: finite, never -0, never below
// 0. So its clip is the upper bound alone, and min(v, +inf) - 0 is v: the
// two steps run without a test, as fminf(v, hi) - mean[c].
template <typename T>
__device__ __forceinline__ float apply_epilogue(float v, const Epilogue& ep,
                                                int c) {
  if constexpr (sizeof(T) == 1)
    return __fsub_rn(fminf(v, ep.hi), ep.mean[c]);
  if (ep.clip) v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
  if (ep.sub) v = __fsub_rn(v, ep.mean[c]);
  return v;
}

// f32 -> bf16 bits, to nearest even, as PyTorch converts (c10's
// round_to_nearest_even): a NaN becomes the quiet 0x7FC0.
__device__ __forceinline__ uint16_t bf16_rn(float v) {
  if (v != v) return 0x7FC0u;
  uint32_t u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

__device__ __forceinline__ float bf16_float(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

// The value stored for one element: the f32 epilogue's result, or in bf16
// mode clip(v) rounded to bf16, widened, less the mean, rounded again.
template <typename T, typename TO>
__device__ __forceinline__ TO store_value(float v, const Epilogue& ep,
                                          int c) {
  if constexpr (sizeof(TO) == 4) {
    return apply_epilogue<T>(v, ep, c);
  } else {
    float r;
    if constexpr (sizeof(T) == 1) {
      r = fminf(v, ep.hi);
    } else {
      r = ep.clip ? (v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v)) : v;
    }
    if (!ep.sub) return bf16_rn(r);
    return bf16_rn(__fsub_rn(bf16_float(bf16_rn(r)), ep.mean[c]));
  }
}

// C floats, passed by value so that they stay in registers
template <int C>
struct Px {
  float v[C];
};

// The C horizontal sums a * (1 - wx) + b * wx of the source row at element
// offset ro (-1: outside the frame) for the column taps tx.
template <typename T, int C>
__device__ __forceinline__ Px<C> row_sums(const T* frame, int ro,
                                          const Taps& tx, int W) {
  float v0[C], v1[C];
  row_taps<T, C>(frame, ro, tx, W, v0, v1);
  Px<C> h;
#pragma unroll
  for (int c = 0; c < C; ++c)
    h.v[c] = __fadd_rn(__fmul_rn(v0[c], tx.w0), __fmul_rn(v1[c], tx.w1));
  return h;
}

// TO: float (f32 output) or uint16_t (bf16 bits)
template <typename T, typename TO, int C>
__global__ void __launch_bounds__(kThreads) crop_resize_kernel(
    const T* __restrict__ img, const float4* __restrict__ boxes,
    const uint8_t* __restrict__ valid, TO* __restrict__ out, int K, int H,
    int W, int oh, int ow, int rows, int clamp, Epilogue ep) {
  // elements of a 16-byte piece
  constexpr int kVec = 16 / sizeof(TO);
  extern __shared__ float4 smem4[];
  Taps* xt = reinterpret_cast<Taps*>(smem4);  // [ow]
  Taps* yt = xt + ow;                         // [rows]
  // the staged span, 16-byte aligned, shifted below by the output's offset
  TO* stage = reinterpret_cast<TO*>(yt + rows);
  const int b = blockIdx.z;
  const int k = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, oh - r0);
  const size_t slot = (size_t)b * K + k;
  TO* o = out + (slot * oh + r0) * (size_t)ow * C;
  const int shift =
      (int)((reinterpret_cast<uintptr_t>(o) / sizeof(TO)) & (kVec - 1));
  const bool live = valid[slot];
  if (live) {
    const float4 bx = boxes[slot];
    float x_lo, x_len, y_lo, y_len;
    axis_box(bx.x, bx.z, W, clamp, &x_lo, &x_len);
    axis_box(bx.y, bx.w, H, clamp, &y_lo, &y_len);
    for (int p = threadIdx.x; p < ow; p += kThreads) {
      const AxisTap t = axis_tap(p, x_lo, x_len, ow, W, clamp);
      xt[p] = {tap_offset(t.i0, W, C), tap_offset(t.i1, W, C),
               __fsub_rn(1.0f, t.w), t.w};
    }
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      const AxisTap t = axis_tap(r0 + r, y_lo, y_len, oh, H, clamp);
      yt[r] = {tap_offset(t.i0, H, W * C), tap_offset(t.i1, H, W * C),
               __fsub_rn(1.0f, t.w), t.w};
    }
    __syncthreads();
  }

  // thread t walks down output column t % ow (and t + kThreads ... when
  // ow > kThreads), over the kRowsPerThread rows of its group t / ow. The
  // source rows only move down as it goes, so the horizontal sums of an
  // output row's two source rows stay in top / bot, keyed by their
  // offsets: the next output row reuses both when its rows are the same,
  // and bot as its top when they moved down by one (a 227-row crop of a
  // 100-row box reads each source row for about two output rows)
  const T* frame = img + (size_t)b * H * W * C;
  const int g = ow >= kThreads ? 0 : threadIdx.x / ow;
  const int ra = g * kRowsPerThread, rb = min(nr, ra + kRowsPerThread);
  const int p0 = ow >= kThreads ? threadIdx.x : threadIdx.x % ow;
  for (int p = p0; ra < rb && p < ow; p += kThreads) {
    const Taps tx = live ? xt[p] : Taps{};
    TO* sp = stage + shift + (ra * ow + p) * C;
    int ka = -2, kb = -2;  // offsets of the rows in top, bot; -1 is real
    Px<C> top = {}, bot = {};
    for (int r = ra; r < rb; ++r, sp += ow * C) {
      float v[C];
      if (live) {
        const Taps ty = yt[r];
        if (ty.o0 != ka || ty.o1 != kb) {
          top = ty.o0 == kb ? bot : row_sums<T, C>(frame, ty.o0, tx, W);
          bot = ty.o1 == ty.o0 ? top : row_sums<T, C>(frame, ty.o1, tx, W);
          ka = ty.o0;
          kb = ty.o1;
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[c] = __fadd_rn(__fmul_rn(top.v[c], ty.w0),
                           __fmul_rn(bot.v[c], ty.w1));
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) sp[c] = store_value<T, TO>(v[c], ep, c);
    }
  }
  __syncthreads();

  // span element e sits at stage[shift + e]; o + e is 16-byte aligned
  // exactly when shift + e is a multiple of kVec
  const int n = nr * ow * C;
  const int head = min(n, (kVec - shift) & (kVec - 1));
  const int nv = (n - head) / kVec;
  const int tail = head + kVec * nv;
  const float4* src = reinterpret_cast<const float4*>(stage + shift + head);
  float4* dst = reinterpret_cast<float4*>(o + head);
  for (int q = threadIdx.x; q < nv; q += kThreads) dst[q] = src[q];
  if ((int)threadIdx.x < head) o[threadIdx.x] = stage[shift + threadIdx.x];
  if ((int)threadIdx.x < n - tail)
    o[tail + threadIdx.x] = stage[shift + tail + threadIdx.x];
}

template <typename T, typename TO, int C>
int launch(const void* img, const void* boxes, const void* valid, void* out,
           int B, int K, int H, int W, int oh, int ow, int clamp,
           const Epilogue& ep, cudaStream_t s) {
  // kRowsPerThread rows for each group of ow threads, at most 48 KB of
  // staged output (8 rows, 21.8 KB at 227 x 227 x 3 f32); the bf16 output
  // keeps the f32 tiling
  const int rows = min(min(oh, max(1, kThreads / ow) * kRowsPerThread),
                       max(1, 12288 / (ow * C)));
  // the taps, and the span with kVec - 1 elements of shift room
  const size_t smem = sizeof(Taps) * (size_t)(ow + rows) +
                      sizeof(TO) * ((size_t)rows * ow * C + 16 / sizeof(TO) - 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        crop_resize_kernel<T, TO, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((oh + rows - 1) / rows, K, B);
  crop_resize_kernel<T, TO, C><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(img), static_cast<const float4*>(boxes),
      static_cast<const uint8_t*>(valid), static_cast<TO*>(out), K, H, W, oh,
      ow, rows, clamp, ep);
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int launch_c(const void* img, const void* boxes, const void* valid, void* out,
             int B, int K, int H, int W, int C, int oh, int ow, int clamp,
             const Epilogue& ep, cudaStream_t s) {
  switch (C) {
    case 1:
      return launch<T, TO, 1>(img, boxes, valid, out, B, K, H, W, oh, ow,
                              clamp, ep, s);
    case 2:
      return launch<T, TO, 2>(img, boxes, valid, out, B, K, H, W, oh, ow,
                              clamp, ep, s);
    case 3:
      return launch<T, TO, 3>(img, boxes, valid, out, B, K, H, W, oh, ow,
                              clamp, ep, s);
    default:
      return launch<T, TO, 4>(img, boxes, valid, out, B, K, H, W, oh, ow,
                              clamp, ep, s);
  }
}

template <typename T>
int launch_o(const void* img, const void* boxes, const void* valid, void* out,
             int out_bf16, int B, int K, int H, int W, int C, int oh, int ow,
             int clamp, const Epilogue& ep, cudaStream_t s) {
  if (out_bf16)
    return launch_c<T, uint16_t>(img, boxes, valid, out, B, K, H, W, C, oh,
                                 ow, clamp, ep, s);
  return launch_c<T, float>(img, boxes, valid, out, B, K, H, W, C, oh, ow,
                            clamp, ep, s);
}

}  // namespace

// img: [B, H, W, C] uint8 (is_u8 = 1) or f32, contiguous; boxes: [B, K, 4]
// f32 xyxy pixels; valid: [B, K] bool; out: [B, K, oh, ow, C] f32, or
// bf16 (out_bf16 = 1). clip: clip the samples to [0, 255]; mean: NULL, or
// C floats (host memory) subtracted after the clip.
extern "C" int crop_resize_launch(const void* img, int is_u8,
                                  const void* boxes, const void* valid,
                                  void* out, int out_bf16, int B, int K, int H,
                                  int W, int C, int oh, int ow, int clamp,
                                  int clip, const float* mean, void* stream) {
  // the taps hold element offsets within a frame as ints
  if (C < 1 || C > kMaxChannels || oh < 1 || ow < 1 || H < 1 || W < 1 ||
      K > 65535 || B > 65535 || ow > 2048 ||
      (long long)H * W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  Epilogue ep = {clip != 0, mean != nullptr, clip ? 255.0f : INFINITY,
                 {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int c = 0; mean && c < C; ++c) ep.mean[c] = mean[c];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return launch_o<uint8_t>(img, boxes, valid, out, out_bf16, B, K, H, W, C,
                             oh, ow, clamp, ep, s);
  return launch_o<float>(img, boxes, valid, out, out_bf16, B, K, H, W, C, oh,
                         ow, clamp, ep, s);
}
