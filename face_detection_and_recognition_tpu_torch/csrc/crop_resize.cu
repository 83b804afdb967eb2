// Crop + bilinear resize (half-pixel centres) of K boxes from each of B
// NHWC frames, all frames in one launch:
//   out[b, k, o, p, c] = bilinear sample of img[b] at the box's (o, p) grid
// with the two box semantics of the JAX package's ops/crop.py: clamp
// (crop_and_resize, the box is clipped to the frame and so are the samples)
// and pad (crop_and_resize_padded, MTCNN: taps outside the frame read 0).
// Invalid slots write zeros and read nothing.
//
// Replaces crop_gemm_pallas / _crop_kernel / _crop_kernel_windowed
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:237-501). The
// TPU has no fast gather, so that kernel built hat-weight matrices and ran
// two MXU GEMMs per channel (bf16-pass precision, ~0.4% of the pixel range);
// the windowed variant only cut the GEMMs to the image windows a box
// touches. A GPU gathers natively: this is a direct 4-tap sampler that
// computes exactly the JAX "gather" path (ops/crop.py:129-146, :187-208).
//
// Work split: one CTA per (row tile, box, frame). The CTA first writes the
// column taps of all ow output columns and the row taps of its rows into
// shared memory (x0, x1, wx and y0, y1, wy, with -1 marking a tap outside
// the frame in pad mode); then one thread per output pixel reads the 4
// taps of all C channels and writes C floats.
//
// Bound on the H100: bytes. The f32 output (B*K*oh*ow*C*4) dominates; the
// uint8 reads of the box regions are a fraction of it. Frames are read in
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
// port keeps the reference's rounding. The kernel then equals
// crop_resize_plain on the card bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

struct Tap {
  int i0, i1;  // the two source indices; -1 = outside the frame (pad mode)
  float w;     // weight of i1
};

// Taps of output index o along one axis. lo: the box start (floored, and
// clipped in clamp mode); len: the box extent in pixels; n_out: the output
// extent; n: the frame extent along this axis.
__device__ __forceinline__ Tap axis_tap(int o, float lo, float len, int n_out,
                                        int n, bool clamp) {
  const float of = __fadd_rn((float)o, 0.5f);
  float s = __fsub_rn(
      __fmaf_rn(__fmul_rn(of, len), __frcp_rn((float)n_out), lo), 0.5f);
  Tap t;
  if (clamp) {
    s = fminf(fmaxf(s, lo), __fsub_rn(__fadd_rn(lo, len), 1.0f));
    const float f0 = fminf(fmaxf(floorf(s), 0.0f), (float)(n - 1));
    const float f1 = fminf(fmaxf(__fadd_rn(f0, 1.0f), 0.0f), (float)(n - 1));
    t.i0 = (int)f0;
    t.i1 = (int)f1;
    t.w = __fsub_rn(s, f0);
  } else {
    const float f0 = floorf(s);
    const float f1 = __fadd_rn(f0, 1.0f);
    // compare in floats: a box far outside the frame never becomes an int
    t.i0 = (f0 >= 0.0f && f0 < (float)n) ? (int)f0 : -1;
    t.i1 = (f1 >= 0.0f && f1 < (float)n) ? (int)f1 : -1;
    t.w = __fsub_rn(s, f0);
  }
  return t;
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

__device__ __forceinline__ float load_px(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load_px(const float* p) { return *p; }

template <typename T>
__global__ void crop_resize_kernel(const T* __restrict__ img,
                                   const float4* __restrict__ boxes,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ out, int K, int H,
                                   int W, int C, int oh, int ow, int rows,
                                   int clamp) {
  extern __shared__ unsigned char smem[];
  Tap* xt = reinterpret_cast<Tap*>(smem);  // [ow]
  Tap* yt = xt + ow;                       // [rows]
  const int b = blockIdx.z;
  const int k = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, oh - r0);
  const size_t slot = (size_t)b * K + k;
  float* o = out + (slot * oh + r0) * (size_t)ow * C;
  const int n_px = nr * ow;
  if (!valid[slot]) {
    for (int i = threadIdx.x; i < n_px * C; i += blockDim.x) o[i] = 0.0f;
    return;
  }
  const float4 bx = boxes[slot];
  float x_lo, x_len, y_lo, y_len;
  axis_box(bx.x, bx.z, W, clamp, &x_lo, &x_len);
  axis_box(bx.y, bx.w, H, clamp, &y_lo, &y_len);
  for (int p = threadIdx.x; p < ow; p += blockDim.x)
    xt[p] = axis_tap(p, x_lo, x_len, ow, W, clamp);
  for (int r = threadIdx.x; r < nr; r += blockDim.x)
    yt[r] = axis_tap(r0 + r, y_lo, y_len, oh, H, clamp);
  __syncthreads();

  const T* frame = img + (size_t)b * H * W * C;
  for (int i = threadIdx.x; i < n_px; i += blockDim.x) {
    const Tap ty = yt[i / ow];
    const Tap tx = xt[i % ow];
    const float wy1 = ty.w, wy0 = __fsub_rn(1.0f, wy1);
    const float wx1 = tx.w, wx0 = __fsub_rn(1.0f, wx1);
    const T* r_a = ty.i0 >= 0 ? frame + (size_t)ty.i0 * W * C : nullptr;
    const T* r_b = ty.i1 >= 0 ? frame + (size_t)ty.i1 * W * C : nullptr;
    const int ca = tx.i0 * C, cb = tx.i1 * C;
    float* dst = o + (size_t)i * C;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c >= C) break;
      // a tap outside the frame (pad mode only) reads 0
      const float v00 = (r_a && tx.i0 >= 0) ? load_px(r_a + ca + c) : 0.0f;
      const float v01 = (r_a && tx.i1 >= 0) ? load_px(r_a + cb + c) : 0.0f;
      const float v10 = (r_b && tx.i0 >= 0) ? load_px(r_b + ca + c) : 0.0f;
      const float v11 = (r_b && tx.i1 >= 0) ? load_px(r_b + cb + c) : 0.0f;
      const float top = __fadd_rn(__fmul_rn(v00, wx0), __fmul_rn(v01, wx1));
      const float bot = __fadd_rn(__fmul_rn(v10, wx0), __fmul_rn(v11, wx1));
      dst[c] = __fadd_rn(__fmul_rn(top, wy0), __fmul_rn(bot, wy1));
    }
  }
}

template <typename T>
int launch(const void* img, const void* boxes, const void* valid, void* out,
           int B, int K, int H, int W, int C, int oh, int ow, int clamp,
           cudaStream_t s) {
  // about 2048 output pixels a CTA
  const int rows = max(1, min(oh, 2048 / ow));
  const size_t smem = sizeof(Tap) * (size_t)(ow + rows);
  dim3 grid((oh + rows - 1) / rows, K, B);
  crop_resize_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(img), static_cast<const float4*>(boxes),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), K, H, W, C,
      oh, ow, rows, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// img: [B, H, W, C] uint8 (is_u8 = 1) or f32, contiguous; boxes: [B, K, 4]
// f32 xyxy pixels; valid: [B, K] bool; out: [B, K, oh, ow, C] f32.
extern "C" int crop_resize_launch(const void* img, int is_u8,
                                  const void* boxes, const void* valid,
                                  void* out, int B, int K, int H, int W, int C,
                                  int oh, int ow, int clamp, void* stream) {
  if (C < 1 || C > kMaxChannels || oh < 1 || ow < 1 || H < 1 || W < 1 ||
      K > 65535 || B > 65535 || ow > 2048)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return launch<uint8_t>(img, boxes, valid, out, B, K, H, W, C, oh, ow,
                           clamp, s);
  return launch<float>(img, boxes, valid, out, B, K, H, W, C, oh, ow, clamp,
                       s);
}
