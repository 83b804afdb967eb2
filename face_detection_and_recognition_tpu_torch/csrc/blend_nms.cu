// BlazeFace's weighted-blend NMS over score-sorted rows, every image of a
// batch in one launch.
//
// Replaces weighted_blend_nms_pallas / _blend_nms_kernel
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:620-733). The TPU
// kernel built the [K, K] IoU matrix in VMEM, found the greedy keep set as a
// fixpoint of matrix-vector products, gave each row its first kept owner and
// blended with one-hot matmuls on the MXU (at the MXU's default precision).
// Here the function is that of the f32 fori loop of JAX ops/nms.py:187-223,
// computed as it is written: one CTA per image walks the picks in order.
//
//   - The image's boxes (cols 0:4, [ymin, xmin, ymax, xmax]) and an "alive"
//     flag per row sit in shared memory: 18 KB at BlazeFace's K = 896.
//   - Slot s (s < max_out) picks the first alive row, by an atomicMin over
//     the rows. It takes every alive row whose IoU with that row is above
//     the threshold (plain jaccard, no +1), and always the row itself, even
//     an inverted box whose IoU with itself is not 1.
//   - The taken rows are compacted in score order (warp ballots and a
//     prefix over the warps). One thread per column sums coord * score, and
//     the score, over them in that order: with n > 1 taken rows the slot's
//     coords are sum(coord * score) / sum(score) and its score
//     sum(score) / n; with n = 1 the row is copied as it is.
//   - Slots past the last pick are zero rows with valid 0.
//
// Bound on the H100: at most max_out passes of K IoUs (about 15 f32
// operations each) and the blend sums of the taken rows, a few hundred
// thousand operations a frame, and a few tens of KB of rows read: under a
// microsecond. The picks are sequential, so the launch and the chain of
// max_out block-wide steps set the time.
//
// Exactness: the IoU is written with __f*_rn intrinsics in the order of the
// JAX expression (iou_matrix on the [1, 0, 3, 2] reorder:
// inter / ((area_a + area_b) - inter)), and the blend sums add the taken
// rows one by one in score order with __fmul_rn / __fadd_rn. The plain
// version in ops/cuda_kernels.py does the same, so the two are equal bit for
// bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 2048;  // K cap, as the Pallas version's
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float box_area(float4 b) {
  // b = (x1, y1, x2, y2)
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, box_area(b)), inter);
  return __fdiv_rn(inter, uni);
}

__global__ void __launch_bounds__(kThreads)
blend_nms_kernel(const float* __restrict__ dets,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 uint8_t* __restrict__ out_valid, int K, int D, float thr,
                 int max_out) {
  __shared__ float4 boxes[kMaxRows];   // xyxy: cols [1, 0, 3, 2]
  __shared__ uint8_t alive[kMaxRows];
  __shared__ int taken[kMaxRows];      // rows of the current slot, in order
  __shared__ int warp_count[kWarps];
  __shared__ int s_first;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* rows = dets + (size_t)b * K * D;
  for (int j = tid; j < K; j += kThreads) {
    const float* r = rows + (size_t)j * D;
    boxes[j] = make_float4(r[1], r[0], r[3], r[2]);
    alive[j] = valid[(size_t)b * K + j];
  }

  for (int slot = 0; slot < max_out; ++slot) {
    if (tid == 0) s_first = K;
    __syncthreads();  // also orders the loads and the last slot's updates
    for (int j = tid; j < K; j += kThreads) {
      if (alive[j]) {
        atomicMin(&s_first, j);
        break;  // rows ascend, so the thread's first alive row is its least
      }
    }
    __syncthreads();
    const int first = s_first;
    float* o = out + ((size_t)b * max_out + slot) * D;
    if (first == K) {  // nothing alive: this slot and the rest are empty
      for (int e = tid; e < (max_out - slot) * D; e += kThreads) o[e] = 0.0f;
      for (int e = tid; e < max_out - slot; e += kThreads)
        out_valid[(size_t)b * max_out + slot + e] = 0;
      return;
    }
    const float4 fb = boxes[first];
    const float fa = box_area(fb);
    // compact the taken rows in order, kThreads rows at a time
    int n = 0;
    for (int base = 0; base < K; base += kThreads) {
      const int j = base + tid;
      const bool take = j < K && alive[j]
                        && (j == first || iou(fb, fa, boxes[j]) > thr);
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (lane == 0) warp_count[warp] = __popc(mask);
      __syncthreads();
      int before = n;
      for (int w = 0; w < warp; ++w) before += warp_count[w];
      if (take) {
        taken[before + __popc(mask & ((1u << lane) - 1u))] = j;
        alive[j] = 0;
      }
      for (int w = 0; w < kWarps; ++w) n += warp_count[w];
      __syncthreads();  // warp_count is written again
    }
    if (n == 1) {
      for (int c = tid; c < D; c += kThreads) o[c] = rows[(size_t)first * D + c];
    } else {
      for (int c = tid; c < D; c += kThreads) {
        float total = 0.0f, num = 0.0f;
        for (int t = 0; t < n; ++t) {
          const float* r = rows + (size_t)taken[t] * D;
          const float sc = r[D - 1];
          total = __fadd_rn(total, sc);
          num = __fadd_rn(num, __fmul_rn(r[c], sc));
        }
        o[c] = c == D - 1 ? __fdiv_rn(total, (float)n) : __fdiv_rn(num, total);
      }
    }
    if (tid == 0) out_valid[(size_t)b * max_out + slot] = 1;
  }
}

}  // namespace

// dets: [B, K, D] f32, score-sorted per image, score in col D-1; valid:
// [B, K] uint8. out: [B, max_out, D] f32; out_valid: [B, max_out] uint8.
extern "C" int blend_nms_launch(const void* dets, const void* valid,
                                void* out, void* out_valid, int B, int K,
                                int D, float thr, int max_out, void* stream) {
  if (B <= 0 || max_out <= 0) return 0;
  if (K < 0 || K > kMaxRows || D < 5) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blend_nms_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float*>(dets), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), static_cast<uint8_t*>(out_valid), K, D, thr,
      max_out);
  return (int)cudaGetLastError();
}
