// Greedy NMS keep-mask over score-sorted boxes, all images of a batch in
// one call.
//
// Replaces nms_fixpoint_pallas / _nms_kernel
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:40-123). The TPU
// kernel held the [K, K] "suppressed by a higher kept box" matrix in VMEM and
// iterated the greedy recurrence as a fixpoint of matrix-vector products on
// the MXU, once per image under vmap. Here:
//
//   phase 1 (nms_overlap_mask_kernel): one thread per (image, row i, 32-column
//     word) writes bit j of the word when j > i and box i overlaps box j.
//     The mask is K*K/32 uint32 words per image (128 KB at K = 1024), in
//     device scratch that the caller allocates.
//   phase 2 (nms_sweep_kernel): one warp per image walks the rows in score
//     order; a row that is still alive ORs its mask row into the "removed"
//     bitset kept in shared memory. Invalid rows start out removed, so they
//     neither survive nor suppress.
//
// The greedy recurrence S(i) = exists j < i, alive(j) and overlap(j, i) has
// one solution, so the sweep gives the fixpoint's keep mask exactly.
//
// Bound on the H100: the IoU work is K*(K-1)/2 pairs per image, about 16
// f32 operations each; the bytes (boxes in, keep out) are a few hundred KB.
// What limits this design in practice is the sweep's chain of dependent
// loads, one L2 round trip per kept row; it runs B warps side by side.
//
// Exactness: the IoU is written with __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn in the order of the plain version (inter / (a_i + a_j - inter +
// eps)), so nvcc cannot contract a multiply and an add into an FMA and move
// an IoU across the threshold.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 256;  // K <= 8192

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), off),
                   __fadd_rn(__fsub_rn(y2, y1), off));
}

__global__ void nms_overlap_mask_kernel(const float4* __restrict__ boxes,
                                        uint32_t* __restrict__ mask, int K,
                                        int W, float thr, int plus1,
                                        int strict, int mode_min) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K * W) return;
  const int i = t / W;
  const int w = t % W;
  const float off = plus1 ? 1.0f : 0.0f;
  const float4* bb = boxes + (size_t)b * K;
  const float4 bi = bb[i];
  const float area_i = box_area(bi.x, bi.y, bi.z, bi.w, off);
  uint32_t word = 0;
  const int j0 = w * 32;
  for (int bit = 0; bit < 32; ++bit) {
    const int j = j0 + bit;
    if (j <= i || j >= K) continue;
    const float4 bj = bb[j];
    const float lt_x = fmaxf(bi.x, bj.x);
    const float lt_y = fmaxf(bi.y, bj.y);
    const float rb_x = fminf(bi.z, bj.z);
    const float rb_y = fminf(bi.w, bj.w);
    const float iw = fmaxf(__fadd_rn(__fsub_rn(rb_x, lt_x), off), 0.0f);
    const float ih = fmaxf(__fadd_rn(__fsub_rn(rb_y, lt_y), off), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float area_j = box_area(bj.x, bj.y, bj.z, bj.w, off);
    float denom;
    if (mode_min) {
      denom = fminf(area_i, area_j);
    } else {
      denom = __fsub_rn(__fadd_rn(area_i, area_j), inter);
      if (plus1) denom = __fadd_rn(denom, 1e-16f);
    }
    const float iou = __fdiv_rn(inter, denom);
    const bool hit = strict ? (iou > thr) : (iou >= thr);
    word |= (uint32_t)hit << bit;
  }
  mask[((size_t)b * K + i) * W + w] = word;
}

__global__ void nms_sweep_kernel(const uint32_t* __restrict__ mask,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ keep, int K, int W) {
  __shared__ uint32_t removed[kMaxWords];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* v = valid + (size_t)b * K;
  for (int w = lane; w < W; w += 32) {
    uint32_t bits = 0;
    for (int bit = 0; bit < 32; ++bit) {
      const int j = w * 32 + bit;
      if (j < K && v[j]) bits |= 1u << bit;
    }
    removed[w] = ~bits;
  }
  __syncwarp();
  const uint32_t* m = mask + (size_t)b * K * W;
  for (int i = 0; i < K; ++i) {
    if ((removed[i >> 5] >> (i & 31)) & 1u) continue;  // same for all lanes
    const uint32_t* row = m + (size_t)i * W;
    for (int w = (i >> 5) + lane; w < W; w += 32) removed[w] |= row[w];
    __syncwarp();
  }
  // bit i of `removed` never changes after step i, so the final bitset is
  // the keep mask
  uint8_t* kp = keep + (size_t)b * K;
  for (int j = lane; j < K; j += 32) kp[j] = !((removed[j >> 5] >> (j & 31)) & 1u);
}

}  // namespace

extern "C" int nms_fixpoint_launch(const void* boxes, const void* valid,
                                   void* mask_scratch, void* keep, int B,
                                   int K, float thr, int plus1, int strict,
                                   int mode_min, void* stream) {
  const int W = (K + 31) / 32;
  if (B <= 0 || K <= 0) return 0;
  if (W > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  dim3 grid1((K * W + threads - 1) / threads, B);
  nms_overlap_mask_kernel<<<grid1, threads, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<uint32_t*>(mask_scratch),
      K, W, thr, plus1, strict, mode_min);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<B, 32, 0, s>>>(
      static_cast<const uint32_t*>(mask_scratch),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K, W);
  return (int)cudaGetLastError();
}
