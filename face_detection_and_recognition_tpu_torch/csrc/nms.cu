// Greedy NMS keep-mask over score-sorted boxes, all images of a batch in
// one call.
//
// Replaces nms_fixpoint_pallas / _nms_kernel
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:40-123). The TPU
// kernel held the [K, K] "suppressed by a higher kept box" matrix in VMEM and
// iterated the greedy recurrence as a fixpoint of matrix-vector products on
// the MXU, once per image under vmap. Here the matrix is a bit mask, rows in
// score order, W = ceil(K / 32) words a row, in device scratch that the
// caller allocates (128 KB an image at K = 1024, resident in L2):
//
//   phase 1 (nms_overlap_mask_kernel): a CTA computes a tile of 32 rows x 8
//     words. Warp w of the tile owns one word, lane l one row: bit j of the
//     word is set when j > i and box i overlaps box j. The tile's 256 column
//     boxes and their areas are staged in shared memory once and read by
//     the whole warp at the same address (a broadcast). Words left of the
//     diagonal (every j < i) are all zero and never read: they are neither
//     computed nor written. Most pairs do not overlap; for those the IoU
//     is a signed zero and the IEEE division, a subroutine of a dozen
//     instructions, is skipped.
//   phase 2 (nms_sweep_kernel): one CTA per image walks the rows in blocks
//     of 32, the rows of one word column. Each thread loads, one block
//     ahead and straight into registers, the words of the next block that
//     it will use: lane l the diagonal word of row l, and warp g the words
//     right of the diagonal of rows g, g + 8, g + 16, g + 24 (lanes over
//     words). After one barrier (the block's "removed" word is final),
//     __shfl_sync hands every thread the 32 diagonal words, and it resolves
//     the greedy recurrence inside the block in registers: `if alive(l):
//     r |= diag[l]` for l = 0..31, three register operations a row. Each
//     warp then ORs the words of its kept rows into the "removed" bitset in
//     shared memory, one shared atomicOr a word. A block costs one barrier,
//     32 shuffles and the chain; its global loads were issued a block
//     earlier, none of them depends on a kept row, and no integer division
//     is left. (A form that staged each block in shared memory with
//     cp.async, through a ring of 2 or 4 buffers, spent more time a block
//     issuing and waiting for its copies than resolving it.)
//     Invalid rows (and rows >= K) start out removed, so they neither
//     survive nor suppress.
//
// The greedy recurrence S(i) = exists j < i, alive(j) and overlap(j, i) has
// one solution, so the sweep gives the fixpoint's keep mask exactly.
//
// Bound on the H100: the IoU work is K*(K-1)/2 pairs per image, about 16
// f32 operations each; the bytes (boxes in, keep out) are a few hundred KB.
// The sweep is sequential in its ceil(K / 32) blocks; B CTAs run side by
// side. At B = 8, K = 1024 the two phases take about 0.017 and 0.019 ms of
// device time on an H100 (chip_smoke.py prints them).
//
// Exactness: the IoU is written with __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn in the order of the plain version (inter / (a_i + a_j - inter +
// eps)), so nvcc cannot contract a multiply and an add into an FMA and move
// an IoU across the threshold. The staged column areas are the same
// box_area of the same box.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 256;    // K <= 8192
constexpr int kTileWords = 8;     // phase 1: a CTA is 32 rows x 8 words
constexpr int kSweepThreads = 256;  // the sweep: 8 warps x 4 rows a block

__device__ __forceinline__ float box_area(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

__global__ void nms_overlap_mask_kernel(const float4* __restrict__ boxes,
                                        uint32_t* __restrict__ mask, int K,
                                        int W, float thr, int plus1,
                                        int strict, int mode_min) {
  __shared__ float4 cbox[kTileWords * 32];
  __shared__ float carea[kTileWords * 32];
  const int b = blockIdx.z;
  const int rb = blockIdx.y;                 // rows rb*32 .. rb*32 + 31
  const int w0 = blockIdx.x * kTileWords;    // the tile's first word
  if (w0 + kTileWords <= rb) return;         // all left of the diagonal
  const float off = plus1 ? 1.0f : 0.0f;
  const float4* bb = boxes + (size_t)b * K;
  for (int t = threadIdx.x; t < kTileWords * 32; t += blockDim.x) {
    const int j = w0 * 32 + t;
    const float4 bj = j < K ? bb[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    cbox[t] = bj;
    carea[t] = box_area(bj, off);
  }
  __syncthreads();
  const int wl = threadIdx.x >> 5;
  const int i = rb * 32 + (threadIdx.x & 31);
  const int w = w0 + wl;
  if (i >= K || w >= W || w < rb) return;
  const float4 bi = bb[i];
  const float area_i = box_area(bi, off);
  uint32_t word = 0;
  for (int bit = 0; bit < 32; ++bit) {
    const int j = w * 32 + bit;
    if (j <= i || j >= K) continue;
    const float4 bj = cbox[wl * 32 + bit];
    const float area_j = carea[wl * 32 + bit];
    const float lt_x = fmaxf(bi.x, bj.x);
    const float lt_y = fmaxf(bi.y, bj.y);
    const float rb_x = fminf(bi.z, bj.z);
    const float rb_y = fminf(bi.w, bj.w);
    const float iw = fmaxf(__fadd_rn(__fsub_rn(rb_x, lt_x), off), 0.0f);
    const float ih = fmaxf(__fadd_rn(__fsub_rn(rb_y, lt_y), off), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    float denom;
    if (mode_min) {
      denom = fminf(area_i, area_j);
    } else {
      denom = __fsub_rn(__fadd_rn(area_i, area_j), inter);
      if (plus1) denom = __fadd_rn(denom, 1e-16f);
    }
    // most pairs do not touch: a zero intersection over a non-zero,
    // non-NaN denominator is a signed zero, so the division is skipped
    float iou = 0.0f;
    if (inter != 0.0f || denom == 0.0f || denom != denom)
      iou = __fdiv_rn(inter, denom);
    const bool hit = strict ? (iou > thr) : (iou >= thr);
    word |= (uint32_t)hit << bit;
  }
  mask[((size_t)b * K + i) * W + w] = word;
}

// The words of block blk that one thread of the sweep needs, loaded ahead
// into registers: diag, the diagonal word of row lane; right[j][m], word
// blk + 1 + lane + 32 m of row g + 8 j (g = the warp), 0 past W or K.
template <int MW>
struct BlockWords {
  uint32_t diag;
  uint32_t right[4][MW];
};

template <int MW>
__device__ __forceinline__ void load_block(BlockWords<MW>& bw,
                                           const uint32_t* __restrict__ m,
                                           int blk, int K, int W) {
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int rows = min(32, K - blk * 32);
  const uint32_t* base = m + (size_t)blk * 32 * W;
  bw.diag = lane < rows ? __ldg(base + lane * W + blk) : 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = g + 8 * j;
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      const int w = blk + 1 + lane + 32 * mm;
      bw.right[j][mm] = (l < rows && w < W) ? __ldg(base + l * W + w) : 0u;
    }
  }
}

// MW = ceil(W / 32) words right of the diagonal a lane holds for each row
template <int MW>
__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(
    const uint32_t* __restrict__ mask, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ keep, int K, int W) {
  __shared__ uint32_t removed[kMaxWords];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const uint8_t* v = valid + (size_t)b * K;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    uint32_t bits = 0;
    for (int bit = 0; bit < 32; ++bit) {
      const int j = w * 32 + bit;
      if (j < K && v[j]) bits |= 1u << bit;
    }
    removed[w] = ~bits;
  }
  const uint32_t* m = mask + (size_t)b * K * W;
  uint8_t* kp = keep + (size_t)b * K;
  BlockWords<MW> cur;
  load_block(cur, m, 0, K, W);
  for (int blk = 0; blk < W; ++blk) {
    BlockWords<MW> next = cur;
    if (blk + 1 < W) load_block(next, m, blk + 1, K, W);
    __syncthreads();  // removed[blk] is final
    // resolve the block: the diagonal words hold bit l' > l of row l. Each
    // lane loaded one; a shuffle gives every thread all 32, so that the
    // chain is three register operations a row: the sign of bit l,
    // shifted into place, masks row l's word out when row l is removed.
    uint32_t diag[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) diag[l] = __shfl_sync(0xffffffffu, cur.diag, l);
    uint32_t r = removed[blk];
#pragma unroll
    for (int l = 0; l < 32; ++l)
      r |= diag[l] & ~(uint32_t)((int32_t)(r << (31 - l)) >> 31);
    const uint32_t kept = ~r;
    if (threadIdx.x < 32 && blk * 32 + (int)threadIdx.x < K)
      kp[blk * 32 + threadIdx.x] = (kept >> threadIdx.x) & 1u;
    // OR the kept rows' words right of the diagonal into removed: lanes
    // over words, warp g over the kept rows g, g + 8, g + 16, g + 24. The
    // next barrier orders these before any read of the words they touch.
    if (kept) {
      uint32_t acc[MW];
#pragma unroll
      for (int mm = 0; mm < MW; ++mm) acc[mm] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((kept >> (g + 8 * j)) & 1u)
#pragma unroll
          for (int mm = 0; mm < MW; ++mm) acc[mm] |= cur.right[j][mm];
#pragma unroll
      for (int mm = 0; mm < MW; ++mm)
        if (acc[mm]) atomicOr(&removed[blk + 1 + lane + 32 * mm], acc[mm]);
    }
    cur = next;
  }
}

template <int MW>
int launch_sweep(const uint32_t* mask, const uint8_t* valid, uint8_t* keep,
                 int B, int K, int W, cudaStream_t s) {
  nms_sweep_kernel<MW><<<B, kSweepThreads, 0, s>>>(mask, valid, keep, K, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nms_fixpoint_launch(const void* boxes, const void* valid,
                                   void* mask_scratch, void* keep, int B,
                                   int K, float thr, int plus1, int strict,
                                   int mode_min, void* stream) {
  const int W = (K + 31) / 32;
  if (B <= 0 || K <= 0) return 0;
  if (W > kMaxWords || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid1((W + kTileWords - 1) / kTileWords, W, B);
  nms_overlap_mask_kernel<<<grid1, kTileWords * 32, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<uint32_t*>(mask_scratch),
      K, W, thr, plus1, strict, mode_min);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uint32_t* mask = static_cast<const uint32_t*>(mask_scratch);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  if (W <= 32) return launch_sweep<1>(mask, v, kp, B, K, W, s);
  if (W <= 64) return launch_sweep<2>(mask, v, kp, B, K, W, s);
  if (W <= 128) return launch_sweep<4>(mask, v, kp, B, K, W, s);
  return launch_sweep<8>(mask, v, kp, B, K, W, s);
}
