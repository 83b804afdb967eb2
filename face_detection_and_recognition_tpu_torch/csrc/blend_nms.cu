// BlazeFace's weighted-blend NMS, every frame of a batch in one launch, one
// CTA of 1024 threads a frame. Two entry points share one device core:
//
//   blend_nms_launch            score-sorted rows in, blended slots out
//                               (ops/nms.weighted_blend_nms);
//   blaze_decode_blend_launch   BlazeFace's raw heads and anchors in, the
//                               wrapper contract's rows out: decode, score
//                               clip + sigmoid, threshold, stable sort by
//                               score, the blend NMS and the column reorder
//                               (models/blazeface.blazeface_postprocess).
//
// Replaces weighted_blend_nms_pallas / _blend_nms_kernel
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:620-733), and
// with the fused entry point also the decode around it
// (face_detection_and_recognition_tpu/models/blazeface.py:144-172). The TPU
// kernel built the [K, K] IoU matrix in VMEM, found the greedy keep set as a
// fixpoint of matrix-vector products and blended with one-hot matmuls on the
// MXU. Here the function is that of the f32 fori loop of JAX
// ops/nms.py:187-223, computed as it is written: the picks run in order.
//
// What bounds it on the H100: not bytes (a frame's 896 raw rows are 61 KB)
// nor operations (at most 16 passes of 896 IoUs), but the latency of the
// sequential picks and the instructions that 32 warps issue around them. So
// every step of the chain stays in shared memory and registers, and only
// the warps with work take part in each phase:
//
//   - The frame's rows are staged in shared memory once: the standalone
//     entry point copies its [K, D] rows with coalesced loads; the fused
//     one decodes straight into shared memory. Two variants of the core
//     serve only the standalone entry point's contract (K <= 2048, any
//     D >= 5), which no main path reaches: rows read from L2 where they
//     would take the shared memory past kSmemBudget (D >= 19 at K = 2048),
//     and two words a pick warp where K > 1024.
//   - Fused only: one thread an anchor loads its raw row and computes its
//     score; the valid anchors (score >= threshold) are compacted in
//     anchor order and sorted by a 64-bit key, the score's order bits above
//     the anchor index. Every key is unique, so the bitonic network gives
//     the stable order of torch.argsort(-score, stable=True). Only the
//     first P threads sort (P the power of two >= the valid count), with
//     warp shuffles for strides below 32 and a named barrier over those P
//     threads for the rest. Each valid anchor's row is then decoded into
//     its sorted position.
//   - "Alive" is a bit mask over the sorted rows, double-buffered in shared
//     memory. A pick warp owns one word (two above K = 1024) and keeps its
//     alive bits, boxes and areas in registers. For each slot it finds the
//     first alive row itself (a ballot over the words and __ffs), tests the
//     IoU of its alive rows against it (the division only where the boxes
//     meet), and writes the word's taken bits from one __ballot_sync: one
//     warp owns a word, so no atomics on the masks. One named barrier of
//     the pick warps a slot (28 warps at K = 896). Fewer warps with more
//     words each were slower on the H100: each warp's words form a serial
//     chain of IoU tests and ballots.
//   - After the picks of up to kSlotChunk slots, warp s lists slot s's
//     taken rows in ascending order; then one thread a (slot, column)
//     chain (16 x 17 = 272 at BlazeFace's shapes) adds them up with four
//     rows' loads in flight, and stores straight into the output's column
//     order.
//
// Exactness: the IoU is written with __f*_rn intrinsics in the order of the
// JAX expression (iou_matrix on the [1, 0, 3, 2] reorder:
// inter / ((area_a + area_b) - inter)); with inter = 0 the quotient is +-0
// or NaN, above no threshold >= 0, so the division is skipped there. The
// blend sums add the taken rows one by one in score order with __fmul_rn /
// __fadd_rn; a lone taken row is copied. The decode is torch's chain of
// separate ops, each rounded, never an FMA: raw / scale * anchor_wh +
// anchor_xy and h / 2.0. scale (128 or 256) and 2.0 are powers of two, so
// the product with the exact reciprocal used here (as ATen computes a
// division by a scalar) is the quotient's rounding; the wrapper refuses any
// other scale. The sigmoid is the form of ATen's CUDA kernel,
// 1 / (1 + expf(-x)) with IEEE division (as csrc/rows_gather.cu), the clip
// keeps NaN as ATen's clamp does, and both thresholds are compared in f32.
// The plain versions in ops/cuda_kernels.py are these torch ops, so the two
// are equal bit for bit.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 2048;               // standalone K cap (Pallas')
constexpr int kMaxWords = kMaxRows / 32;     // alive / taken words
constexpr int kMaxAnchors = kThreads;        // fused: one thread an anchor
constexpr int kSlotChunk = 32;               // slots picked before a blend pass
constexpr int kRawCols = 16;                 // BlazeFace raw box columns
constexpr int kDetCols = 17;                 // decoded row: 16 coords + score
constexpr size_t kSmemBudget = 200 * 1024;   // dynamic shared memory a CTA
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// named barriers beside __syncthreads' 0: the sort's warps, the pick warps
constexpr int kSortBarrier = 1, kPickBarrier = 2;

static_assert(kWarps == 32 && kSlotChunk <= kWarps,
              "a warp a slot when the taken rows are listed; the warp-count "
              "scan takes one warp a lane");
static_assert(kMaxWords <= 2 * kWarps, "two words a pick warp at most");

// shared memory of the core: alive [2][kMaxWords], taken [kSlotChunk]
// [kMaxWords], then the taken-row list, one int a row
constexpr size_t kCoreBytes = (2 + kSlotChunk) * kMaxWords * sizeof(unsigned);

size_t standalone_bytes(int K, int D, bool staged) {
  return (size_t)K * sizeof(float4) + kCoreBytes + (size_t)K * sizeof(int)
         + (staged ? (size_t)K * D * sizeof(float) : 0);
}

size_t fused_bytes(int N) {
  return (size_t)N * sizeof(float4)                            // boxes
         + 2 * (size_t)kThreads * sizeof(unsigned long long)   // sort keys
         + (size_t)N * kDetCols * sizeof(float)                // rows
         + (size_t)N * sizeof(int)                             // rank
         + kCoreBytes + (size_t)N * sizeof(int);               // core, list
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float box_area(float4 b) {
  // b = (x1, y1, x2, y2)
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou(a, b) > thr, the IoU in the JAX expression's order:
// inter / ((area_a + area_b) - inter)
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  // 0 / union is +-0 or NaN, above no threshold >= 0: no division needed
  if (inter == 0.0f && thr >= 0.0f) return false;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni) > thr;
}

// ATen's CUDA sigmoid for float: 1 / (1 + exp(-x)) with IEEE division
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// inclusive sum over the warp's lanes
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// the first set bit of words[0, W), or -1; every lane of the warp gets it
__device__ __forceinline__ int first_alive(const unsigned* words, int W,
                                           int lane) {
  for (int base = 0; base < W; base += 32) {
    const unsigned w = base + lane < W ? words[base + lane] : 0u;
    const unsigned nz = __ballot_sync(kFull, w != 0u);
    if (nz) {
      const int i = __ffs(nz) - 1;
      return (base + i) * 32 + __ffs(__shfl_sync(kFull, w, i)) - 1;
    }
  }
  return -1;
}

// The picks and blends of one frame, the whole CTA.
//   rows: [n, D] in score order, score in col D-1 (shared or global memory);
//   boxes: [n] xyxy in shared memory; alive: [2][kMaxWords], buffer 0 holds
//   the rows' alive bits (W words); taken: [kSlotChunk][kMaxWords]; list:
//   [n]; count: [kSlotChunk] zeros. All written before a barrier. Output
//   column oc holds input column oc, or with kReorder the BlazeFace
//   contract's [1, 0, 3, 2, 4 ...] one. A pick warp owns kWords words
//   (W <= kWarps * kWords). out: [max_out, D], out_valid: [max_out] of this
//   frame.
template <bool kReorder, int kWords>
__device__ void pick_and_blend(const float* rows, int D, const float4* boxes,
                               unsigned* alive, unsigned* taken, int* list,
                               int* count, int W, float thr, int max_out,
                               float* __restrict__ out,
                               uint8_t* __restrict__ out_valid) {
  __shared__ int slot_off[kSlotChunk], slot_n[kSlotChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a pick warp keeps its words' alive bits, boxes and areas in registers
  const int pick_warps = (W + kWords - 1) / kWords;
  const bool picker = warp < pick_warps;
  unsigned aw[kWords];
  float4 bx[kWords];
  float ar[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int w = warp * kWords + q;
    aw[q] = picker && w < W ? alive[w] : 0u;
    bx[q] = (aw[q] >> lane) & 1u ? boxes[w * 32 + lane]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ar[q] = box_area(bx[q]);
  }
  int buf = 0;
  for (int s0 = 0; s0 < max_out; s0 += kSlotChunk) {
    const int ns = min(kSlotChunk, max_out - s0);
    // the picks: one barrier of the pick warps a slot
    for (int s = 0; picker && s < ns; ++s) {
      const unsigned* cur = alive + buf * kMaxWords;
      unsigned* nxt = alive + (buf ^ 1) * kMaxWords;
      const int first = first_alive(cur, W, lane);
      if (first < 0) break;  // nothing alive: the slot and the rest empty
      const float4 fb = boxes[first];
      const float fa = box_area(fb);
      int n = 0;
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const int w = warp * kWords + q, r = w * 32 + lane;
        // the pick always consumes `first` itself, even an inverted box
        // whose IoU with itself is not 1 (the reference live-locks on it)
        const bool take = ((aw[q] >> lane) & 1u)
                          && (r == first || overlaps(fb, fa, bx[q], ar[q],
                                                     thr));
        const unsigned t = __ballot_sync(kFull, take);
        aw[q] &= ~t;
        n += __popc(t);
        if (lane == q && w < W) {
          taken[s * kMaxWords + w] = t;
          nxt[w] = aw[q];
        }
      }
      if (lane == 0 && n) atomicAdd(&count[s], n);
      buf ^= 1;
      named_barrier(kPickBarrier, pick_warps * 32);
    }
    __syncthreads();
    // warp s lists slot s's taken rows, ascending, after the chunk's
    // earlier slots' rows
    if (warp < ns) {
      const int c = lane < ns ? count[lane] : 0;
      const int before = warp_scan(c, lane) - c;
      const int n = __shfl_sync(kFull, c, warp);
      const int off = __shfl_sync(kFull, before, warp);
      if (n > 0) {
        const unsigned* tw = taken + warp * kMaxWords;
        const unsigned w0 = lane < W ? tw[lane] : 0u;
        const unsigned w1 = lane + 32 < W ? tw[lane + 32] : 0u;
        const int i0 = warp_scan(__popc(w0), lane);
        const int i1 = warp_scan(__popc(w1), lane);
        int o = off + i0 - __popc(w0);
        for (unsigned bits = w0; bits; bits &= bits - 1u)
          list[o++] = lane * 32 + __ffs(bits) - 1;
        o = off + __shfl_sync(kFull, i0, 31) + i1 - __popc(w1);
        for (unsigned bits = w1; bits; bits &= bits - 1u)
          list[o++] = (lane + 32) * 32 + __ffs(bits) - 1;
      }
      if (lane == 0) {
        slot_off[warp] = off;
        slot_n[warp] = n;
      }
    }
    __syncthreads();
    if (tid < ns) count[tid] = 0;  // for the next chunk's picks
    // one thread a (slot, column) chain: the taken rows in score order,
    // four rows' loads in flight at a time
    for (int e = tid; e < ns * D; e += kThreads) {
      const int s = e / D, oc = e - s * D;
      const int c = kReorder && oc < 4 ? oc ^ 1 : oc;
      const int n = slot_n[s];
      const int* l = list + slot_off[s];
      float v = 0.0f;
      if (n == 1) {
        v = rows[(size_t)l[0] * D + c];
      } else if (n > 1) {
        float total = 0.0f, num = 0.0f;
        int i = 0;
        for (; i + 4 <= n; i += 4) {
          float sc[4], x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* row = rows + (size_t)l[i + q] * D;
            sc[q] = row[D - 1];
            x[q] = row[c];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            total = __fadd_rn(total, sc[q]);
            num = __fadd_rn(num, __fmul_rn(x[q], sc[q]));
          }
        }
        for (; i < n; ++i) {
          const float* row = rows + (size_t)l[i] * D;
          total = __fadd_rn(total, row[D - 1]);
          num = __fadd_rn(num, __fmul_rn(row[c], row[D - 1]));
        }
        v = c == D - 1 ? __fdiv_rn(total, (float)n) : __fdiv_rn(num, total);
      }
      out[(size_t)(s0 + s) * D + oc] = v;
      if (oc == 0) out_valid[s0 + s] = n > 0;
    }
    __syncthreads();  // taken, list and the slot tables are written again
  }
}

__global__ void __launch_bounds__(kThreads, 1)
blend_nms_kernel(const float* __restrict__ dets,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 uint8_t* __restrict__ out_valid, int K, int D, float thr,
                 int max_out, bool staged) {
  extern __shared__ float4 smem[];
  float4* boxes = smem;                                          // [K] xyxy
  unsigned* alive = reinterpret_cast<unsigned*>(boxes + K);
  unsigned* taken = alive + 2 * kMaxWords;
  int* list = reinterpret_cast<int*>(taken + kSlotChunk * kMaxWords);
  float* srows = reinterpret_cast<float*>(list + K);             // [K, D]
  __shared__ int count[kSlotChunk];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* g = dets + (size_t)b * K * D;
  const int W = (K + 31) / 32;
  if (staged) {  // the frame's rows are one contiguous span: coalesced
    const int n = K * D;
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0
        && reinterpret_cast<uintptr_t>(srows) % 16 == 0) {
      for (int i = tid; i < n / 4; i += kThreads)
        reinterpret_cast<float4*>(srows)[i] =
            __ldg(reinterpret_cast<const float4*>(g) + i);
    } else {
      for (int i = tid; i < n; i += kThreads) srows[i] = __ldg(g + i);
    }
  }
  for (int w = warp; w < W; w += kWarps) {
    const int j = w * 32 + lane;
    const unsigned bits = __ballot_sync(kFull,
                                        j < K && valid[(size_t)b * K + j]);
    if (lane == 0) alive[w] = bits;
  }
  if (tid < kSlotChunk) count[tid] = 0;
  __syncthreads();
  const float* rows = staged ? srows : g;
  for (int j = tid; j < K; j += kThreads) {
    const float* r = rows + (size_t)j * D;
    boxes[j] = make_float4(r[1], r[0], r[3], r[2]);
  }
  __syncthreads();
  float* o = out + (size_t)b * max_out * D;
  uint8_t* ov = out_valid + (size_t)b * max_out;
  if (W <= kWarps) {
    pick_and_blend<false, 1>(rows, D, boxes, alive, taken, list, count, W,
                             thr, max_out, o, ov);
  } else {
    pick_and_blend<false, 2>(rows, D, boxes, alive, taken, list, count, W,
                             thr, max_out, o, ov);
  }
}

// raw_boxes [B, N, 16], raw_scores [B, N], anchors [N, 4] (x, y, w, h):
// decode, sort and blend
__global__ void __launch_bounds__(kThreads, 1)
blaze_decode_blend_kernel(const float* __restrict__ raw_boxes,
                          const float* __restrict__ raw_scores,
                          const float* __restrict__ anchors,
                          float* __restrict__ out,
                          uint8_t* __restrict__ out_valid, int N, float scale,
                          float clip, float score_thr, float iou_thr,
                          int max_out) {
  extern __shared__ float4 smem[];
  float4* boxes = smem;                                       // [N] xyxy
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(boxes + N);       // [2][kThreads]
  float* rows = reinterpret_cast<float*>(keys + 2 * kThreads);  // [N, 17]
  int* rank = reinterpret_cast<int*>(rows + N * kDetCols);     // [N]
  unsigned* alive = reinterpret_cast<unsigned*>(rank + N);
  unsigned* taken = alive + 2 * kMaxWords;
  int* list = reinterpret_cast<int*>(taken + kSlotChunk * kMaxWords);
  __shared__ int warp_count[kWarps];
  __shared__ int count[kSlotChunk];

  const int b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  // 1. one thread an anchor: its raw row into registers, its score
  float raw[kRawCols];
  float4 anc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float score = 0.0f;
  bool valid = false;
  if (t < N) {
    const float4* src = reinterpret_cast<const float4*>(
        raw_boxes + ((size_t)b * N + t) * kRawCols);
#pragma unroll
    for (int q = 0; q < kRawCols / 4; ++q) {
      const float4 v = __ldg(src + q);
      raw[4 * q] = v.x;
      raw[4 * q + 1] = v.y;
      raw[4 * q + 2] = v.z;
      raw[4 * q + 3] = v.w;
    }
    anc = __ldg(reinterpret_cast<const float4*>(anchors) + t);
    const float x = __ldg(raw_scores + (size_t)b * N + t);
    score = sigmoid(isnan(x) ? x : fminf(fmaxf(x, -clip), clip));
    valid = score >= score_thr;
  }

  // 2. the valid anchors' keys, compacted in anchor order
  const unsigned vb = __ballot_sync(kFull, valid);
  if (lane == 0) warp_count[warp] = __popc(vb);
  if (t < kSlotChunk) count[t] = 0;
  __syncthreads();
  const int own = warp_count[lane];
  const int incl = warp_scan(own, lane);
  const int nv = __shfl_sync(kFull, incl, 31);
  const int before = __shfl_sync(kFull, incl - own, warp);
  if (valid) {
    // descending score: the complement of the float's order bits
    const unsigned u = __float_as_uint(score);
    const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    keys[before + __popc(vb & ((1u << lane) - 1u))] =
        ((unsigned long long)~ord << 32) | (unsigned)t;
  }
  __syncthreads();

  // 3. bitonic sort of the nv keys by the first P threads, P the power of
  //    two >= max(nv, 32), padded with the largest key; strides below 32 by
  //    shuffles, the rest through the two key buffers in turn (buffer 0
  //    holds the input: the first shared stage writes buffer 1)
  int P = 32;
  while (P < nv) P <<= 1;
  if (t < P) {
    unsigned long long key = t < nv ? keys[t] : ~0ull;
    int ping = 1;
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j >= 32; j >>= 1) {
        unsigned long long* kb = keys + ping * kThreads;
        ping ^= 1;
        kb[t] = key;
        named_barrier(kSortBarrier, P);
        const unsigned long long other = kb[t ^ j];
        key = (((t & j) == 0) == ((t & k) == 0)) == (other < key) ? other
                                                                   : key;
      }
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) {
        if (j < k) {
          const unsigned long long other = __shfl_xor_sync(kFull, key, j);
          key = (((t & j) == 0) == ((t & k) == 0)) == (other < key) ? other
                                                                     : key;
        }
      }
    }
    if (t < nv) rank[(unsigned)key] = t;  // the low half is the anchor
  }
  __syncthreads();

  // 4. each valid anchor decoded into its row of score order
  if (valid) {
    // scale is a power of two: its reciprocal is exact, and a product with
    // it is the quotient's rounding, as ATen computes a scalar division
    const float inv = __frcp_rn(scale);
    const float aw = anc.z, ah = anc.w;
    auto lin = [&](float v, float s, float off) {
      return __fadd_rn(__fmul_rn(__fmul_rn(v, inv), s), off);
    };
    const float xc = lin(raw[0], aw, anc.x), yc = lin(raw[1], ah, anc.y);
    const float hw = __fmul_rn(__fmul_rn(__fmul_rn(raw[2], inv), aw), 0.5f);
    const float hh = __fmul_rn(__fmul_rn(__fmul_rn(raw[3], inv), ah), 0.5f);
    float* row = rows + rank[t] * kDetCols;  // stride 17: no bank conflicts
    row[0] = __fsub_rn(yc, hh);
    row[1] = __fsub_rn(xc, hw);
    row[2] = __fadd_rn(yc, hh);
    row[3] = __fadd_rn(xc, hw);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      row[4 + 2 * k] = lin(raw[4 + 2 * k], aw, anc.x);
      row[5 + 2 * k] = lin(raw[5 + 2 * k], ah, anc.y);
    }
    row[16] = score;
    boxes[rank[t]] = make_float4(row[1], row[0], row[3], row[2]);
  }
  const int W = (nv + 31) / 32;
  if (t < W) alive[t] = (t + 1) * 32 <= nv ? kFull : (1u << (nv & 31)) - 1u;
  __syncthreads();

  // 5. the picks and the blends
  pick_and_blend<true, 1>(rows, kDetCols, boxes, alive, taken, list, count,
                          W, iou_thr, max_out,
                          out + (size_t)b * max_out * kDetCols,
                          out_valid + (size_t)b * max_out);
}

// Raise the kernel's dynamic shared memory cap once a process and card.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t cap, size_t* done) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev] >= cap) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cap);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = cap;
  return (int)err;
}

size_t g_standalone_cap[kMaxDevices];
size_t g_fused_cap[kMaxDevices];

}  // namespace

// dets: [B, K, D] f32, score-sorted per frame, score in col D-1; valid:
// [B, K] uint8. out: [B, max_out, D] f32; out_valid: [B, max_out] uint8.
extern "C" int blend_nms_launch(const void* dets, const void* valid,
                                void* out, void* out_valid, int B, int K,
                                int D, float thr, int max_out, void* stream) {
  if (B <= 0 || max_out <= 0) return 0;
  if (K < 0 || K > kMaxRows || D < 5) return (int)cudaErrorInvalidValue;
  const bool staged = standalone_bytes(K, D, true) <= kSmemBudget;
  const size_t bytes = standalone_bytes(K, D, staged);
  int err = allow_smem(blend_nms_kernel, bytes, kSmemBudget, g_standalone_cap);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blend_nms_kernel<<<B, kThreads, bytes, s>>>(
      static_cast<const float*>(dets), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), static_cast<uint8_t*>(out_valid), K, D, thr,
      max_out, staged);
  return (int)cudaGetLastError();
}

// raw_boxes: [B, N, 16] f32, 16-byte aligned; raw_scores: [B, N] f32;
// anchors: [N, 4] f32 (x, y, w, h), 16-byte aligned; N <= 1024; scale a
// power of two. out: [B, max_out, 17] f32 rows [xmin, ymin, xmax, ymax,
// 12 kps, conf]; out_valid: [B, max_out] uint8.
extern "C" int blaze_decode_blend_launch(
    const void* raw_boxes, const void* raw_scores, const void* anchors,
    void* out, void* out_valid, int B, int N, float scale, float clip,
    float score_thr, float iou_thr, int max_out, void* stream) {
  if (B <= 0 || max_out <= 0) return 0;
  if (N < 0 || N > kMaxAnchors) return (int)cudaErrorInvalidValue;
  const size_t bytes = fused_bytes(N);
  int err = allow_smem(blaze_decode_blend_kernel, bytes,
                       fused_bytes(kMaxAnchors), g_fused_cap);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blaze_decode_blend_kernel<<<B, kThreads, bytes, s>>>(
      static_cast<const float*>(raw_boxes),
      static_cast<const float*>(raw_scores),
      static_cast<const float*>(anchors), static_cast<float*>(out),
      static_cast<uint8_t*>(out_valid), N, scale, clip, score_thr, iou_thr,
      max_out);
  return (int)cudaGetLastError();
}
