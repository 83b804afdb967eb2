// Candidate gather + decode of the yolov5-face detect path, in one launch:
//   pred[b, k, :] = decode(concat(levels, axis=1)[b, idx[b, k], :])
// with boxes[b, k] = xywh2xyxy(pred[b, k, 0:4]) and
// valid[b, k] = pred[b, k, 4] >= conf, reading the per-level raw maps in
// place (no concat).
//
// Replaces candidate_rows_gather_pallas / _rows_gather_kernel
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:507-613) and
// the decode around it: _candidate_grid_params and the candidate decode of
// yolov5_face_detect_maps (face_detection_and_recognition_tpu/models/
// yolov5_face.py:418-456, 504-530). On the TPU the gather streamed every
// level through the MXU as a one-hot GEMM, exact only for bf16 rows. Here
// a gather is a plain load, exact for f32 and bf16 alike, and the decode
// is a few flops a column, so both go into the load's thread.
//
// Work: each row is no / 4 threads (4 for no = 16), each owning one piece
// of 4 columns: one 16-byte load of an f32 piece (8 bytes of bf16) and one
// 16-byte store of the decoded f32 piece, so a warp reads 8 whole rows of
// 64 bytes. At B * K = 8192 rows that is 128 CTAs of 256 threads. The
// thread of piece 0 (cx, cy, w, h) also writes the xyxy box, the thread of
// piece 1 (obj) the valid byte. The level, anchor and grid cell of a row
// come from integer arithmetic on its index against the level layout, a
// struct of constants (rows, nx, ny * nx, stride, anchors of up to 4
// levels x 3 anchors) that the wrapper builds once per layout and passes
// by value; every index into it is a compile-time constant, so it stays in
// the constant bank.
//
// Bound on the H100: the bytes of the selected raw rows, the indices, the
// decoded rows, the boxes and the valid bytes, at 3.35 TB/s: ~1.2 MB,
// ~0.36 us, at B * K = 8192 f32 rows. So the launch, not the card, sets
// its time; the fusion removes the ~85 small launches that used to build
// the grid, stride and anchor of each row and decode it.
//
// Exactness: the plain version (candidate_decode_plain in
// ops/cuda_kernels.py) decodes with separate PyTorch ops, each rounding
// once, so every step here is an explicitly rounded intrinsic in the same
// order, which nvcc does not contract into an FMA:
//   xy  = ((sig(x) * 2 - 0.5) + grid) * stride
//   wh  = (t * t) * anchor, t = sig(x) * 2     (ATen's x ** 2 is x * x)
//   lmk = x * anchor + grid * stride
//   sig(x) = 1 / (1 + expf(-x))               (ATen's CUDA sigmoid, IEEE /)
//   box = (cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5)
// (ATen divides by a scalar 2 as a multiply by 0.5, which is exact.)
// Indices outside [0, total rows) decode a zero row at grid (0, 0) with
// stride 0 and anchor (0, 0), as _candidate_grid_params gives them,
// instead of faulting.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 31 registers for f32
// maps, 28 for bf16, no shared memory, a 0-byte stack frame, no spills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxAnchors = 3;
constexpr int kThreads = 256;

// ops/cuda_kernels.py _decode_layout builds this (ctypes Layout)
struct DecodeLayout {
  int n_levels;
  int na;
  int rows[kMaxLevels];   // na * ny * nx
  int nx[kMaxLevels];
  int cells[kMaxLevels];  // ny * nx
  float stride[kMaxLevels];
  float anchor[kMaxLevels][kMaxAnchors][2];
};

struct Levels {
  const void* base[kMaxLevels];
};

// ATen's CUDA sigmoid for float: 1 / (1 + exp(-x)) with IEEE division
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// the 4 columns of piece `piece` of a raw row, as f32
template <bool kBf16>
__device__ __forceinline__ void load_piece(const void* row, int piece,
                                           float v[4]) {
  if (kBf16) {
    // bf16 -> f32 is exact: the bf16 bits are the f32's top half
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + piece);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f = __ldg(reinterpret_cast<const float4*>(row) + piece);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
candidate_decode_kernel(Levels lv, DecodeLayout lay,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ pred, float4* __restrict__ boxes,
                        bool* __restrict__ valid, int B, int K, int no,
                        float conf) {
  const int pieces = no / 4;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * K * pieces) return;
  const int row = t / pieces;
  const int piece = t - row * pieces;
  const int b = row / K;
  int r = __ldg(idx + row);

  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float gx = 0.0f, gy = 0.0f, s = 0.0f, aw = 0.0f, ah = 0.0f;
  bool found = false;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (!found && l < lay.n_levels) {
      if (r >= 0 && r < lay.rows[l]) {
        found = true;
        const int a = r / lay.cells[l];
        const int cell = r - a * lay.cells[l];
        const int cy = cell / lay.nx[l];
        gx = static_cast<float>(cell - cy * lay.nx[l]);
        gy = static_cast<float>(cy);
        s = lay.stride[l];
#pragma unroll
        for (int j = 0; j < kMaxAnchors; ++j) {
          if (a == j) {
            aw = lay.anchor[l][j][0];
            ah = lay.anchor[l][j][1];
          }
        }
        const size_t elt = kBf16 ? 2 : 4;
        const char* src = static_cast<const char*>(lv.base[l])
                          + ((size_t)b * lay.rows[l] + r) * no * elt;
        load_piece<kBf16>(src, piece, v);
      } else {
        r -= lay.rows[l];
      }
    }
  }

  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = piece * 4 + e;
    const float x = v[e];
    if (c < 2) {
      o[e] = __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(sigmoid(x), 2.0f), 0.5f),
                                 c == 0 ? gx : gy),
                       s);
    } else if (c < 4) {
      const float t2 = __fmul_rn(sigmoid(x), 2.0f);
      o[e] = __fmul_rn(__fmul_rn(t2, t2), c == 2 ? aw : ah);
    } else if (c == 4 || c >= 15) {
      o[e] = sigmoid(x);
    } else {
      const bool is_x = ((c - 5) & 1) == 0;
      o[e] = __fadd_rn(__fmul_rn(x, is_x ? aw : ah),
                       __fmul_rn(is_x ? gx : gy, s));
    }
  }
  reinterpret_cast<float4*>(pred + (size_t)row * no)[piece] =
      make_float4(o[0], o[1], o[2], o[3]);
  if (piece == 0) {
    const float hw = __fmul_rn(o[2], 0.5f), hh = __fmul_rn(o[3], 0.5f);
    boxes[row] = make_float4(__fsub_rn(o[0], hw), __fsub_rn(o[1], hh),
                             __fadd_rn(o[0], hw), __fadd_rn(o[1], hh));
  } else if (piece == 1) {
    valid[row] = o[0] >= conf;
  }
}

}  // namespace

// levels: layout->n_levels device pointers to [B, rows[l], no] raw maps,
// f32 (bf16 = 0) or bf16 (bf16 = 1), 16-byte aligned, no a multiple of 4
// and at least 16; layout: a host DecodeLayout; idx: [B, K] int32; pred:
// [B, K, no] f32; boxes: [B, K, 4] f32; valid: [B, K] bool.
extern "C" int candidate_decode_launch(const void* l0, const void* l1,
                                       const void* l2, const void* l3,
                                       const void* layout, int bf16,
                                       const void* idx, void* pred,
                                       void* boxes, void* valid, int B, int K,
                                       int no, float conf, void* stream) {
  const DecodeLayout* lay = static_cast<const DecodeLayout*>(layout);
  if (lay == nullptr || lay->n_levels < 1 || lay->n_levels > kMaxLevels
      || lay->na < 1 || lay->na > kMaxAnchors || no < 16 || no % 4)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  const long long threads = (long long)B * K * (no / 4);
  if (threads >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Levels lv = {{l0, l1, l2, l3}};
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    candidate_decode_kernel<true><<<blocks, kThreads, 0, s>>>(
        lv, *lay, static_cast<const int32_t*>(idx), static_cast<float*>(pred),
        static_cast<float4*>(boxes), static_cast<bool*>(valid), B, K, no,
        conf);
  } else {
    candidate_decode_kernel<false><<<blocks, kThreads, 0, s>>>(
        lv, *lay, static_cast<const int32_t*>(idx), static_cast<float*>(pred),
        static_cast<float4*>(boxes), static_cast<bool*>(valid), B, K, no,
        conf);
  }
  return (int)cudaGetLastError();
}
