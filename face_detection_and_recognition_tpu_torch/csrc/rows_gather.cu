// Candidate-row gather across detect levels:
//   out[b, k, :] = concat(levels, axis=1)[b, idx[b, k], :]
// for 16-wide rows, without building the concat.
//
// Replaces candidate_rows_gather_pallas / _rows_gather_kernel
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:507-613). On the
// TPU a row gather at these shapes was latency-bound, so that kernel streamed
// every level through the MXU as a one-hot GEMM, and it was exact only for
// bf16 rows (an f32 one-hot dot is a multi-pass MXU product); the JAX detect
// path therefore took it for bf16 rows alone (models/yolov5_face.py:498-500).
// That restriction came from the MXU, not from the function: here a gather
// is a plain copy, exact for every dtype, so the wrapper takes this kernel for
// f32 maps too.
//
// One thread copies one row in 16-byte pieces: a 16-wide f32 row is 4 of
// them (64 bytes), a bf16 row 2. Bound on the H100: the bytes of the
// selected rows, the indices and the output, at 3.35 TB/s; at B*K = 8192
// rows that is about a megabyte, so the launch itself dominates. Indices
// outside [0, total rows) produce zero rows instead of a fault.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  const uint4* base[kMaxLevels];
  int rows[kMaxLevels];
  int n;
};

__global__ void rows_gather_kernel(Levels lv, const int32_t* __restrict__ idx,
                                   uint4* __restrict__ out, int B, int K,
                                   int chunks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * K) return;
  const int b = t / K;
  int r = idx[t];
  const uint4* src = nullptr;
  for (int l = 0; l < lv.n; ++l) {
    if (r >= 0 && r < lv.rows[l]) {
      src = lv.base[l] + ((size_t)b * lv.rows[l] + r) * chunks;
      break;
    }
    r -= lv.rows[l];
  }
  uint4* dst = out + (size_t)t * chunks;
  for (int c = 0; c < chunks; ++c) dst[c] = src ? src[c] : make_uint4(0, 0, 0, 0);
}

}  // namespace

// levels: n_levels device pointers to [B, rows[l], row] arrays whose rows are
// row_chunks * 16 bytes, 16-byte aligned; idx: [B, K] int32; out: [B, K, row].
extern "C" int rows_gather_launch(const void* l0, const void* l1,
                                  const void* l2, const void* l3, int n0,
                                  int n1, int n2, int n3, int n_levels,
                                  const void* idx, void* out, int B, int K,
                                  int row_chunks, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || row_chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  Levels lv;
  const void* bases[kMaxLevels] = {l0, l1, l2, l3};
  const int rows[kMaxLevels] = {n0, n1, n2, n3};
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.base[l] = static_cast<const uint4*>(bases[l]);
    lv.rows[l] = rows[l];
  }
  lv.n = n_levels;
  const int threads = 256;
  const int blocks = (B * K + threads - 1) / threads;
  rows_gather_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const int32_t*>(idx), static_cast<uint4*>(out), B, K,
      row_chunks);
  return (int)cudaGetLastError();
}
