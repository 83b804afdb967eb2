// Streaming inner-product top-k of [N, D] queries against an [M, D] gallery.
//
// Replaces topk_gallery_pallas / _topk_kernel
// (face_detection_and_recognition_tpu/ops/pallas_kernels.py:129-221). The TPU
// kernel kept the queries in VMEM, streamed the gallery through in blocks on
// its sequential grid and merged each block's [N, block_m] scores into a
// running [N, k] list with k rounds of masked argmax, so the [N, M] score
// matrix never reached HBM. GPU blocks run in parallel and carry nothing from
// one to the next, so here the work splits in two launches:
//
//   launch 1 (topk_partial_kernel): a grid over (64-query tile, gallery
//     chunk). Each CTA walks its chunk in 64-row tiles. For a tile it stages
//     32-wide slices of the query and gallery rows in shared memory, and each
//     of its 256 threads accumulates a 4 x 4 block of scores over d; the
//     64 x 64 tile of scores goes to shared memory, and four threads a query
//     fold it into four running top-k lists held in registers. At the end of
//     the chunk each thread writes its list: [N, chunks * 4, k] partials.
//   launch 2 (topk_merge_kernel): one thread a query folds its partials into
//     the final list.
//
// The order is (score descending, gallery index ascending): among equal
// scores the smaller index wins, so any merge order gives the Pallas kernel's
// answer, whose strict ">" never lets a later equal score displace a kept
// one. Empty slots hold (-1e30, -1) and a score must beat that to enter, as
// the Pallas kernel's -1e30 initial list and pad masking do; the merge
// writes an empty slot's index as 0 (the Pallas kernel's tail when M < k).
//
// Bound on the H100: 2 * N * M * D f32 operations on the CUDA cores (the JAX
// dot runs at Precision.HIGHEST, so no TF32 and no tensor cores). At the
// similarity path's shape (N 512, M 524,288, D 512) that is 2.75e11
// operations, 4.1 ms at 67 TFLOP/s; the gallery's 1.07 GB read once is
// 0.32 ms. So the operations bound it. Each score costs a __fmul_rn and a
// __fadd_rn, not one FMA, so this design reaches at most half that rate.
//
// Exactness: every score is sum_d q[n, d] * g[m, d] accumulated from 0 in
// order d = 0 .. D-1, each product and each sum rounded once
// (__fmul_rn / __fadd_rn, which nvcc does not contract into an FMA). The
// plain version in ops/cuda_kernels.py accumulates in the same order, so the
// two give the same scores bit for bit, and the same indices.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;      // the largest k the wrapper takes
constexpr int kTileQ = 64;     // queries of a CTA
constexpr int kTileM = 64;     // gallery rows of a tile
constexpr int kTileD = 32;     // depth of a staged slice
constexpr int kThreads = 256;  // 16 x 16, each 4 x 4 scores
constexpr int kListsPerQuery = kThreads / kTileQ;  // 4
constexpr float kEmpty = -1e30f;

// (s, i) ranks before (t, j)
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// A sorted list of kMaxK (score, index) pairs in registers, of which the
// first k are live. Every loop is unrolled, so the arrays stay in registers.
struct TopK {
  float s[kMaxK];
  int i[kMaxK];
  float last_s;  // the k-th entry: a candidate must rank before it
  int last_i;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      s[j] = kEmpty;
      i[j] = -1;
    }
    last_s = kEmpty;
    last_i = -1;
  }

  __device__ __forceinline__ void push(float cs, int ci, int k) {
    if (!better(cs, ci, last_s, last_i)) return;
    // carry the candidate down the list; what falls off the end is dropped
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k && better(cs, ci, s[j], i[j])) {
        const float ts = s[j];
        const int ti = i[j];
        s[j] = cs;
        i[j] = ci;
        cs = ts;
        ci = ti;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j == k - 1) {
        last_s = s[j];
        last_i = i[j];
      }
    }
  }

  __device__ __forceinline__ void store(float* out_s, int* out_i, int k) {
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        out_s[j] = s[j];
        out_i[j] = i[j];
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ g,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int N, int M, int D, int k, int tiles_per_chunk,
                    int n_parts) {
  // +1 column of padding: the compute loop reads a column across rows
  __shared__ float qs[kTileQ][kTileD + 1];
  __shared__ float gs[kTileM][kTileD + 1];
  __shared__ float sc[kTileQ][kTileM + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // gallery rows tx, tx + 16, tx + 32, tx + 48
  const int ty = tid / 16;  // queries ty, ty + 16, ...
  const int q0 = blockIdx.y * kTileQ;
  const int chunk = blockIdx.x;
  const int m_begin = chunk * tiles_per_chunk * kTileM;
  const int m_end = min(M, m_begin + tiles_per_chunk * kTileM);

  // the list this thread keeps: query tid / 4 of the tile, columns
  // (tid % 4) * 16 .. + 15 of every score tile
  const int lq = tid / kListsPerQuery;
  const int lpart = tid % kListsPerQuery;
  TopK top;
  top.init();

  for (int m0 = m_begin; m0 < m_end; m0 += kTileM) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += kTileD) {
      const int dn = min(kTileD, D - d0);
      // stage the slices: 64 rows x 32 columns each, coalesced along d
      for (int e = tid; e < kTileQ * kTileD; e += kThreads) {
        const int r = e / kTileD, c = e % kTileD;
        const int qr = q0 + r;
        qs[r][c] = (qr < N && c < dn) ? q[(size_t)qr * D + d0 + c] : 0.0f;
        const int gr = m0 + r;
        gs[r][c] = (gr < m_end && c < dn) ? g[(size_t)gr * D + d0 + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < dn; ++dd) {
        float qv[4], gv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = qs[ty + 16 * a][dd];
#pragma unroll
        for (int b = 0; b < 4; ++b) gv[b] = gs[tx + 16 * b][dd];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(qv[a], gv[b]));
      }
      __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[ty + 16 * a][tx + 16 * b] = acc[a][b];
    __syncthreads();
    const int cols = min(kTileM, m_end - m0);
    for (int c = lpart * 16; c < lpart * 16 + 16 && c < cols; ++c)
      top.push(sc[lq][c], m0 + c, k);
    __syncthreads();  // sc is written again by the next tile
  }

  const int qn = q0 + lq;
  if (qn < N) {
    const size_t off = ((size_t)qn * n_parts + chunk * kListsPerQuery + lpart)
                       * k;
    top.store(part_s + off, part_i + off, k);
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_i, int N, int k,
                                  int n_parts) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  TopK top;
  top.init();
  const size_t base = (size_t)n * n_parts * k;
  for (int e = 0; e < n_parts * k; ++e)
    top.push(part_s[base + e], part_i[base + e], k);
  // an empty slot reads (-1e30, 0), the Pallas kernel's tail when M < k
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (top.i[j] < 0) top.i[j] = 0;
  top.store(out_s + (size_t)n * k, out_i + (size_t)n * k, k);
}

}  // namespace

// part_s / part_i: [N, n_parts, k] scratch, n_parts = chunks * 4 with
// chunks = ceil(ceil(M / 64) / tiles_per_chunk), at least 1. out_s / out_i:
// [N, k] f32 / int32.
extern "C" int topk_gallery_launch(const void* q, const void* g,
                                   void* part_s, void* part_i, void* out_s,
                                   void* out_i, int N, int M, int D, int k,
                                   int tiles_per_chunk, void* stream) {
  if (N <= 0) return 0;
  if (k < 1 || k > kMaxK || M < 0 || D < 1 || tiles_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (M + kTileM - 1) / kTileM;
  const int chunks = tiles == 0 ? 1 : (tiles + tiles_per_chunk - 1)
                                          / tiles_per_chunk;
  const int n_parts = chunks * kListsPerQuery;
  dim3 grid1(chunks, (N + kTileQ - 1) / kTileQ);
  topk_partial_kernel<<<grid1, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(g),
      static_cast<float*>(part_s), static_cast<int*>(part_i), N, M, D, k,
      tiles_per_chunk, n_parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  topk_merge_kernel<<<(N + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), N, k, n_parts);
  return (int)cudaGetLastError();
}
