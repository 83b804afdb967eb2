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
//   launch 1 (topk_partial_kernel): a grid of (128-query tile, gallery
//     chunk) CTAs, the query tile the fast dimension, so the 4 query tiles
//     of a chunk run side by side and read the chunk through L2 once. The
//     host sizes the chunks so that the grid is two CTAs an SM, one wave.
//     Each CTA walks its chunk in 128-row tiles and keeps one top-k list a
//     query in shared memory. For a tile, each of its 256 threads (16 x 16)
//     accumulates an 8 x 8 block of scores in registers over D, from 8-deep
//     slices of the query and gallery rows staged depth-major in shared
//     memory: per step a thread reads two float4 of queries and two float4
//     of gallery rows (4 LDS.128) for 64 FMAs. The slices are loaded as
//     one float4 a thread a matrix from global memory and transposed
//     through registers into a double buffer, so the next slice's loads
//     are in flight while this one computes; one barrier a slice.
//     After the tile, every thread holds its scores against its queries'
//     current k-th entries (thresholds in shared memory); the few that
//     beat them go into the query's row of a shared candidate buffer and
//     set its bit in a per-query mask. Then one thread a query inserts its
//     flagged candidates into its list. After the first tile or two almost
//     no score passes, so the top-k costs little beside the FMAs. At the
//     end of the chunk each list goes out: [N, chunks, k] partials.
//   launch 2 (topk_merge_kernel): one thread a query folds its partials into
//     the final list (again in shared memory).
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
// 0.32 ms. So the operations bound it, and the design spends them as FMAs:
// 64 of them for every 4 shared-memory loads.
//
// Exactness: every score is the chain acc = fma(q[n, d], g[m, d], acc) from
// acc = 0 in order d = 0 .. D-1, each step rounded once (__fmaf_rn). The
// plain version in ops/cuda_kernels.py runs the same chain with a float32
// FMA emulated through float64 (_fma_f32), so the two give the same scores
// bit for bit, and the same indices.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the partial kernel uses
// 128 registers (the cap that __launch_bounds__(256, 2) sets), no spills,
// a 0-byte stack frame (the lists live in shared memory) and 102,400 bytes
// of dynamic shared memory, so two CTAs fit on an SM; the merge kernel 32
// registers, 16,384 bytes of shared memory, a 0-byte stack frame.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;                 // the largest k the wrapper takes
constexpr int kTile = 128;                // queries of a CTA, rows of a tile
constexpr int kDepth = 8;                 // depth of a staged slice
constexpr int kThreads = 256;             // 16 x 16, each 8 x 8 scores
constexpr int kStride = kTile + 4;        // padded row of a staged slice
constexpr int kTileStride = kTile + 1;    // padded row of the candidates
constexpr int kWords = kTile / 32;        // mask words a query
constexpr float kEmpty = -1e30f;
constexpr int kMaxDevices = 64;           // devices whose attributes are set

struct Smem {
  float qs[2][kDepth][kStride];   // query slices, depth-major, two buffers
  float gs[2][kDepth][kStride];   // gallery slices, likewise
  float cand[kTile][kTileStride]; // a tile's candidate scores, a row a query
  float list_s[kMaxK][kTile];     // each query's list, best first
  int list_i[kMaxK][kTile];
  float thr_s[kTile];             // each query's k-th entry
  int thr_i[kTile];
  unsigned mask[kTile][kWords];   // which columns of cand hold candidates
};

// (s, i) ranks before (t, j)
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Put (s, i), which ranks before entry k - 1, into the sorted list of
// query column q; entry k - 1 falls off.
__device__ __forceinline__ void insert(float (*ls)[kTile], int (*li)[kTile],
                                       int q, int k, float s, int i) {
  int j = k - 1;
  while (j > 0 && better(s, i, ls[j - 1][q], li[j - 1][q])) {
    ls[j][q] = ls[j - 1][q];
    li[j][q] = li[j - 1][q];
    --j;
  }
  ls[j][q] = s;
  li[j][q] = i;
}

// 4 floats of row `row` from column d, zero past rows_end or past D
__device__ __forceinline__ float4 load4(const float* __restrict__ base,
                                        int row, int rows_end, int D, int d,
                                        bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < rows_end) {
    const float* p = base + (size_t)row * D + d;
    if (vec && d < D) {  // D % 4 == 0 and 16-byte aligned rows
      v = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      if (d < D) v.x = __ldg(p);
      if (d + 1 < D) v.y = __ldg(p + 1);
      if (d + 2 < D) v.z = __ldg(p + 2);
      if (d + 3 < D) v.w = __ldg(p + 3);
    }
  }
  return v;
}

// store a thread's float4 (4 depths of one row) transposed: [depth][row]
__device__ __forceinline__ void store4(float (*dst)[kStride], int row,
                                       int d, float4 v) {
  dst[d][row] = v.x;
  dst[d + 1][row] = v.y;
  dst[d + 2][row] = v.z;
  dst[d + 3][row] = v.w;
}

__global__ void __launch_bounds__(kThreads, 2)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ g,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int N, int M, int D, int k, int tiles_per_chunk,
                    int n_parts, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // gallery columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;  // queries ty*4 .. +3 and 64 + ty*4 .. +3
  const int lr = tid / 2;   // the row this thread stages
  const int lc = (tid % 2) * 4;  // and its first depth in the slice
  const int q0 = blockIdx.x * kTile;
  const int chunk = blockIdx.y;
  const int m_begin = chunk * tiles_per_chunk * kTile;
  const int m_end = min(M, m_begin + tiles_per_chunk * kTile);
  const int n_slices = (D + kDepth - 1) / kDepth;

  if (tid < kTile) {
    for (int j = 0; j < k; ++j) {
      sm.list_s[j][tid] = kEmpty;
      sm.list_i[j][tid] = -1;
    }
    sm.thr_s[tid] = kEmpty;
    sm.thr_i[tid] = -1;
#pragma unroll
    for (int w = 0; w < kWords; ++w) sm.mask[tid][w] = 0u;
  }
  __syncthreads();

  for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    store4(sm.qs[0], lr, lc, load4(q, q0 + lr, N, D, lc, vec));
    store4(sm.gs[0], lr, lc, load4(g, m0 + lr, m_end, D, lc, vec));
    __syncthreads();
    for (int sl = 0; sl < n_slices; ++sl) {
      const int buf = sl & 1;
      const bool more = sl + 1 < n_slices;
      float4 qv, gv;
      if (more) {
        const int d = (sl + 1) * kDepth + lc;
        qv = load4(q, q0 + lr, N, D, d, vec);
        gv = load4(g, m0 + lr, m_end, D, d, vec);
      }
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&sm.qs[buf][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sm.qs[buf][kk][64 + ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&sm.gs[buf][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.gs[buf][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
      if (more) {
        store4(sm.qs[buf ^ 1], lr, lc, qv);
        store4(sm.gs[buf ^ 1], lr, lc, gv);
      }
      __syncthreads();
    }

    // flag the scores that beat their query's k-th entry
    const int cols = min(kTile, m_end - m0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      const float ts = sm.thr_s[r];
      const int ti = sm.thr_i[r];
      unsigned lo = 0u, hi = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
        if (c < cols && better(acc[i][j], m0 + c, ts, ti)) {
          sm.cand[r][c] = acc[i][j];
          if (j < 4)
            lo |= 1u << (c & 31);
          else
            hi |= 1u << (c & 31);
        }
      }
      if (lo) atomicOr(&sm.mask[r][(tx * 4) / 32], lo);
      if (hi) atomicOr(&sm.mask[r][(64 + tx * 4) / 32], hi);
    }
    __syncthreads();

    // one thread a query takes its flagged candidates, in column order;
    // the next tile's barriers order this before the next flagging
    if (tid < kTile) {
      float ts = sm.thr_s[tid];
      int ti = sm.thr_i[tid];
      for (int w = 0; w < kWords; ++w) {
        unsigned bits = sm.mask[tid][w];
        if (!bits) continue;
        sm.mask[tid][w] = 0u;
        while (bits) {
          const int c = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          const float s = sm.cand[tid][c];
          if (!better(s, m0 + c, ts, ti)) continue;  // the bar rose
          insert(sm.list_s, sm.list_i, tid, k, s, m0 + c);
          ts = sm.list_s[k - 1][tid];
          ti = sm.list_i[k - 1][tid];
        }
      }
      sm.thr_s[tid] = ts;
      sm.thr_i[tid] = ti;
    }
  }

  if (tid < kTile && q0 + tid < N) {
    const size_t off = ((size_t)(q0 + tid) * n_parts + chunk) * k;
    for (int j = 0; j < k; ++j) {
      part_s[off + j] = sm.list_s[j][tid];
      part_i[off + j] = sm.list_i[j][tid];
    }
  }
}

__global__ void __launch_bounds__(kTile)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, float* __restrict__ out_s,
                  int* __restrict__ out_i, int N, int k, int n_parts) {
  __shared__ float ls[kMaxK][kTile];
  __shared__ int li[kMaxK][kTile];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kTile + t;
  if (n >= N) return;
  for (int j = 0; j < k; ++j) {
    ls[j][t] = kEmpty;
    li[j][t] = -1;
  }
  float ts = kEmpty;
  int ti = -1;
  const size_t base = (size_t)n * n_parts * k;
  for (int e = 0; e < n_parts * k; ++e) {
    const float s = part_s[base + e];
    const int i = part_i[base + e];
    if (!better(s, i, ts, ti)) continue;
    insert(ls, li, t, k, s, i);
    ts = ls[k - 1][t];
    ti = li[k - 1][t];
  }
  // an empty slot reads (-1e30, 0), the Pallas kernel's tail when M < k
  for (int j = 0; j < k; ++j) {
    out_s[(size_t)n * k + j] = ls[j][t];
    out_i[(size_t)n * k + j] = li[j][t] < 0 ? 0 : li[j][t];
  }
}

}  // namespace

// part_s / part_i: [N, n_parts, k] scratch, n_parts = chunks =
// ceil(ceil(M / 128) / tiles_per_chunk), at least 1. out_s / out_i: [N, k]
// f32 / int32.
extern "C" int topk_gallery_launch(const void* q, const void* g,
                                   void* part_s, void* part_i, void* out_s,
                                   void* out_i, int N, int M, int D, int k,
                                   int tiles_per_chunk, void* stream) {
  if (N <= 0) return 0;
  if (k < 1 || k > kMaxK || M < 0 || D < 1 || tiles_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = (int)sizeof(Smem);
  // once a device: the dynamic shared memory above 48 KB, and the most
  // shared memory an SM can give, so that two CTAs fit on one
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(topk_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          topk_partial_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int tiles = (M + kTile - 1) / kTile;
  const int chunks = tiles == 0 ? 1 : (tiles + tiles_per_chunk - 1)
                                          / tiles_per_chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
                  && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  dim3 grid1((N + kTile - 1) / kTile, chunks);
  topk_partial_kernel<<<grid1, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(g),
      static_cast<float*>(part_s), static_cast<int*>(part_i), N, M, D, k,
      tiles_per_chunk, chunks, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(N + kTile - 1) / kTile, kTile, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), N, k, chunks);
  return (int)cudaGetLastError();
}
