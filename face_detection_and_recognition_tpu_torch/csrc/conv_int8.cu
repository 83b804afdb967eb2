// Q1: the int8 convolution of a quantized ConvBN (yolov5-face int8).
//
// Replaces no Pallas kernel: the JAX package's quantized ConvBN
// (models/layers.py:80-106) convolves its int8 codes with
// lax.conv_general_dilated(int8, int8, preferred_element_type=int32),
// which XLA lowers itself. PyTorch has no int8 x int8 -> int32 convolution
// on CUDA, and an f32 convolution of the codes is not exact (a 3x3 layer
// over 256 channels sums up to 2304 * 127^2 > 2^24), so the port carries
// its own. The function is that of ops/int8_conv.conv_int8_plain:
//
//   s    = max(absmax(x), 1e-6) * f32(1/127)  (dynamic) or ascale (static)
//   xq   = clamp(rint(x / s), -127, 127)                      int8 codes
//   acc  = sum over taps and channels of xq * w                int32, exact
//   pre  = fma(float(acc), s * wscale[co], bias[co])           one rounding
//   out  = pre * (1 / (1 + expf(-pre))) (SiLU, JAX's form) or pre
//
// What bounds it on an H100. At yolov5n / yolov5s widths a call does a few
// G int8 operations (1979 TOPS on the tensor cores) but moves its f32 input
// and its f32 output through device memory: the stem reads 39 MB and
// writes 105 MB at B = 8, 640x640. So Q1 is bound by bytes, and by the
// launches and host work of ~80 calls a forward. The design reads each
// input once, keeps the codes out of device memory and writes each output
// once, in few launches:
//
//   dynamic mode: two launches on the caller's stream, no host sync.
//     (a) absmax_kernel: a partial absmax per block, 16-byte loads, four
//         in flight a thread;
//     (b) the convolution. Each of its blocks reduces the partials to s
//         itself (the max is exact in any order).
//   static mode: one launch, (b) with s = *ascale.
//   No int8 scratch: the convolution quantizes as it loads. Its A loader
//   reads x in f32 with 16-byte loads (4 channels of one tap), computes
//   the codes and packs them into shared memory as 4-code words. An IEEE
//   division a code set the pace of the fused loader (measured on an
//   H100 against this loader): a code is the product with RN(1 / s), and a
//   thread's words of a step are made again with the IEEE division only
//   where a product lies within 2^-14 of a half-integer (pack4_fast),
//   which gives the division's integers exactly.
//
// (b), groups == 1, conv_mma_kernel: an implicit GEMM, M = output pixels,
// N = C_out, K = k * k * C4 codes, tap-major ((ky, kx), then channels),
// C4 = C_in rounded up to 4. The products run on the int8 tensor cores,
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, fragments loaded with
// ldmatrix from 80-byte shared rows (64 codes + 16 pad: the 8 rows of an
// ldmatrix phase hit 8 disjoint bank quads). mma.sync and not wgmma: the
// kernel is bound by bytes, far from the tensor cores' rate, and the
// narrow layers (C_out 12-64) want tiles smaller than wgmma's 64-row
// warpgroup; mma.sync needs no shared-memory descriptors and takes its A
// fragments from the same tiles the quantizing loader writes.
//   - Tiles: 8 warps, each 16 * MT rows x 8 * NT columns. The host picks
//     the N tile to cover C_out where C_out <= 256 (16, 32, 64, 128, 192,
//     256), so each code tile is read once; above that, the tile of 128,
//     192 or 256 that wastes least. The M tile (32-128 rows) is the larger
//     one that still gives >= 2 tiles an SM. The grid is what the card
//     holds at once (the occupancy API), and each block walks its share
//     of the tiles: a wide layer (819,200 rows at the stem) is 6400 tiles
//     of a few microseconds each, so one tile's epilogue and stores
//     overlap the next tile's loads instead of ending a short block.
//   - The K loop has no division: each block first writes a table of its
//     K words (the word's channel offset from the tap origin, ky, kx, and
//     its real channels), so a step reads one table entry and a row's
//     bounds test is two compares. Words past k * k * C4 read as zero
//     codes. C_in % 4 != 0 (the stem's 3 channels) takes the same path:
//     the word's missing channels load as 0.0, code 0, and the packed
//     weights (ops/int8_conv.pack_kernel_q, OHWI4 rows padded to 64
//     codes) hold zero codes there, so they add nothing to the sums.
//   - Pipeline: two shared stages of 64 codes over the block's (tile,
//     stage) steps. The weights' next step is in flight by cp.async
//     (zero-filled past C_out), and the A loader has the next step's
//     floats in registers, while the warps run this step's MMAs and, at a
//     tile's last stage, its epilogue; then the next codes are stored and
//     one barrier closes the step. Words past K store zero codes.
//   - Epilogue: each fragment's sums are dequantized, biased and passed
//     through SiLU in registers and staged as f32 in shared memory; the
//     block then writes its rows with 16-byte stores: as one contiguous
//     span when the N tile covers C_out (the NHWC rows of the tile are
//     adjacent), row by row otherwise.
//
// (b), groups == C_in == C_out (the ShuffleV2 depthwise layers),
// conv_dw_kernel: no GEMM, CUDA cores. A block takes an 8 x 8 output tile
// of 16 channels: it quantizes the input patch it needs ((8 - 1) * stride
// + k square) into shared memory once, 4 channels a word from 16-byte
// loads, with the tile's k x k weights; a thread then sums the k x k taps
// of one pixel for 4 channels and writes them with one 16-byte store.
//
// The epilogue is written with explicit roundings (__fmul_rn, __fmaf_rn,
// __fdiv_rn, __frcp_rn, __float2int_rn) so that nvcc's FMA contraction
// cannot change a value: int32 addition is exact in any order, so the
// pre-activation equals the plain version bit for bit for any tiling, and
// SiLU differs from it only where expf differs from PyTorch's exp on the
// card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;            // codes of K a pipeline stage
constexpr int kWords = kBK / 4;    // 4-code words a stage
constexpr int kRow = kBK + 16;     // bytes of a shared A or B row
constexpr int kDwTile = 8;         // depthwise output tile side
constexpr int kDwChans = 16;       // depthwise channels a block
// dynamic shared memory a block may ask for: the 227 KB opt-in less a
// margin for the kernels' static shared memory
constexpr int kMaxSmem = 226 * 1024;
constexpr float kRecip127 = 1.0f / 127.0f;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kThreads / 32) ? red[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;  // every thread of the block holds the maximum
}

// the activation scale: the static one, or the reduction of the absmax
// pass's partials (every block does it; the max is exact in any order)
__device__ __forceinline__ float act_scale(const float* __restrict__ ascale,
                                           const float* __restrict__ partial,
                                           int nparts, float* red) {
  if (ascale != nullptr) return __ldg(ascale);
  float m = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += kThreads)
    m = fmaxf(m, partial[i]);
  m = block_max(m, red);
  return __fmul_rn(fmaxf(m, 1e-6f), kRecip127);
}

__device__ __forceinline__ float amax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// x: P pixels of C channels, xp floats apart (xp == C: dense), 16-byte
// aligned, and C and xp multiples of 4 where xp != C; partial[blockIdx.x]
// = max |x| over the block's share
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long P, int C, int xp,
              float* __restrict__ partial) {
  __shared__ float red[kThreads / 32];
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float m = 0.0f;
  if (xp == C) {
    const long long n = P * C, n4 = n >> 2;
    const long long step = (long long)gridDim.x * kThreads;
    long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    for (; i + 3 * step < n4; i += 4 * step) {
      const float4 a = __ldg(x4 + i), b = __ldg(x4 + i + step),
                   c = __ldg(x4 + i + 2 * step),
                   d = __ldg(x4 + i + 3 * step);
      m = fmaxf(m,
                fmaxf(fmaxf(amax4(a), amax4(b)), fmaxf(amax4(c), amax4(d))));
    }
    for (; i < n4; i += step) m = fmaxf(m, amax4(__ldg(x4 + i)));
    if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4)
      m = fmaxf(m, fabsf(x[4 * n4 + threadIdx.x]));
  } else {
    // rows of C / 4 words: a pass of the block covers `per` rows
    const int cq = C >> 2, xq = xp >> 2;
    const int per = cq < kThreads ? kThreads / cq : 1;
    const int r = cq < kThreads ? threadIdx.x / cq : 0;
    const int w0 = cq < kThreads ? threadIdx.x - r * cq : threadIdx.x;
    if (r < per)
      for (long long p = (long long)blockIdx.x * per + r; p < P;
           p += (long long)gridDim.x * per)
        for (int w = w0; w < cq; w += kThreads)
          m = fmaxf(m, amax4(__ldg(x4 + p * xq + w)));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__device__ __forceinline__ int clamp127(float q) {
  return min(127, max(-127, __float2int_rn(q)));
}

// four codes clamp(rint(v / s), -127, 127), v / s the IEEE quotient,
// channel order from the low byte
__device__ __forceinline__ int pack4_exact(float4 v, float s) {
  return (clamp127(__fdiv_rn(v.x, s)) & 0xff) |
         ((clamp127(__fdiv_rn(v.y, s)) & 0xff) << 8) |
         ((clamp127(__fdiv_rn(v.z, s)) & 0xff) << 16) |
         (clamp127(__fdiv_rn(v.w, s)) << 24);
}

// The same four codes from the products with rs = RN(1 / s). q = RN(v *
// rs) is within 2^-15 of RN(v / s) wherever |v / s| < 128 (two roundings
// and rs's, <= 2^-23 relative), so both round to the same integer unless
// a half-integer lies within 2^-14 of q; past 128 both clamp to 127, and
// NaN and infinity give what the division gives. Returns false, leaving
// the word to pack4_exact, where one of the four is that near a tie
// (about one value in 8000).
__device__ __forceinline__ bool pack4_fast(float4 v, float rs, int& word) {
  const float q[4] = {__fmul_rn(v.x, rs), __fmul_rn(v.y, rs),
                      __fmul_rn(v.z, rs), __fmul_rn(v.w, rs)};
  bool ok = true;
  word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float n = rintf(q[i]);
    ok &= !(fabsf(__fsub_rn(q[i], n)) >= 0.5f - 0x1p-14f);
    word |= (min(127, max(-127, __float2int_rn(n))) & 0xff) << (8 * i);
  }
  return ok;
}

// The activation scale s, its reciprocal, and whether the products may
// stand in for the division (both normal floats).
struct Scale {
  float s, rs;
  bool fast;
};

__device__ __forceinline__ Scale make_scale(float s) {
  const float a = fabsf(s);
  return Scale{s, __frcp_rn(s), a >= 0x1p-125f && a <= 0x1p125f};
}

// up to 4 channels of one pixel: a 16-byte load when vec (C and the pixel
// stride multiples of 4), else the real ones (nval) with zeros after them
__device__ __forceinline__ float4 load4(const float* p, bool vec, int nval) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v.x = __ldg(p);
  if (nval > 1) v.y = __ldg(p + 1);
  if (nval > 2) v.z = __ldg(p + 2);
  if (nval > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ float epilogue(int acc, float ss, float b,
                                          int act) {
  const float pre = __fmaf_rn(__int2float_rn(acc), ss, b);
  return act ? __fmul_rn(pre, __frcp_rn(__fadd_rn(1.0f, expf(-pre)))) : pre;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// implicit GEMM for groups == 1. x: [B, H, W, C] f32; w: [C_out, kpad]
// int8, row n the OHWI4 codes of output channel n, zero past k * k * C4;
// out: [B, Ho, Wo, C_out] f32. A block walks the output tiles blockIdx.x,
// + gridDim.x, ... (tile t: M tile t / ntn, N tile t % ntn), its (tile,
// stage) steps in one pipeline: the next step's loads are in flight while
// this one's MMAs and, at a tile's last stage, its epilogue run.
template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(kThreads)
conv_mma_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                int kpad, const float* __restrict__ wscale,
                const float* __restrict__ bias,
                const float* __restrict__ ascale,
                const float* __restrict__ partial, int nparts,
                float* __restrict__ out, int B, int H, int W, int C, int xp,
                int Cout, int k, int stride, int pad, int Ho, int Wo,
                int act, int ntn, int ntiles) {
  static_assert(WM * WN * 32 == kThreads, "8 warps a block");
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  constexpr int RSTEP = kThreads / kWords;  // rows a pass of the loader
  constexpr int ROWS = BM / RSTEP;          // A rows a thread loads
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                            // [2][BM][kRow]
  unsigned char* Bs = As + 2 * BM * kRow;              // [2][BN][kRow]
  float* Cs = reinterpret_cast<float*>(Bs + 2 * BN * kRow);  // [BM][BN]
  int4* tab = reinterpret_cast<int4*>(Cs + BM * BN);   // [kpad / 4]
  __shared__ float red[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = B * Ho * Wo;
  const int C4 = (C + 3) & ~3;
  const int kwords = k * k * C4 / 4;
  const int nst = kpad / kBK;
  const bool vec = ((C | xp) & 3) == 0;

  // the K words, once a block: {offset of the word's channels from the
  // tap origin, ky, kx, real channels}; past K: no channels, and a ky out
  // of every frame
  for (int wd = tid; wd < nst * kWords; wd += kThreads) {
    int4 e = make_int4(0, 1 << 28, 0, 0);
    if (wd < kwords) {
      const int kb = wd * 4, tap = kb / C4, ci = kb - tap * C4;
      const int ky = tap / k, kx = tap - ky * k;
      e = make_int4((ky * W + kx) * xp + ci, ky, kx, min(4, C - ci));
    }
    tab[wd] = e;
  }
  __syncthreads();  // the table
  const float s = act_scale(ascale, partial, nparts, red);
  const Scale sc = make_scale(s);

  // the loader's rows (word column j of rows r0 + RSTEP i of the tile):
  // the pixel offset of the tap origin and its corner; a row past M fails
  // every bounds test
  const int j = tid & (kWords - 1), r0 = tid / kWords;
  int a_pix[ROWS], a_iy[ROWS], a_ix[ROWS];
  auto set_rows = [&](int m0) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + r0 + RSTEP * i;
      if (m < M) {
        const int ox = m % Wo, t = m / Wo, oy = t % Ho, b = t / Ho;
        a_iy[i] = oy * stride - pad;
        a_ix[i] = ox * stride - pad;
        a_pix[i] = ((b * H + a_iy[i]) * W + a_ix[i]) * xp;
      } else {
        a_iy[i] = -(1 << 29);
        a_ix[i] = 0;
        a_pix[i] = 0;
      }
    }
  };

  float4 areg[ROWS];
  bool a_live = false;  // the loaded word holds channels
  auto load_a = [&](int st) {
    const int4 e = tab[st * kWords + j];
    a_live = e.w > 0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int iy = a_iy[i] + e.y, ix = a_ix[i] + e.z;
      areg[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if ((unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W)
        areg[i] = load4(x + (a_pix[i] + e.x), vec, e.w);
    }
  };
  auto store_a = [&](int buf) {
    unsigned char* base = As + buf * BM * kRow + j * 4;
    int words[ROWS];
    bool ok = sc.fast;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) ok &= pack4_fast(areg[i], sc.rs, words[i]);
    if (!ok) {  // rare: a value near a tie, or a scale out of range
#pragma unroll
      for (int i = 0; i < ROWS; ++i) words[i] = pack4_exact(areg[i], sc.s);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      *reinterpret_cast<int*>(base + (r0 + RSTEP * i) * kRow) =
          a_live ? words[i] : 0;
  };
  auto issue_b = [&](int n0, int st, int buf) {
    unsigned char* base = Bs + buf * BN * kRow;
    for (int c = tid; c < BN * (kBK / 16); c += kThreads) {
      const int row = c >> 2, part = c & 3, n = n0 + row;
      const int8_t* src =
          w + (size_t)min(n, Cout - 1) * kpad + st * kBK + part * 16;
      cp_async16(base + row * kRow + part * 16, src, n < Cout ? 16 : 0);
    }
    cp_async_commit();
  };

  int acc[MT][NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
  };

  const int wm = warp / WN, wn = warp % WN;
  auto mma_stage = [&](int buf) {
    const unsigned char* a_s = As + buf * BM * kRow;
    const unsigned char* b_s = Bs + buf * BN * kRow;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // lanes 8i..8i+7 address matrix i: rows +8 for odd i, k +16 for
        // i >= 2 -> a0..a3 of the m16n8k32 A fragment
        const int row = wm * 16 * MT + mt * 16 + ((lane >> 3) & 1) * 8 +
                        (lane & 7);
        ldmatrix_x4(af[mt], a_s + row * kRow + kk * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // matrices (nt, k lo), (nt, k hi), (nt + 1, k lo), (nt + 1, k hi)
        const int row = wn * 8 * NT + nt * 8 + (lane >> 4) * 8 + (lane & 7);
        uint32_t r[4];
        ldmatrix_x4(r, b_s + row * kRow + kk * 32 + ((lane >> 3) & 1) * 16);
        bf[nt][0] = r[0];
        bf[nt][1] = r[1];
        bf[nt + 1][0] = r[2];
        bf[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  };

  // dequantize + bias + activation in registers, staged as f32 rows of the
  // tile's real width, then 16-byte stores
  const int g = lane >> 2, t4 = lane & 3;
  auto epilogue_tile = [&](int m0, int n0) {
    const int bn_eff = min(BN, Cout - n0), rows_eff = min(BM, M - m0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = wn * 8 * NT + nt * 8 + t4 * 2 + h;
        if (c < bn_eff) {
          const float ss = __fmul_rn(s, __ldg(wscale + n0 + c));
          const float bb = __ldg(bias + n0 + c);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int row = wm * 16 * MT + mt * 16 + g;
            Cs[row * bn_eff + c] = epilogue(acc[mt][nt][h], ss, bb, act);
            Cs[(row + 8) * bn_eff + c] =
                epilogue(acc[mt][nt][2 + h], ss, bb, act);
          }
        }
      }
    }
    __syncthreads();
    if (bn_eff == Cout) {
      // the tile's rows are adjacent in NHWC: one contiguous span
      float* dst = out + (size_t)m0 * Cout;
      const int n = rows_eff * Cout, n4 = n >> 2;
      for (int i = tid; i < n4; i += kThreads)
        reinterpret_cast<float4*>(dst)[i] =
            reinterpret_cast<const float4*>(Cs)[i];
      for (int i = 4 * n4 + tid; i < n; i += kThreads) dst[i] = Cs[i];
    } else {
      const bool v4 = ((Cout | bn_eff) & 3) == 0;
      for (int r = warp; r < rows_eff; r += kThreads / 32) {
        float* dst = out + (size_t)(m0 + r) * Cout + n0;
        const float* src = Cs + r * bn_eff;
        if (v4) {
          for (int c = lane * 4; c < bn_eff; c += 128)
            *reinterpret_cast<float4*>(dst + c) =
                *reinterpret_cast<const float4*>(src + c);
        } else {
          for (int c = lane; c < bn_eff; c += 32) dst[c] = src[c];
        }
      }
    }
  };

  // the pipeline over this block's (tile, stage) steps; (lt, lst) is the
  // loader's step, one ahead of the MMAs' (ct, cst)
  const int mine = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const int total = mine * nst;
  int lt = blockIdx.x, lst = 0;
  int lm0 = (lt / ntn) * BM, ln0 = (lt - (lt / ntn) * ntn) * BN;
  int cm0 = lm0, cn0 = ln0, cst = 0;
  set_rows(lm0);
  zero_acc();
  issue_b(ln0, 0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < total;
    if (more) {
      if (++lst == nst) {  // the loader moves to its next tile
        lst = 0;
        lt += gridDim.x;
        lm0 = (lt / ntn) * BM;
        ln0 = (lt - (lt / ntn) * ntn) * BN;
        set_rows(lm0);
      }
      issue_b(ln0, lst, buf ^ 1);
      load_a(lst);
    }
    mma_stage(buf);
    if (++cst == nst) {  // the tile's last stage
      epilogue_tile(cm0, cn0);
      zero_acc();
      cst = 0;
      cm0 = lm0;
      cn0 = ln0;
    }
    if (more) {
      store_a(buf ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
}

// depthwise: groups == C == C_out. w: [k * k, C4] int8 (tap-major, the
// channels of a tap adjacent, zero past C). A block: an 8 x 8 output tile
// of 16 channels; a thread: one pixel, 4 channels.
__global__ void __launch_bounds__(kThreads)
conv_dw_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ wscale,
               const float* __restrict__ bias,
               const float* __restrict__ ascale,
               const float* __restrict__ partial, int nparts,
               float* __restrict__ out, int B, int H, int W, int C, int xp,
               int k, int stride, int pad, int Ho, int Wo, int act) {
  extern __shared__ __align__(16) int dsm[];
  __shared__ float red[kThreads / 32];
  const int PW = (kDwTile - 1) * stride + k;  // the input patch's side
  int* patch = dsm;                           // [PW * PW][4] 4-code words
  int* wt = dsm + PW * PW * 4;                // [k * k][4]
  const int tiles_x = (Wo + kDwTile - 1) / kDwTile;
  const int oy0 = (blockIdx.x / tiles_x) * kDwTile;
  const int ox0 = (blockIdx.x % tiles_x) * kDwTile;
  const int c0 = blockIdx.y * kDwChans, b = blockIdx.z;
  const int C4 = (C + 3) & ~3;
  const bool vec = ((C | xp) & 3) == 0;
  const float s = act_scale(ascale, partial, nparts, red);
  const Scale sc = make_scale(s);

  const int iy0 = oy0 * stride - pad, ix0 = ox0 * stride - pad;
  for (int i = threadIdx.x; i < PW * PW * 4; i += kThreads) {
    const int gq = i & 3, p = i >> 2, py = p / PW, px = p - py * PW;
    const int iy = iy0 + py, ix = ix0 + px, c = c0 + gq * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if ((unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W && c < C)
      v = load4(x + (((size_t)b * H + iy) * W + ix) * xp + c, vec,
                min(4, C - c));
    int word;
    if (!(sc.fast && pack4_fast(v, sc.rs, word))) word = pack4_exact(v, s);
    patch[i] = word;
  }
  for (int i = threadIdx.x; i < k * k * 4; i += kThreads) {
    const int gq = i & 3, tap = i >> 2, c = c0 + gq * 4;
    wt[i] = c < C4 ? __ldg(reinterpret_cast<const int*>(
                         w + (size_t)tap * C4 + c))
                   : 0;
  }
  __syncthreads();

  const int gq = threadIdx.x & 3, p = threadIdx.x >> 2;
  const int ly = p / kDwTile, lx = p % kDwTile;
  const int oy = oy0 + ly, ox = ox0 + lx, c = c0 + gq * 4;
  if (oy >= Ho || ox >= Wo || c >= C) return;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int ky = 0; ky < k; ++ky) {
    const int* prow = patch + ((ly * stride + ky) * PW + lx * stride) * 4 + gq;
    const int* wrow = wt + ky * k * 4 + gq;
    for (int kx = 0; kx < k; ++kx) {
      const int v = prow[kx * 4], q = wrow[kx * 4];
      a0 += (int)(int8_t)v * (int)(int8_t)q;
      a1 += (int)(int8_t)(v >> 8) * (int)(int8_t)(q >> 8);
      a2 += (int)(int8_t)(v >> 16) * (int)(int8_t)(q >> 16);
      a3 += (v >> 24) * (q >> 24);
    }
  }
  float* dst = out + (((size_t)b * Ho + oy) * Wo + ox) * C + c;
  const int acc[4] = {a0, a1, a2, a3};
  float o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = c + q < C ? epilogue(acc[q], __fmul_rn(s, __ldg(wscale + c + q)),
                                __ldg(bias + c + q), act)
                     : 0.0f;
  if ((C & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    for (int q = 0; q < 4 && c + q < C; ++q) dst[q] = o[q];
  }
}

struct Args {
  const float* x;
  const int8_t* w;
  int kpad;
  const float* wscale;
  const float* bias;
  const float* ascale;
  const float* partial;
  int nparts;
  float* out;
  int B, H, W, C, xp, Cout, k, stride, pad, Ho, Wo, act;
};

// raise a kernel's dynamic shared memory limit to smem where it is above
// the default 48 KB (the limit each kernel has been given, kept per kernel)
template <auto Kernel>
int allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  allowed = smem;
  return 0;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int WM, int WN, int MT, int NT>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  const size_t smem = (size_t)(2 * BM + 2 * BN) * kRow +
                      (size_t)BM * BN * sizeof(float) +
                      (size_t)(a.kpad / 4) * sizeof(int4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = allow_smem<conv_mma_kernel<WM, WN, MT, NT>>(smem);
  if (err != 0) return err;
  // blocks an SM holds at this shared memory size, asked once a size
  // (a kernel meets a few: the K table's size varies by layer)
  static size_t seen_smem[8] = {0};
  static int seen_per_sm[8] = {0};
  static int next_slot = 0;
  int per_sm = 0;
  for (int i = 0; i < 8 && per_sm == 0; ++i)
    if (seen_smem[i] == smem) per_sm = seen_per_sm[i];
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv_mma_kernel<WM, WN, MT, NT>, kThreads, smem);
    const int slot = next_slot++ & 7;
    seen_per_sm[slot] = per_sm;
    seen_smem[slot] = smem;
  }
  const int M = a.B * a.Ho * a.Wo;
  const int ntn = (a.Cout + BN - 1) / BN;
  const int ntiles = (M + BM - 1) / BM * ntn;
  const int resident = (per_sm > 0 ? per_sm : 1) * sm_count();
  const int grid = ntiles < resident ? ntiles : resident;
  conv_mma_kernel<WM, WN, MT, NT><<<grid, kThreads, smem, stream>>>(
      a.x, a.w, a.kpad, a.wscale, a.bias, a.ascale, a.partial, a.nparts,
      a.out, a.B, a.H, a.W, a.C, a.xp, a.Cout, a.k, a.stride, a.pad, a.Ho,
      a.Wo, a.act, ntn, ntiles);
  return 0;
}

// the larger M tile where it still leaves >= 2 blocks an SM of 132
bool big_m(int M, int bm_big, int ntiles) {
  return (long long)((M + bm_big - 1) / bm_big) * ntiles >= 2 * 132;
}

int launch_dense(const Args& a, cudaStream_t stream) {
  const int M = a.B * a.Ho * a.Wo, n = a.Cout;
  if (n <= 16) return launch_mma<8, 1, 1, 2>(a, stream);
  if (n <= 32) return launch_mma<8, 1, 1, 4>(a, stream);
  if (n <= 64)
    return big_m(M, 128, 1) ? launch_mma<4, 2, 2, 4>(a, stream)
                            : launch_mma<4, 2, 1, 4>(a, stream);
  // one N tile up to 256 columns; above, the tile of 128 / 192 / 256 that
  // pads C_out least (ties: the wider)
  int bn = n <= 128 ? 128 : n <= 192 ? 192 : 256;
  if (n > 256) {
    const int cands[3] = {256, 192, 128};
    int best = 0;
    for (int cand : cands) {
      const int padded = (n + cand - 1) / cand * cand;
      if (best == 0 || padded < best) {
        best = padded;
        bn = cand;
      }
    }
  }
  const int ntiles = (n + bn - 1) / bn;
  const bool big = big_m(M, 64, ntiles);
  if (bn == 128)
    return big ? launch_mma<2, 4, 2, 4>(a, stream)
               : launch_mma<2, 4, 1, 4>(a, stream);
  if (bn == 192)
    return big ? launch_mma<2, 4, 2, 6>(a, stream)
               : launch_mma<2, 4, 1, 6>(a, stream);
  return big ? launch_mma<2, 4, 2, 8>(a, stream)
             : launch_mma<2, 4, 1, 8>(a, stream);
}

}  // namespace

// One layer's static arguments, filled once by the caller (ctypes) and
// read on the host at each launch. w: groups == 1, [C_out, kpad] int8
// (ops/int8_conv.pack_kernel_q: OHWI4 rows, kpad a multiple of 64);
// groups == C == C_out, [k * k, C4] (kpad 0). ascale: a device scalar
// (static mode) or null (dynamic).
struct Q1Layer {
  const int8_t* w;
  const float* wscale;
  const float* bias;
  const float* ascale;
  int kpad, C, Cout, k, stride, pad, groups, act;
};

// x: [B, H, W, C] f32 NHWC, pixels xp >= C floats apart (xp == C: dense;
// else C and xp multiples of 4), 16-byte aligned; out: [B, Ho, Wo, C_out]
// f32, dense; partial [nparts]: the absmax pass's scratch (dynamic mode).
// Returns cudaGetLastError() after the launches (or cudaErrorInvalidValue,
// launching nothing, for a layer whose tiles do not fit in shared memory).
extern "C" int conv_int8_launch(const Q1Layer* L, const float* x, int xp,
                                float* out, int B, int H, int W,
                                float* partial, int nparts,
                                cudaStream_t stream) {
  const int k = L->k, stride = L->stride, pad = L->pad, C = L->C;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  if (L->ascale == nullptr)
    absmax_kernel<<<nparts, kThreads, 0, stream>>>(
        x, (long long)B * H * W, C, xp, partial);
  const Args a{x,      L->w,  L->kpad,   L->wscale, L->bias, L->ascale,
               partial, nparts, out,     B,         H,       W,
               C,      xp,    L->Cout,   k,         stride,  pad,
               Ho,     Wo,    L->act};
  if (L->groups == 1) {
    const int err = launch_dense(a, stream);
    if (err != 0) return err;
  } else {
    const int pw = (kDwTile - 1) * stride + k;
    const size_t smem = (size_t)(pw * pw + k * k) * 4 * sizeof(int);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    const int err = allow_smem<conv_dw_kernel>(smem);
    if (err != 0) return err;
    const int tiles = ((Ho + kDwTile - 1) / kDwTile) *
                      ((Wo + kDwTile - 1) / kDwTile);
    const dim3 grid(tiles, (C + kDwChans - 1) / kDwChans, B);
    conv_dw_kernel<<<grid, kThreads, smem, stream>>>(
        x, L->w, L->wscale, L->bias, L->ascale, partial, nparts, out, B, H,
        W, C, xp, k, stride, pad, Ho, Wo, L->act);
  }
  return (int)cudaGetLastError();
}
