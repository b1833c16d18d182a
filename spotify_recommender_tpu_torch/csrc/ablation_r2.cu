// TPU kernels 5-8: the round-2 ablation variants of kernel 3.
//
// Replaces the hand-written bodies of the JAX repo's round-2 ablation
// (`k_full_r1`, the 17th, is kernel 3 itself: csrc/fused_topk.cu):
//   experiments/kernel_ablation_r2.py   (run_variant :155, pallas_call :161)
//       k_dotonly :54, k_dot_widemax :70, k_dot_vertmax :85,
//       k_dot_verttop2 :106
//   experiments/kernel_ablation_r2b.py  (run_variant :126, pallas_call :132)
//       k_e_div :40, k_e_recip :49, k_e_guard :58, k_e_fast :75,
//       k_dotonly :88, k_e_fast_guard :98
//   experiments/kernel_ablation_r2c.py  (run_case :118, pallas_call :127)
//       k_dotonly :33, k_fastguard :41, k_fastguard_top2 :55,
//       k_staged_f32 :84
//   experiments/kernel_ablation_r2d.py  (run_case :69, pallas_call :75)
//       k_dotonly :20, k_fg2 :27
//
// What every body computes, per catalog tile t of tc columns (np a
// multiple of tc, tc of 128) and query q:
//   dot       sum over r = 0..f-1, ascending, of q[r] * ft[r][col], one
//             rounding per multiply and per add (__fmul_rn / __fadd_rn,
//             never contracted), as csrc/fused_topk.cu; a product of two
//             bf16 values is exact in fp32, so both types share the chain
//   epilogue  flags, applied in this order: DIV s = dot / (qn*cn), MUL
//             s = dot * (qn*cn), CLIP s = clamp(s, -1, 1) by comparisons
//             that pass NaN (jnp.clip), GUARD s = qn*cn > eps ? s : 0,
//             MASK s = -inf for col >= valid and col == excl[q]
//   reduce    FIRST: the raw dots of the tile's first `width` columns;
//             MAX: the max over the tile, NaN winning (jnp.max); TOP2: per
//             lane (col mod 128) the top-2 over the tile's tc/128 groups in
//             ascending order with strict `>` (v2 from -inf, g2 from 0),
//             then the max of v1 and the max over lanes of g1 + g2
//   output    the LAST tile's result, since the TPU bodies overwrite their
//             scratch at every grid step: (b, width) f32, broadcast for
//             MAX / TOP2, and, where asked, (b, width) int32 (0, or TOP2's
//             max(g1 + g2)); without the int32 output, TOP2 writes column 0
//             as m0 + max(g1 + g2) * 0, as r2c / r2d do
//   digest    what the TPU does not write: per (query, tile) the tile's
//             max (of the raw dots for FIRST) and, for TOP2, max(g1 + g2),
//             (b, ntiles) each.  Every tile's work reaches memory through
//             it, so the compiler cannot drop the tiles the output does
//             not read, and the plain version (ops/cuda/ablation.py) is
//             held to it too.  Its running max is a few operations per
//             score and is part of the kernel's time.
//
// What bounds it on an H100: the fp32 instruction rate.  b x np x f
// multiply-adds (1024 x 1M x 12: 12.4 G, 0.37 ms at 67 TFLOP/s), plus the
// epilogue (one IEEE division per score in the DIV bodies) and the
// reduction, against f x 4 (bf16: f x 2) bytes of catalog per column.
//
// Design, right before fast:
// - a block of 128 threads owns TQ = 16 queries and one catalog tile;
//   thread l owns lane l and walks the tile's groups (columns t*tc +
//   128*g + l) in ascending g, so TOP2's tie rule is the TPU's sequential
//   one and needs no merge;
// - the grid is (query tiles x catalog tiles), query tiles fastest, so
//   the blocks that read one catalog tile run together and share it in
//   L2;
// - the query values sit in shared memory as float4 broadcasts (kernel
//   3's layout); a column's catalog values load four rows at a time, the
//   adds stay in ascending row order;
// - at the end of its tile the block reduces its lanes with warp shuffles
//   and one shared-memory step, writes the digest, and the last tile's
//   blocks write the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 128;  // threads per block: one per lane, col mod 128
constexpr int kWarps = kLanes / 32;
constexpr int kTQ = 16;      // queries per block
constexpr int kMaxF = 64;    // query width the shared buffer holds

// epilogue flags and reductions (ops/cuda/ablation.py has the same values)
constexpr int kGuard = 1, kDiv = 2, kMul = 4, kClip = 8, kMask = 16;
constexpr int kFirst = 0, kMax = 1, kTop2 = 2;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// max that keeps NaN, whichever side it is on
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// acc[j] = dot of query j with the column at `col` (rows `stride` apart)
template <typename T>
__device__ __forceinline__ void dot(const float* qs, const T* __restrict__ col,
                                    int64_t stride, int f,
                                    float (&acc)[kTQ]) {
  for (int d0 = 0; d0 < f; d0 += 4) {
    float fv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      fv[u] = d0 + u < f ? ld(col + (d0 + u) * stride) : 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = d0 + u;
      if (d >= f) break;
      const float4* qd = reinterpret_cast<const float4*>(qs + d * kTQ);
#pragma unroll
      for (int j = 0; j < kTQ / 4; ++j) {
        const float4 a = qd[j];
        const float p[4] = {__fmul_rn(a.x, fv[u]), __fmul_rn(a.y, fv[u]),
                            __fmul_rn(a.z, fv[u]), __fmul_rn(a.w, fv[u])};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] = d == 0 ? p[e] : __fadd_rn(acc[4 * j + e], p[e]);
      }
    }
  }
}

template <int EPI>
__device__ __forceinline__ float epilogue(float s, float qn, float cn,
                                          float eps, bool bad) {
  float den = 0.0f;
  if (EPI & (kGuard | kDiv | kMul)) den = __fmul_rn(qn, cn);
  if (EPI & kDiv) s = __fdiv_rn(s, den);
  if (EPI & kMul) s = __fmul_rn(s, den);
  if (EPI & kClip) {
    s = s < -1.0f ? -1.0f : s;
    s = s > 1.0f ? 1.0f : s;
  }
  if (EPI & kGuard) s = den > eps ? s : 0.0f;
  if (EPI & kMask) s = bad ? -INFINITY : s;
  return s;
}

template <typename T, int EPI, int RED>
__global__ void __launch_bounds__(kLanes)
    ablation_kernel(const T* __restrict__ q, const float* __restrict__ qn,
                    const T* __restrict__ ft, int64_t ft_stride,
                    const float* __restrict__ cn,
                    const int32_t* __restrict__ excl, int64_t valid,
                    int64_t b, int f, int tc, int ntiles, float eps,
                    int width, float* __restrict__ out_s,
                    int32_t* __restrict__ out_i, float* __restrict__ dmax,
                    int32_t* __restrict__ dg) {
  __shared__ __align__(16) float qs[kMaxF * kTQ];  // [d][query]
  __shared__ float sqn[kTQ];
  __shared__ int64_t sex[kTQ];
  __shared__ float rmax[kWarps][kTQ];
  __shared__ int rg[kWarps][kTQ];
  __shared__ float smax[kTQ];
  __shared__ int sg[kTQ];

  const int l = threadIdx.x;
  const int lane = l & 31;
  const int warp = l >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTQ;
  const int tile = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(tile) * tc;

  for (int i = l; i < f * kTQ; i += kLanes) {
    const int d = i / kTQ;
    const int j = i % kTQ;
    qs[i] = q0 + j < b ? ld(q + (q0 + j) * f + d) : 0.0f;
  }
  if (l < kTQ) {
    const bool in = q0 + l < b;
    sqn[l] = in ? qn[q0 + l] : 0.0f;
    sex[l] = (in && excl != nullptr) ? excl[q0 + l] : -1;
  }
  __syncthreads();

  // MAX / FIRST: the running max; TOP2: v1, and v2 g1 g2 beside it
  float m[kTQ], v2[kTQ], first[kTQ];
  int g1[kTQ], g2[kTQ];
#pragma unroll
  for (int j = 0; j < kTQ; ++j) {
    m[j] = v2[j] = first[j] = -INFINITY;
    g1[j] = g2[j] = 0;
  }
  const int groups = tc / kLanes;
  for (int gi = 0; gi < groups; ++gi) {
    const int64_t col = c0 + static_cast<int64_t>(gi) * kLanes + l;
    float acc[kTQ];
    dot<T>(qs, ft + col, ft_stride, f, acc);
    const float cnorm = (EPI & (kGuard | kDiv | kMul)) ? __ldg(cn + col) : 0.0f;
    const bool pad = (EPI & kMask) && col >= valid;
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      const float s = epilogue<EPI>(acc[j], sqn[j], cnorm, eps,
                                    pad || col == sex[j]);
      if (RED == kTop2) {
        const bool beat1 = s > m[j];
        const bool beat2 = !beat1 && s > v2[j];
        v2[j] = beat1 ? m[j] : (beat2 ? s : v2[j]);
        g2[j] = beat1 ? g1[j] : (beat2 ? gi : g2[j]);
        m[j] = beat1 ? s : m[j];
        g1[j] = beat1 ? gi : g1[j];
      } else {
        m[j] = nanmax(m[j], s);
        if (RED == kFirst && gi == 0) first[j] = s;
      }
    }
  }

  // the block's lanes -> one max (and max g1 + g2) per query
#pragma unroll
  for (int j = 0; j < kTQ; ++j) {
    float x = m[j];
    int g = g1[j] + g2[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = nanmax(x, __shfl_xor_sync(kFull, x, off));
      if (RED == kTop2) g = max(g, __shfl_xor_sync(kFull, g, off));
    }
    if (lane == 0) {
      rmax[warp][j] = x;
      rg[warp][j] = g;
    }
  }
  __syncthreads();
  const bool last = tile == ntiles - 1;
  if (l < kTQ) {
    float x = rmax[0][l];
    int g = rg[0][l];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      x = nanmax(x, rmax[w][l]);
      g = max(g, rg[w][l]);
    }
    const int64_t qg = q0 + l;
    if (qg < b) {
      dmax[qg * ntiles + tile] = x;
      if (RED == kTop2) dg[qg * ntiles + tile] = g;
    }
    smax[l] = x;
    sg[l] = g;
  }
  if (!last) return;  // block-uniform
  __syncthreads();
  if (RED == kFirst) {
    if (l < width) {
#pragma unroll
      for (int j = 0; j < kTQ; ++j) {
        const int64_t qg = q0 + j;
        if (qg >= b) break;
        out_s[qg * width + l] = first[j];
        if (out_i != nullptr) out_i[qg * width + l] = 0;
      }
    }
    return;
  }
  for (int i = l; i < kTQ * width; i += kLanes) {
    const int j = i / width;
    const int c = i % width;
    const int64_t qg = q0 + j;
    if (qg >= b) break;
    float x = smax[j];
    if (RED == kTop2 && out_i == nullptr && c == 0)
      x = __fadd_rn(x, __fmul_rn(static_cast<float>(sg[j]), 0.0f));
    out_s[qg * width + c] = x;
    if (out_i != nullptr) out_i[qg * width + c] = RED == kTop2 ? sg[j] : 0;
  }
}

struct Args {
  const void* q;
  const void* qn;
  const void* ft;
  int64_t ft_stride;
  const void* cn;
  const void* excl;
  int64_t valid, b;
  int f, tc, ntiles;
  float eps;
  int width;
  void* out_s;
  void* out_i;
  void* dmax;
  void* dg;
};

template <typename T, int EPI, int RED>
int launch(const Args& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.b + kTQ - 1) / kTQ),
                  static_cast<unsigned>(a.ntiles));
  ablation_kernel<T, EPI, RED><<<grid, kLanes, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const float*>(a.qn),
      static_cast<const T*>(a.ft), a.ft_stride,
      static_cast<const float*>(a.cn), static_cast<const int32_t*>(a.excl),
      a.valid, a.b, a.f, a.tc, a.ntiles, a.eps, a.width,
      static_cast<float*>(a.out_s), static_cast<int32_t*>(a.out_i),
      static_cast<float*>(a.dmax), static_cast<int32_t*>(a.dg));
  return static_cast<int>(cudaGetLastError());
}

// The instances the bodies use: (storage, epilogue, reduction).
#define SRT_ABLATION_INSTANCES(X)                                      \
  X(float, 0, kFirst)                                                  \
  X(float, kGuard | kDiv | kClip | kMask, kMax)                        \
  X(float, kGuard | kDiv | kClip | kMask, kTop2)                       \
  X(float, kDiv | kClip, kMax)                                         \
  X(float, kMul | kClip, kMax)                                         \
  X(float, kClip | kMask, kMax)                                        \
  X(float, kGuard | kClip, kMax)                                       \
  X(float, kGuard | kClip, kTop2)                                      \
  X(float, kGuard | kDiv | kClip, kMax)                                \
  X(__nv_bfloat16, 0, kFirst)                                          \
  X(__nv_bfloat16, kClip | kMask, kMax)                                \
  X(__nv_bfloat16, kGuard | kClip | kMask, kMax)                       \
  X(__nv_bfloat16, kGuard | kClip, kMax)                               \
  X(__nv_bfloat16, kGuard | kClip, kTop2)

int dispatch(const Args& a, bool bf16, int epi, int red, cudaStream_t s) {
#define SRT_ABLATION_CASE(T, E, R)                                     \
  if (bf16 == std::is_same<T, __nv_bfloat16>::value && epi == (E) &&   \
      red == (R))                                                      \
    return launch<T, (E), (R)>(a, s);
  SRT_ABLATION_INSTANCES(SRT_ABLATION_CASE)
#undef SRT_ABLATION_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (b, f) contiguous, f32 or (bf16 != 0) bf16; qn (b,) f32; ft (>= f rows
// of row stride ft_stride, np columns) of q's type; cn (np,) f32; excl
// (b,) int32 or null (no exclusion); columns >= valid are masked (MASK
// bodies); np a multiple of tc, tc a multiple of 128.  out_s (b, width)
// f32; out_i (b, width) int32 or null; dmax (b, np / tc) f32; dg
// (b, np / tc) int32 for TOP2, else unused.  FIRST takes width <= 128.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments or an
// (epi, red, type) instance the library does not hold.
extern "C" int srt_ablation(const void* q, const void* qn, const void* ft,
                            int64_t ft_stride, const void* cn,
                            const void* excl, int64_t valid, int64_t b,
                            int f, int64_t np, int tc, int bf16, int epi,
                            int red, int width, float eps, void* out_s,
                            void* out_i, void* dmax, void* dg, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (f < 1 || f > kMaxF || tc < kLanes || tc % kLanes || np < tc ||
      np % tc || np >= INT_MAX || np / tc > 65535 || width < 1 ||
      (red == kFirst && width > kLanes) || (red == kTop2 && dg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  qn, ft, ft_stride, cn, excl, valid, b, f, tc,
               static_cast<int>(np / tc), eps, width, out_s, out_i, dmax,
               dg};
  return dispatch(a, bf16 != 0, epi, red, static_cast<cudaStream_t>(stream));
}
