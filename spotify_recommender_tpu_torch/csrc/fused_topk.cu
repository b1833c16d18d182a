// Fused cosine score + top-k over an fp32, bf16 or bf16x2 catalog.
//
// Replaces the TPU kernel `_fused_kernel` / `_fused_call`
// (spotify_recommender_tpu/ops/pallas/fused_topk.py:52, :353), the kernel
// behind `FusedRetriever`, `PrefilterRetriever` and the streaming tier's
// per-window scoring.
//
// What it computes, for every query q of a batch against catalog columns
// 0..np-1 of the transposed (Fc, np) layout, with queries of width Fq:
//
//   dot(q, c)  = sum over d = 0..Fq-1, ascending, of q[d]*f[d mod Fc][c],
//                with one rounding per multiply and one per add (__fmul_rn /
//                __fadd_rn, which nvcc never contracts into an FMA), so the
//                plain torch version (ops/cuda/fused.py) is bitwise equal.
//                Storage (the TPU kernel's `is_bf16` branch, :112-136):
//                fp32 (Fq = Fc = F); bf16 (Fq = Fc = F); bf16x2, queries
//                [qh, ql, ql, qh] (Fq = 4F) against planes [hi; lo]
//                (Fc = 2F) or [hi; lo; hi; lo] (Fc = 4F): the same products
//                in the same order either way.  A product of two bf16
//                values is exact in fp32, so the bf16 sums are the TPU
//                MXU's: exact products added in fp32
//   den        = qn * cn              (the raw norms, in both modes)
//   score      = den > eps ? clamp(dot / den, -1, 1) : 0     exact mode
//                den > eps ? clamp(dot, -1, 1)       : 0     prenormalized
//                (IEEE division, __fdiv_rn; no fast math)
//   columns >= valid and the query's excluded column score -inf after the
//   clamp and never enter the top-k;
//   out: the top-k (value, column) by value descending, lowest column first
//   on equal values; unfilled slots hold (-inf, -1).
//
// What bounds it on an H100: fp32 issue.  B x Np x F multiplies and as many
// adds, plus the division epilogue per (query, column): at B = 1024,
// Np = 1M, F = 12 that is 25 G fp32 operations and 1 G divisions, against
// 48 bytes of catalog per column.  The top-k is cheap once a query's k-th
// best value has risen above almost every new score.
//
// Design, right before fast:
//
// - the grid is (query tiles of TQ = 16) x (catalog splits).  A split is a
//   contiguous column range, so even B = 1 fills the card (the lesson of
//   the v3 scan, whose one block per query tile walked the whole catalog);
// - a block of 128 threads walks its split in tiles of 128 columns, one
//   column per thread: the thread reads the column's F values (coalesced in
//   the transposed layout; any strides are accepted, so a row-major window
//   is read in place) and scores it against the tile's 16 queries, whose
//   values sit in shared memory as float4 broadcasts;
// - the tile's 16 x 128 scores go to shared memory, and each warp updates
//   the running top-k of 4 of the queries: a ballot finds the columns above
//   the query's k-th best, and each such column, in ascending order, is
//   inserted into a sorted list spread over the warp's registers (entry
//   j = 32*i + lane in slot i).  Columns arrive in ascending order, so an
//   insert after the equal values keeps the lowest column first, as the
//   TPU's sequential grid and its `>=` insert count do;
// - each block writes one sorted partial list per (query, split); a second
//   kernel merges the splits' lists per query, one warp per query, by k
//   rounds of a warp-wide pick of the best list head (value descending,
//   column ascending).
//
// Limits: k <= 128 (4 list slots per lane), at most 128 splits, column
// indices below 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 16;                 // queries per block
constexpr int kQPW = kTQ / kWarps;      // queries per warp in the select step
constexpr int kTC = kThreads;           // columns per tile: one per thread
constexpr int kMaxSplits = 128;         // 4 per lane in the merge
constexpr int kMergeWarps = 4;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// (av, ac) ranks before (bv, bc): value descending, column ascending
__device__ __forceinline__ bool ranks_before(float av, int ac, float bv,
                                             int bc) {
  return av > bv || (av == bv && ac < bc);
}

// Value of entry k-1 of a warp-spread list, on every lane.
template <int KPL>
__device__ __forceinline__ float list_kth(const float (&v)[KPL], int k) {
  const int slot = (k - 1) >> 5;
  float x = v[0];
#pragma unroll
  for (int i = 1; i < KPL; ++i) x = (i == slot) ? v[i] : x;
  return __shfl_sync(kFull, x, (k - 1) & 31);
}

// Insert (s, col) into the sorted warp-spread list of its first k entries.
// The caller guarantees s > entry k-1 and col > every column in the list,
// so s goes after the entries >= s and entry k-1 drops out.  Warp-uniform.
template <int KPL>
__device__ __forceinline__ void list_insert(float (&v)[KPL], int (&c)[KPL],
                                            int k, float s, int col,
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i)
    pos += __popc(__ballot_sync(kFull, 32 * i + lane < k && v[i] >= s));
  float nv[KPL];
  int nc[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    // entry j - 1: lane - 1 of this slot, or lane 31 of the slot before
    const float up_v = __shfl_up_sync(kFull, v[i], 1);
    const int up_c = __shfl_up_sync(kFull, c[i], 1);
    float wrap_v = 0.0f;
    int wrap_c = 0;
    if (i > 0) {
      wrap_v = __shfl_sync(kFull, v[i - 1], 31);
      wrap_c = __shfl_sync(kFull, c[i - 1], 31);
    }
    const float prev_v = lane == 0 ? wrap_v : up_v;
    const int prev_c = lane == 0 ? wrap_c : up_c;
    const int j = 32 * i + lane;
    nv[i] = j < pos ? v[i] : (j == pos ? s : prev_v);
    nc[i] = j < pos ? c[i] : (j == pos ? col : prev_c);
  }
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    v[i] = nv[i];
    c[i] = nc[i];
  }
}

template <int KPL, bool EXACT, typename T>
__global__ void __launch_bounds__(kThreads)
    fused_partial_kernel(const T* __restrict__ q,
                         const float* __restrict__ qn,
                         const T* __restrict__ ft, int64_t ft_sd,
                         int64_t ft_sc, const float* __restrict__ cn,
                         const int64_t* __restrict__ excl, int64_t b, int fq,
                         int fc, int64_t np, int64_t valid, int k, float eps,
                         int64_t split_cols, int nsplit,
                         float* __restrict__ pv, int* __restrict__ pc) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [fq][kTQ] query values
  float* sc = smem + fq * kTQ;           // [kTQ][kTC] tile scores
  __shared__ float sqn[kTQ];
  __shared__ int sex[kTQ];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTQ;
  const int split = blockIdx.y;
  const int64_t c_begin = static_cast<int64_t>(split) * split_cols;
  const int64_t c_end =
      c_begin + split_cols < np ? c_begin + split_cols : np;

  for (int i = t; i < fq * kTQ; i += kThreads) {
    const int d = i / kTQ;
    const int qq = i % kTQ;
    qs[i] = (q0 + qq < b) ? load(q + (q0 + qq) * fq + d) : 0.0f;
  }
  if (t < kTQ) {
    const bool in = q0 + t < b;
    sqn[t] = in ? qn[q0 + t] : 0.0f;
    const int64_t e = in ? excl[q0 + t] : -1;
    sex[t] = (e >= 0 && e < np) ? static_cast<int>(e) : -1;
  }

  float lv[kQPW][KPL];
  int lc[kQPW][KPL];
  float thr[kQPW];
#pragma unroll
  for (int w = 0; w < kQPW; ++w) {
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      lv[w][i] = -INFINITY;
      lc[w][i] = -1;
    }
    thr[w] = -INFINITY;
  }
  __syncthreads();

  for (int64_t base = c_begin; base < c_end; base += kTC) {
    const int64_t col = base + t;
    float s[kTQ];
    if (col < c_end) {
      const T* fp = ft + col * ft_sc;
      const float f0 = load(fp);
#pragma unroll
      for (int j = 0; j < kTQ / 4; ++j) {
        const float4 a = reinterpret_cast<const float4*>(qs)[j];
        s[4 * j + 0] = __fmul_rn(a.x, f0);
        s[4 * j + 1] = __fmul_rn(a.y, f0);
        s[4 * j + 2] = __fmul_rn(a.z, f0);
        s[4 * j + 3] = __fmul_rn(a.w, f0);
      }
      for (int d = 1; d < fq; ++d) {
        const float fd = load(fp + (d < fc ? d : d - fc) * ft_sd);
        const float4* qd = reinterpret_cast<const float4*>(qs + d * kTQ);
#pragma unroll
        for (int j = 0; j < kTQ / 4; ++j) {
          const float4 a = qd[j];
          s[4 * j + 0] = __fadd_rn(s[4 * j + 0], __fmul_rn(a.x, fd));
          s[4 * j + 1] = __fadd_rn(s[4 * j + 1], __fmul_rn(a.y, fd));
          s[4 * j + 2] = __fadd_rn(s[4 * j + 2], __fmul_rn(a.z, fd));
          s[4 * j + 3] = __fadd_rn(s[4 * j + 3], __fmul_rn(a.w, fd));
        }
      }
      const float cnorm = __ldg(cn + col);
      const bool pad = col >= valid;
#pragma unroll
      for (int qq = 0; qq < kTQ; ++qq) {
        const float den = __fmul_rn(sqn[qq], cnorm);
        float x = 0.0f;
        if (den > eps) {
          x = EXACT ? __fdiv_rn(s[qq], den) : s[qq];
          x = fminf(fmaxf(x, -1.0f), 1.0f);
        }
        s[qq] = (pad || col == sex[qq]) ? -INFINITY : x;
      }
    } else {
#pragma unroll
      for (int qq = 0; qq < kTQ; ++qq) s[qq] = -INFINITY;
    }
    __syncthreads();  // the previous tile's scores are consumed
#pragma unroll
    for (int qq = 0; qq < kTQ; ++qq) sc[qq * kTC + t] = s[qq];
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kQPW; ++w) {
      const int qq = warp + w * kWarps;
      if (q0 + qq >= b) continue;  // warp-uniform
#pragma unroll
      for (int ch = 0; ch < kTC / 32; ++ch) {
        const float x = sc[qq * kTC + ch * 32 + lane];
        unsigned m = __ballot_sync(kFull, x > thr[w]);
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          const float xv = __shfl_sync(kFull, x, bit);
          if (xv > thr[w]) {  // thr may have risen within this chunk
            list_insert<KPL>(lv[w], lc[w], k, xv,
                             static_cast<int>(base + ch * 32 + bit), lane);
            thr[w] = list_kth<KPL>(lv[w], k);
          }
        }
      }
    }
  }

#pragma unroll
  for (int w = 0; w < kQPW; ++w) {
    const int64_t qg = q0 + warp + w * kWarps;
    if (qg >= b) continue;
    const int64_t o = (qg * nsplit + split) * k;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = 32 * i + lane;
      if (j < k) {
        pv[o + j] = lv[w][i];
        pc[o + j] = lc[w][i];
      }
    }
  }
}

// One warp per query: merge its nsplit sorted lists of k entries.
__global__ void __launch_bounds__(kMergeWarps * 32)
    fused_merge_kernel(const float* __restrict__ pv,
                       const int* __restrict__ pc, int64_t b, int nsplit,
                       int k, float* __restrict__ ov,
                       int64_t* __restrict__ oi) {
  constexpr int SPL = kMaxSplits / 32;  // lists per lane: lane + 32*i
  const int lane = threadIdx.x & 31;
  const int64_t qg =
      static_cast<int64_t>(blockIdx.x) * kMergeWarps + (threadIdx.x >> 5);
  if (qg >= b) return;  // warp-uniform
  const float* qv = pv + qg * nsplit * k;
  const int* qc = pc + qg * nsplit * k;
  int head[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) head[i] = 0;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bc = INT_MAX;
    int bs = INT_MAX;  // split of the pick: the last key, lists are disjoint
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int sp = lane + 32 * i;
      if (sp < nsplit && head[i] < k) {
        const float v = qv[sp * k + head[i]];
        const int c = qc[sp * k + head[i]];
        if (ranks_before(v, c, bv, bc) ||
            (v == bv && c == bc && sp < bs)) {
          bv = v;
          bc = c;
          bs = sp;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov2 = __shfl_xor_sync(kFull, bv, off);
      const int oc2 = __shfl_xor_sync(kFull, bc, off);
      const int os2 = __shfl_xor_sync(kFull, bs, off);
      if (ranks_before(ov2, oc2, bv, bc) ||
          (ov2 == bv && oc2 == bc && os2 < bs)) {
        bv = ov2;
        bc = oc2;
        bs = os2;
      }
    }
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      if (bs == lane + 32 * i) ++head[i];
    if (lane == 0) {
      ov[qg * k + r] = bv;
      oi[qg * k + r] = bv == -INFINITY ? -1 : static_cast<int64_t>(bc);
    }
  }
}

// The arguments of one call, as the C entry point receives them.
struct Args {
  const void* q;
  const void* qn;
  const void* ft;
  int64_t ft_sd, ft_sc;
  const void* cn;
  const void* excl;
  int64_t b;
  int fq, fc;
  int64_t np, valid;
  int k;
  float eps;
  int nsplit;
  int64_t split_cols;
  void* pv;
  void* pc;
};

template <int KPL, bool EXACT, typename T>
int launch_partial(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(a.fq) * kTQ +
                                       static_cast<size_t>(kTQ) * kTC);
  auto kernel = fused_partial_kernel<KPL, EXACT, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((a.b + kTQ - 1) / kTQ),
                  static_cast<unsigned>(a.nsplit));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const float*>(a.qn),
      static_cast<const T*>(a.ft), a.ft_sd, a.ft_sc,
      static_cast<const float*>(a.cn), static_cast<const int64_t*>(a.excl),
      a.b, a.fq, a.fc, a.np, a.valid, a.k, a.eps, a.split_cols, a.nsplit,
      static_cast<float*>(a.pv), static_cast<int*>(a.pc));
  return static_cast<int>(cudaGetLastError());
}

template <bool EXACT, typename T>
int launch_k(const Args& a, cudaStream_t s) {
  if (a.k <= 32) return launch_partial<1, EXACT, T>(a, s);
  if (a.k <= 64) return launch_partial<2, EXACT, T>(a, s);
  return launch_partial<4, EXACT, T>(a, s);
}

}  // namespace

// q (b, fq) contiguous, f32 or (bf16 != 0) bf16; qn (b,) f32; catalog value
// (d, c) at ft[d * ft_sd + c * ft_sc], d < fc, c < np, of q's type, with
// fq == fc, or fq == 2 * fc for bf16x2 over [hi; lo]; cn (np,) f32; excl
// (b,) int64; pv, pc (b, nsplit, k) f32 / int32 scratch; out ov (b, k) f32,
// oi (b, k) int64.  Split s covers columns [s * split_cols, (s + 1) *
// split_cols).  bf16 storage takes prenormalized rows only (exact == 0).
// Returns cudaGetLastError().
extern "C" int srt_fused_topk(const void* q, const void* qn, const void* ft,
                              int64_t ft_sd, int64_t ft_sc, const void* cn,
                              const void* excl, int64_t b, int64_t fq,
                              int64_t fc, int64_t np, int64_t valid,
                              int64_t k, int64_t exact, int64_t bf16,
                              float eps, int64_t nsplit, int64_t split_cols,
                              void* pv, void* pc, void* ov, void* oi,
                              void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > 128 || nsplit < 1 || nsplit > kMaxSplits || fc < 1 ||
      (fq != fc && !(bf16 && fq == 2 * fc)) || (bf16 && exact) ||
      np >= INT_MAX || split_cols * nsplit < np)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, qn, ft, ft_sd, ft_sc, cn, excl, b,
               static_cast<int>(fq), static_cast<int>(fc), np, valid,
               static_cast<int>(k), eps, static_cast<int>(nsplit),
               split_cols, pv, pc};
  const int err = bf16    ? launch_k<false, __nv_bfloat16>(a, s)
                  : exact ? launch_k<true, float>(a, s)
                          : launch_k<false, float>(a, s);
  if (err != 0) return err;
  const int64_t blocks = (b + kMergeWarps - 1) / kMergeWarps;
  fused_merge_kernel<<<static_cast<unsigned>(blocks), kMergeWarps * 32, 0,
                       s>>>(static_cast<const float*>(pv),
                            static_cast<const int*>(pc), b, a.nsplit, a.k,
                            static_cast<float*>(ov),
                            static_cast<int64_t*>(oi));
  return static_cast<int>(cudaGetLastError());
}
