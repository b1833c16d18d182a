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
// adds (never contracted into an FMA, so one instruction per flop), plus the
// epilogue per (query, column): at B = 1024, Np = 1M, F = 12 that is 25 G
// fp32 instructions, against 48 bytes of catalog per column.  The top-k is
// cheap once a query's k-th best value has risen above almost every new
// score, as long as the scores that cannot enter cost no more than a compare.
//
// Design:
//
// - the grid is (query tiles of TQ = 16) x (catalog splits).  A split is a
//   contiguous column range, so even B = 1 fills the card (the lesson of
//   the v3 scan, whose one block per query tile walked the whole catalog);
// - a block of 4 warps walks its split in tiles of 128 columns, one column
//   per thread: warp w owns columns base + 32*w + lane of each tile, so each
//   warp sees its own columns in ascending order.  The thread reads the
//   column's Fq values (coalesced in the transposed layout; any strides are
//   accepted, so a row-major window is read in place) and scores it against
//   the block's 16 queries, whose values sit in shared memory as float4
//   broadcasts, loaded once before the walk;
// - warp-private lists: for each of the 16 queries every warp keeps its own
//   running top-k (value descending, column ascending) over its own
//   columns, in shared memory ([warp][query][k] values and columns;
//   16 x 4 x k x 8 bytes, 64 KB at k = 128).  Registers would hold 16
//   queries' lists only at k <= 32, beside the 16 scores, so one layout
//   serves every k; an insert is rare once a list has filled;
// - the filter sits in the warp that just scored, and costs a multiply and
//   a compare per (query, column) (an add and a compare prenormalized): a
//   column passes for query qq if dot >= rn(bound[qq] * ch), with ch the
//   column's norm and bound from filter_bound (below): -inf at first,
//   +inf for a query slot past B.  One
//   __any_sync over the tile's 16 queries skips the rest in the common
//   case; otherwise one __ballot_sync per query, and only the set bits get
//   their exact score (the guard, the IEEE division, the clamp, the
//   exclusion) and, in ascending lane order, go through list_insert if it
//   beats the k-th best.  No score is written to shared memory, and the
//   walk has no block barrier;
// - the block's floor: each warp publishes, per query, the ceil(k/4)-th
//   best value of its list in shared memory.  The 4 warps' lists then hold
//   at least k columns at or above the least of the 4 values, so a column
//   below it is in no top-k of the split, and no warp needs to keep it.
//   The floor only rises, and a warp may read it late: it takes it up when
//   it next handles a query that passed (a refresh of all 16 bounds every
//   few tiles cost more than it saved, on the card).  Without the floor
//   every warp would keep the top-k of its own quarter of the split, and a
//   large k would pay for four lists' inserts;
// - strict `>` against the warp's own k-th value, `>=` against the floor,
//   and an insert after the entries >= the new value keep the lowest column
//   first on equal values, because a warp's columns arrive in ascending
//   order (as the TPU's sequential grid and its `>=` insert count do);
// - after the walk the block folds its 4 warp lists per query in shared
//   memory (k rounds of a pick of the best list head by value descending,
//   column ascending; the warps' columns are disjoint) and writes one
//   sorted partial list per (query, split); a second kernel merges the
//   splits' lists per query, one warp per query, the same way.  A column in
//   the split's top-k is at or above every floor and in its warp's top-k,
//   so it enters its warp's list and stays, and the fold finds it;
// - the wrapper sizes the splits so that (query tiles x splits) blocks fit
//   the card's resident blocks in one wave (srt_fused_blocks_per_sm): the
//   blocks are equal, and a second, part-filled wave would double the time.
//
// The filter's bound: the division only where a column can still enter.
// A column enters only if its score x > t, the warp's k-th best for the
// query, and x >= f, the block's floor.  Let qn, cn be the raw norms, den
// = rn(qn*cn) > eps (else x = 0) and, in exact mode, x = clamp(rn(dot /
// den), -1, 1).
//
//   t >= 1, or a zero query (qn = 0, so every score is 0) with t >= 0:
//   nothing exceeds t (bound +inf).  Else let u = max(t, f) <= 1 (scores
//   are clamped); it is enough to pass every x >= u.  u < 2^-60, -inf
//   included: every scored column passes (-inf; a zero norm counts as
//   FLT_MIN, so -inf * ch stays -inf).  Otherwise u is a normal float in
//   [2^-60, 1]:
//
//   x >= u  =>  rn(dot / den) >= u  =>  dot / den >= u * (1 - 2^-24)
//                    (the least real that rounds to a normal u or above)
//           =>  dot >= u * den * (1 - 2^-24)
//           >=  u * qn * cn * (1 - 2^-24)^2    (den is qn*cn rounded once
//                                               in the normal range)
//           >=  bound * cn,   bound = rd(rd(u * qn) * (1 - 2^-22))
//
//   (__fmul_rd rounds toward -inf, so bound <= u*qn*(1 - 2^-22)).  dot, a
//   float at or above the real bound*cn, is >= rn(bound*cn) because rn is
//   monotone: `dot >= rn(bound * cn)` never rules out a column that would
//   enter, subnormal dots and products included (nothing is flushed to
//   zero).  Prenormalized (no division): for u in [2^-60, 1], clamp(dot)
//   >= u implies dot >= u, so the bound is u itself.  A column let through
//   that does not enter costs one exact score; padding and columns past
//   the split carry ch = NaN and never pass; the excluded column passes at
//   most once per walk and its exact score is -inf.  The domain: finite
//   dots, and norms whose product is finite.
//
// Above k = 128 the warp lists would not fit (four lists per query, 16
// queries, [4][16][k] x 8 bytes: 512 KB at k = 1000 against the 227 KB a
// block may use), and the fold and the merge take k rounds each.  So
// k > 128 takes a second path, the large-k kernels below, and k <= 128
// runs the kernels above unchanged.  The large-k path:
//
// - the same grid of (query tiles of 16) x (catalog splits), block of 128
//   threads, query tile in shared memory, column walk, dots, filter and
//   exact score (the device functions above, so the scores are the same
//   bits);
// - one candidate buffer per (query, split) of `cap` 64-bit keys in device
//   memory (the wrapper's cap = 2k rounded up to 128: 16 KB a query at k =
//   1000), and a threshold t per query, -inf at first.  A column whose
//   score x > t is appended (a shared-memory count per query, one atomic
//   a warp and tile for its 16 queries); the filter is filter_bound's
//   with t and no floor, so the division still runs only where a column
//   can enter;
// - the key: the score's order-preserving bits (-0.0 made +0.0, as the
//   plain version ranks them equal) in the high word, the inverted column
//   in the low word (and the sign of a zero in its last bit, so that the
//   value comes back as it was scored).  Keys are unique and order as the
//   plain version does: value descending, lowest column first;
// - after each tile, at a block barrier, a buffer that may not take
//   another tile (more than cap - 128 keys) is cut back to its k best by a
//   block-wide radix select over the keys (8-bit digits from the top,
//   until the digit holds exactly the keys still needed) and an in-place
//   compaction, and t becomes the k-th key's value.  With cap = 2k a
//   buffer is cut about ln(split columns / k) times;
// - a second kernel merges, one block of 512 threads per query: the same
//   select over the splits' nsplit x k keys, compaction, a bitonic sort
//   (in shared memory up to 8192 keys, else in place in the scratch) and
//   the (value, column) output;
// - the scratch is (B, nsplit, cap) keys.  The wrapper (ops/cuda/fused.py,
//   _large_plan) sizes it to one wave of resident blocks but at most
//   max(64 MiB, the buffers of four blocks per SM), and never above a
//   ceiling of 512 MiB (LARGE_SCRATCH_CEILING; only one block's buffers,
//   16 x cap keys, may pass it, past k = 2^21): at large k and B fewer
//   splits, then batch chunks, keep it there.  The grid holds four blocks
//   per SM where the batch has the query tiles up to k = 4096 (B = 1024,
//   k = 1000: 64 tiles x 8 splits, 128 MiB; k = 4096: 512 MiB), and above
//   it what the ceiling leaves (k = 10^4, 10M columns: 64 x 3, 471 MiB;
//   k = 10^5: chunks of 20 tiles x 1 split, 488 MiB).  A
//   walk is latency-bound (the 12 rows' loads of a column come one after
//   another), so the blocks an SM holds set its pace.  A split is at
//   least 8k columns wide, so that the merge's input stays near the
//   split's.
//
// Limits: the small-k path at most 128 splits; the large-k path any k >= 1
// (for k > 128 the wrapper takes it); column indices below 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 16;                 // queries per block
constexpr int kQPW = kTQ / kWarps;      // queries per warp in the fold
constexpr int kTC = kThreads;           // columns per tile: one per thread
constexpr int kMaxSplits = 128;         // 4 per lane in the merge
constexpr int kMergeWarps = 4;
constexpr float kTinyT = 0x1p-60f;      // below it the filter lets all through
constexpr float kShrink = 1.0f - 0x1p-22f;  // the exact filter's margin

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// (av, ac) ranks before (bv, bc): value descending, column ascending
__device__ __forceinline__ bool ranks_before(float av, int ac, float bv,
                                             int bc) {
  return av > bv || (av == bv && ac < bc);
}

// Insert (s, col) into the sorted list of the first k entries at lv / lc
// in shared memory, private to the calling warp (entry j = 32*i + lane in
// step i).  The caller guarantees s > entry k-1 and col > every column in
// the list, so s goes after the entries >= s and entry k-1 drops out.
// Warp-uniform.
template <int KPL>
__device__ __forceinline__ void list_insert(float* lv, int* lc, int k,
                                            float s, int col, int lane) {
  int pos = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int j = 32 * i + lane;
    pos += __popc(__ballot_sync(kFull, j < k && lv[j] >= s));
  }
  float prev_v[KPL];
  int prev_c[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int j = 32 * i + lane;
    const bool moved = j > pos && j < k;
    prev_v[i] = moved ? lv[j - 1] : s;
    prev_c[i] = moved ? lc[j - 1] : col;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int j = 32 * i + lane;
    if (j >= pos && j < k) {
      lv[j] = prev_v[i];
      lc[j] = prev_c[i];
    }
  }
  __syncwarp();
}

// The filter's per-query bound from the warp's k-th best t, the block's
// floor f and the raw query norm qn: a column passes if dot >= rn(bound *
// ch), ch its norm (exact), or dot >= bound + 0 (prenormalized); a column
// whose score x > t and x >= f always passes (see the notes above).
template <bool EXACT>
__device__ __forceinline__ float filter_bound(float t, float f, float qn) {
  if (t >= 1.0f || (qn == 0.0f && t >= 0.0f))
    return INFINITY;                   // nothing exceeds t: 1, or all 0
  const float u = fmaxf(t, f);         // <= 1: scores are clamped
  if (!(u >= kTinyT)) return -INFINITY;  // let every column through
  if (!EXACT) return u;
  return __fmul_rd(__fmul_rd(u, qn), kShrink);  // <= u * qn * (1 - 2^-22)
}

// The block's floor for a query: each warp's list holds at least
// ceil(k/4) entries >= its published value, so the block has >= k columns
// >= their minimum and a column below it is in no top-k.  Read while other
// warps write: any value read is one that warp held, and they only rise.
__device__ __forceinline__ float block_floor(const volatile float* pub) {
  return fminf(fminf(pub[0], pub[1]), fminf(pub[2], pub[3]));
}

// The block's query tile into shared memory: qs[d * kTQ + qq] the value d
// of query q0 + qq (0 past B), sqn its raw norm, sex its excluded column
// (-1 = none or out of range).  Every thread of a kThreads block calls it.
template <typename T>
__device__ __forceinline__ void load_query_tile(
    const T* __restrict__ q, const float* __restrict__ qn,
    const int64_t* __restrict__ excl, int64_t b, int fq, int64_t np,
    int64_t q0, float* qs, float* sqn, int* sex) {
  const int t = threadIdx.x;
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
}

// The dots of the block's kTQ queries (qs, as load_query_tile lays them
// out) with the catalog column at fp: query value d meets catalog row
// d mod fc, summed over ascending d with one rounding per multiply and per
// add.  Both paths score through it, so their scores are the same bits.
template <typename T>
__device__ __forceinline__ void column_dots(const float* qs, const T* fp,
                                            int64_t ft_sd, int fq, int fc,
                                            float (&s)[kTQ]) {
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
}

// The filter's per-column operand: NaN fails every compare (padding, past
// the split); a zero norm becomes FLT_MIN so that a bound of -inf still
// lets the column through.
template <bool EXACT>
__device__ __forceinline__ float filter_operand(bool scored, float cnorm) {
  return !scored ? __int_as_float(0x7fc00000)
         : EXACT ? (cnorm > 0.0f ? cnorm : FLT_MIN)
                 : 0.0f;
}

// The filter: false only where the column's score cannot reach the bound
// (filter_bound) that the operand ch = filter_operand(...) is tested with.
template <bool EXACT>
__device__ __forceinline__ bool passes(float dot, float bnd, float ch) {
  return dot >= (EXACT ? __fmul_rn(bnd, ch) : __fadd_rn(bnd, ch));
}

// The exact score of a column: the guard, the IEEE division (exact mode)
// and the clamp.  The division runs only where the filter let it through.
template <bool EXACT>
__device__ __forceinline__ float column_score(float dot, float qn, float cnorm,
                                              float eps) {
  const float den = __fmul_rn(qn, cnorm);
  return !(den > eps)
             ? 0.0f
             : fminf(fmaxf(EXACT ? __fdiv_rn(dot, den) : dot, -1.0f), 1.0f);
}

// Resident blocks per SM that ptxas is asked to fit: at k <= 32 six
// (80 registers), above it four, the most without a spill (the ptxas
// report of chip_smoke.py's phase 2; five blocks ran slower at k = 64).
template <int KPL>
constexpr int kMinBlocks = KPL == 1 ? 6 : 4;

template <int KPL, bool EXACT, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<KPL>)
    fused_partial_kernel(const T* __restrict__ q,
                         const float* __restrict__ qn,
                         const T* __restrict__ ft, int64_t ft_sd,
                         int64_t ft_sc, const float* __restrict__ cn,
                         const int64_t* __restrict__ excl, int64_t b, int fq,
                         int fc, int64_t np, int64_t valid, int k, float eps,
                         int64_t split_cols, int nsplit,
                         float* __restrict__ pv, int* __restrict__ pc) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [fq][kTQ] query values
  float* lv_all = smem + fq * kTQ;         // [kWarps][kTQ][k] list values
  int* lc_all = reinterpret_cast<int*>(lv_all + kWarps * kTQ * k);
  __shared__ float sqn[kTQ];
  __shared__ int sex[kTQ];
  __shared__ volatile float pub[kTQ][kWarps];  // each warp's ceil(k/4)-th best

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTQ;
  const int split = blockIdx.y;
  const int64_t c_begin = static_cast<int64_t>(split) * split_cols;
  const int64_t c_end =
      c_begin + split_cols < np ? c_begin + split_cols : np;

  load_query_tile(q, qn, excl, b, fq, np, q0, qs, sqn, sex);
  for (int i = t; i < kWarps * kTQ * k; i += kThreads) {
    lv_all[i] = -INFINITY;
    lc_all[i] = -1;
  }
  if (t < kTQ * kWarps) pub[t / kWarps][t % kWarps] = -INFINITY;
  const int kq = (k + kWarps - 1) / kWarps;
  // the filter's bound per query (filter_bound): -inf at first; +inf for
  // a query slot past B, which then never passes
  float bnd[kTQ];
#pragma unroll
  for (int qq = 0; qq < kTQ; ++qq)
    bnd[qq] = q0 + qq < b ? -INFINITY : INFINITY;
  __syncthreads();

  for (int64_t base = c_begin; base < c_end; base += kTC) {
    const int64_t col = base + t;
    const bool live = col < c_end;
    float s[kTQ];
    float cnorm = 0.0f;
    if (live) {
      column_dots(qs, ft + col * ft_sc, ft_sd, fq, fc, s);
      cnorm = __ldg(cn + col);
    } else {
#pragma unroll
      for (int qq = 0; qq < kTQ; ++qq) s[qq] = 0.0f;
    }
    const float ch = filter_operand<EXACT>(live && col < valid, cnorm);
    bool any = false;
#pragma unroll
    for (int qq = 0; qq < kTQ; ++qq) any |= passes<EXACT>(s[qq], bnd[qq], ch);
    if (!__any_sync(kFull, any)) continue;  // the common case
#pragma unroll
    for (int qq = 0; qq < kTQ; ++qq) {
      const bool pass = passes<EXACT>(s[qq], bnd[qq], ch);
      unsigned m = __ballot_sync(kFull, pass);
      if (!m) continue;  // warp-uniform
      float* lv = lv_all + (warp * kTQ + qq) * k;
      int* lc = lc_all + (warp * kTQ + qq) * k;
      float kth = lv[k - 1];
      const float floor_q = block_floor(pub[qq]);
      // the exact score of a column that passed; the division only here
      const float x = pass && col != sex[qq]
                          ? column_score<EXACT>(s[qq], sqn[qq], cnorm, eps)
                          : -INFINITY;
      bool grew = false;
      do {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        const float xv = __shfl_sync(kFull, x, bit);
        if (xv > kth && xv >= floor_q) {
          list_insert<KPL>(lv, lc, k, xv,
                           static_cast<int>(base + 32 * warp + bit), lane);
          kth = lv[k - 1];
          grew = true;
        }
      } while (m);
      if (grew && lane == 0) pub[qq][warp] = lv[kq - 1];
      bnd[qq] = filter_bound<EXACT>(kth, block_floor(pub[qq]), sqn[qq]);
    }
  }
  __syncthreads();

  // fold the 4 warp lists of each query: lane l < kWarps holds the head of
  // warp l's list; k rounds of a pick of the best head
#pragma unroll 1
  for (int w = 0; w < kQPW; ++w) {
    const int qq = warp + w * kWarps;
    const int64_t qg = q0 + qq;
    if (qg >= b) continue;  // warp-uniform
    const int64_t o = (qg * nsplit + split) * k;
    const int src = lane < kWarps ? lane : 0;
    const float* hv = lv_all + (src * kTQ + qq) * k;
    const int* hc = lc_all + (src * kTQ + qq) * k;
    int head = 0;
    for (int r = 0; r < k; ++r) {
      float bv = -INFINITY;
      int bc = INT_MAX;
      int bl = lane;
      if (lane < kWarps && head < k) {
        bv = hv[head];
        bc = hc[head];
      }
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const float ov2 = __shfl_xor_sync(kFull, bv, off);
        const int oc2 = __shfl_xor_sync(kFull, bc, off);
        const int ol2 = __shfl_xor_sync(kFull, bl, off);
        if (ranks_before(ov2, oc2, bv, bc)) {
          bv = ov2;
          bc = oc2;
          bl = ol2;
        }
      }
      bv = __shfl_sync(kFull, bv, 0);
      bc = __shfl_sync(kFull, bc, 0);
      bl = __shfl_sync(kFull, bl, 0);
      if (bv == -INFINITY) {  // every list is spent: unfilled slots
        for (int j = r + lane; j < k; j += 32) {
          pv[o + j] = -INFINITY;
          pc[o + j] = -1;
        }
        break;
      }
      if (lane == bl) ++head;
      if (lane == 0) {
        pv[o + r] = bv;
        pc[o + r] = bc;
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

// ---------------------------------------------------------------- k > 128
//
// The large-k path keeps each (query, split)'s candidates as 64-bit keys
// in a buffer of `cap` entries in device memory (L2-resident while the
// grid's buffers fit the 50 MB L2): see the notes at the top.

typedef unsigned long long u64;

constexpr int kMergeThreads = 512;      // one block per query
constexpr int kU = 4;                   // keys a thread per select step
constexpr int kSortSmemKeys = 8192;     // the merge sorts in shared memory
                                        // up to this (64 KB), else in place

// A score's key: its order-preserving bits (-0.0 made +0.0 first) in the
// high word; in the low word the inverted column shifted up by one, and in
// bit 0 whether the score was -0.0.  Keys order as (value descending,
// column ascending) does, no two columns share one, and 0 is below every
// key of a score in [-1, 1] (the empty slot).
__device__ __forceinline__ u64 score_key(float x, int col) {
  unsigned bits = __float_as_uint(x);
  const unsigned neg_zero = bits == 0x80000000u;
  if (neg_zero) bits = 0u;
  const unsigned ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  const unsigned low =
      ((0x7fffffffu - static_cast<unsigned>(col)) << 1) | neg_zero;
  return (static_cast<u64>(ord) << 32) | low;
}

__device__ __forceinline__ float key_value(u64 key) {
  if (key & 1ull) return -0.0f;
  const unsigned ord = static_cast<unsigned>(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord ^ 0x80000000u) : ~ord);
}

__device__ __forceinline__ int key_column(u64 key) {
  return static_cast<int>(0x7fffffffu - (static_cast<unsigned>(key) >> 1));
}

// Shared scratch of the block-wide select and compaction.
struct SelectShared {
  int hist[256];
  int wsum[32];          // kept keys per warp in a compaction chunk
  int digit, above, dcount, total;
  u64 kmin;              // the least key a compaction kept
};

// Warp 0: the digit d of the pass's histogram that holds the need-th key
// from the top (above: the keys in higher digits; dcount: hist[d]) and
// the pass's total.
__device__ __forceinline__ void find_digit(SelectShared& sh, int need) {
  const int lane = threadIdx.x;
  int c[8];
  int local = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = sh.hist[255 - (8 * lane + i)];
    local += c[i];
  }
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  int run = incl - local;
  if (lane == 31) sh.total = incl;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (run < need && run + c[i] >= need) {
      sh.digit = 255 - (8 * lane + i);
      sh.above = run;
      sh.dcount = c[i];
    }
    run += c[i];
  }
}

// Block-wide radix select over the nonzero keys p[s * stride + j], s <
// nseg, j < len (nseg * len < 2^31): the least key T such that exactly
// `need` of them are >= T (8-bit digits from the top, each pass counting
// only the keys that share the digits found so far, until the digit's
// keys are exactly the ones still needed), or 1 where they number `need`
// or fewer.  Keys are unique, so the last pass at the latest ends it.
template <int NT>
__device__ __forceinline__ u64 select_threshold(const u64* p, int nseg,
                                                int64_t stride, int len,
                                                int need, SelectShared& sh) {
  const int t = threadIdx.x;
  const int n = nseg * len;
  u64 prefix = 0, mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += NT) sh.hist[i] = 0;
    __syncthreads();
    // the segments' keys in one run (short segments would leave most of
    // a step idle); block-uniform trip count, kU keys a thread a step,
    // loaded together
    for (int i0 = 0; i0 < n; i0 += kU * NT) {
      u64 key[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * NT + t;
        key[u] = i < n ? p[(i / len) * stride + i % len] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int bin = key[u] != 0 && (key[u] & mask) == prefix
                            ? static_cast<int>((key[u] >> shift) & 255)
                            : -1;
        // one atomic per distinct digit in the warp: the first passes'
        // keys crowd into a few digits
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin >= 0 && (t & 31) == __ffs(peers) - 1)
          atomicAdd(&sh.hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (t < 32) find_digit(sh, need);
    __syncthreads();
    if (shift == 56 && sh.total <= need) return 1;
    need -= sh.above;
    prefix |= static_cast<u64>(sh.digit) << shift;
    mask |= 0xffull << shift;
    if (sh.dcount == need) return prefix;
  }
  return prefix;
}

// Block-wide: move the keys >= t (t >= 1) of the segments, in reading
// order (segment by segment), to dst[0..), and their least key to
// sh.kmin; returns how many.  Chunks of kU * NT keys (kU consecutive ones
// a thread) are read, then written after a barrier at their places by a
// block-wide scan, so dst may be p itself: the i-th key read lies at or
// after p[i] (stride >= len) and goes to a place at or before dst[i],
// already read.
template <int NT>
__device__ __forceinline__ int compact(const u64* p, int nseg,
                                       int64_t stride, int len, u64 t_key,
                                       u64* dst, SelectShared& sh) {
  constexpr int kW = NT / 32;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) sh.kmin = ~0ull;
  const int n = nseg * len;
  int out = 0;
  u64 kmin = ~0ull;
  for (int i0 = 0; i0 < n; i0 += kU * NT) {
    u64 key[kU];
    int m = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + kU * t + u;
      key[u] = i < n ? p[(i / len) * stride + i % len] : 0ull;
      m += key[u] >= t_key;
    }
    int incl = m;  // the warp's inclusive scan of the kept counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) sh.wsum[warp] = incl;
    __syncthreads();
    int pos = out + incl - m, total = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int c = sh.wsum[w];
      pos += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (key[u] >= t_key) {
        dst[pos++] = key[u];
        kmin = key[u] < kmin ? key[u] : kmin;
      }
    }
    out += total;
    __syncthreads();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, kmin, off);
    kmin = o < kmin ? o : kmin;
  }
  if (lane == 0) atomicMin(&sh.kmin, kmin);
  __syncthreads();
  return out;
}

// Block-wide bitonic sort of a[0..P), P a power of two, descending; `a`
// in shared or in device memory (a barrier makes either visible).
template <int NT>
__device__ __forceinline__ void sort_desc(u64* a, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += NT) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 x = a[lo], y = a[hi];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Cut a partial kernel's buffer of *cnt keys at row back to its k best;
// *thr becomes the k-th key's value.  Block-wide (kThreads).
__device__ __forceinline__ void cut_buffer(u64* row, int k, int* cnt,
                                           float* thr, SelectShared& sh) {
  const int c = *cnt;
  const u64 t_key = select_threshold<kThreads>(row, 1, 0, c, k, sh);
  compact<kThreads>(row, 1, 0, c, t_key, row, sh);
  if (threadIdx.x == 0) {
    *cnt = k;
    *thr = key_value(sh.kmin);
  }
  __syncthreads();
}

// The large-k partial kernel: the same grid, block, query tile, scores and
// filter as fused_partial_kernel, one list per query instead of four warp
// lists: every column of the split that passes the filter against the
// query's threshold t and scores above it is appended to the query's
// buffer (keys[(q * nsplit + split) * cap ...], a shared-memory count per
// query: lane qq of a warp reserves query qq's slots, one atomic a warp
// and tile for the 16 queries), and a buffer that may not take
// another tile is cut back to its k best (select_threshold, then compact)
// after the tile, at a block barrier, t becoming its k-th key's value.
// The split's columns arrive tile by tile in ascending order and t moves
// only between tiles, so a column scoring exactly t ranks below the
// entry that set it: `x > t` keeps every column of the split's top k (the
// small-k kernel's `>`), and the filter passes every x >= t.  At the end
// each query's first k slots hold its split's top k, unsorted, and 0 in
// the slots it could not fill: the merge selects and sorts.
template <bool EXACT, typename T>
__global__ void __launch_bounds__(kThreads)
    fused_large_partial_kernel(const T* __restrict__ q,
                               const float* __restrict__ qn,
                               const T* __restrict__ ft, int64_t ft_sd,
                               int64_t ft_sc, const float* __restrict__ cn,
                               const int64_t* __restrict__ excl, int64_t b,
                               int fq, int fc, int64_t np, int64_t valid,
                               int k, float eps, int64_t split_cols,
                               int nsplit, int64_t cap, u64* keys) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [fq][kTQ] query values
  __shared__ float sqn[kTQ];
  __shared__ int sex[kTQ];
  __shared__ int cnt[kTQ];                 // keys in each query's buffer
  __shared__ float thr[kTQ];               // each query's threshold t
  __shared__ int full;                     // a buffer passed `limit`
  __shared__ SelectShared sh;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTQ;
  const int split = blockIdx.y;
  const int64_t c_begin = static_cast<int64_t>(split) * split_cols;
  const int64_t c_end =
      c_begin + split_cols < np ? c_begin + split_cols : np;
  // a buffer at or below `limit` takes one more tile of kTC columns
  const int limit = static_cast<int>(cap) - kTC;

  load_query_tile(q, qn, excl, b, fq, np, q0, qs, sqn, sex);
  if (t < kTQ) {
    cnt[t] = 0;
    thr[t] = -INFINITY;
  }
  if (t == 0) full = 0;
  float bnd[kTQ];
#pragma unroll
  for (int qq = 0; qq < kTQ; ++qq)
    bnd[qq] = q0 + qq < b ? -INFINITY : INFINITY;
  __syncthreads();

  for (int64_t base = c_begin; base < c_end; base += kTC) {
    const int64_t col = base + t;
    const bool live = col < c_end;
    float s[kTQ];
    float cnorm = 0.0f;
    if (live) {
      column_dots(qs, ft + col * ft_sc, ft_sd, fq, fc, s);
      cnorm = __ldg(cn + col);
    } else {
#pragma unroll
      for (int qq = 0; qq < kTQ; ++qq) s[qq] = 0.0f;
    }
    const float ch = filter_operand<EXACT>(live && col < valid, cnorm);
    bool any = false;
#pragma unroll
    for (int qq = 0; qq < kTQ; ++qq) any |= passes<EXACT>(s[qq], bnd[qq], ch);
    if (__any_sync(kFull, any)) {
      // the entering lanes per query (s[qq] becomes the exact score), then
      // lane qq reserves query qq's slots: one atomic a warp and tile
      unsigned em[kTQ];
      int mine = 0;
#pragma unroll
      for (int qq = 0; qq < kTQ; ++qq) {
        const bool pass = passes<EXACT>(s[qq], bnd[qq], ch);
        em[qq] = 0u;
        if (__ballot_sync(kFull, pass)) {  // warp-uniform
          s[qq] = pass && col != sex[qq]
                      ? column_score<EXACT>(s[qq], sqn[qq], cnorm, eps)
                      : -INFINITY;
          em[qq] = __ballot_sync(kFull, s[qq] > thr[qq]);
        }
        if (lane == qq) mine = __popc(em[qq]);
      }
      int at = 0;
      if (mine) {
        at = atomicAdd(&cnt[lane], mine);
        if (at + mine > limit) full = 1;
      }
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int qq = 0; qq < kTQ; ++qq) {
        if (!em[qq]) continue;  // warp-uniform
        const int base_q = __shfl_sync(kFull, at, qq);
        if (em[qq] >> lane & 1u)
          keys[((q0 + qq) * nsplit + split) * cap + base_q +
               __popc(em[qq] & below)] = score_key(s[qq],
                                                   static_cast<int>(col));
      }
    }
    __syncthreads();
    if (full) {  // block-uniform: read after the barrier, reset after two
      for (int qq = 0; qq < kTQ; ++qq)
        if (cnt[qq] > limit)
          cut_buffer(keys + ((q0 + qq) * nsplit + split) * cap, k,
                     &cnt[qq], &thr[qq], sh);
      __syncthreads();
      if (t == 0) full = 0;
#pragma unroll
      for (int qq = 0; qq < kTQ; ++qq)
        bnd[qq] = q0 + qq < b
                      ? filter_bound<EXACT>(thr[qq], -INFINITY, sqn[qq])
                      : INFINITY;
      __syncthreads();
    }
  }
  __syncthreads();

  for (int qq = 0; qq < kTQ && q0 + qq < b; ++qq) {
    const int c = cnt[qq];
    u64* row = keys + ((q0 + qq) * nsplit + split) * cap;
    if (c > k) cut_buffer(row, k, &cnt[qq], &thr[qq], sh);
    for (int j = (c < k ? c : k) + t; j < k; j += kThreads) row[j] = 0ull;
  }
}

// One block per query: the top k of its nsplit partial lists (k keys each
// at stride cap, 0 = empty) by select_threshold, compacted into the first
// split's slots, sorted (in shared memory when the launch gives it
// sort_keys >= P keys, else in those slots: cap >= P), and written out as
// (value, column), unfilled slots (-inf, -1).
__global__ void __launch_bounds__(kMergeThreads)
    fused_large_merge_kernel(u64* keys, int nsplit, int64_t cap, int k,
                             int sort_keys, float* __restrict__ ov,
                             int64_t* __restrict__ oi) {
  extern __shared__ u64 sorted[];
  __shared__ SelectShared sh;
  const int t = threadIdx.x;
  const int64_t qg = blockIdx.x;
  u64* row = keys + qg * nsplit * cap;
  const u64 t_key =
      select_threshold<kMergeThreads>(row, nsplit, cap, k, k, sh);
  const int c = compact<kMergeThreads>(row, nsplit, cap, k, t_key, row, sh);
  int P = 1;
  while (P < c) P <<= 1;
  u64* a = P <= sort_keys ? sorted : row;
  for (int i = t; i < P; i += kMergeThreads) a[i] = i < c ? row[i] : 0ull;
  __syncthreads();
  sort_desc<kMergeThreads>(a, P);
  for (int j = t; j < k; j += kMergeThreads) {
    const u64 key = j < c ? a[j] : 0ull;
    ov[qg * k + j] = key ? key_value(key) : -INFINITY;
    oi[qg * k + j] = key ? static_cast<int64_t>(key_column(key)) : -1;
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
  void* pv;              // the large-k path: its keys (b, nsplit, cap)
  void* pc;
  int64_t cap;           // the large-k path's buffer slots per (query, split)
};

// Launch the partial kernel instance for (KPL, EXACT, T), or, with
// blocks_per_sm, write how many of its blocks an SM holds at once instead.
template <int KPL, bool EXACT, typename T>
int launch_partial(const Args& a, cudaStream_t stream, int* blocks_per_sm) {
  // the query tile, then the warp lists' values and columns
  const size_t smem =
      sizeof(float) * static_cast<size_t>(a.fq) * kTQ +
      (sizeof(float) + sizeof(int)) * static_cast<size_t>(kWarps) * kTQ * a.k;
  auto kernel = fused_partial_kernel<KPL, EXACT, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks_per_sm)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, smem));
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
int launch_k(const Args& a, cudaStream_t s, int* blocks_per_sm) {
  if (a.k <= 32) return launch_partial<1, EXACT, T>(a, s, blocks_per_sm);
  if (a.k <= 64) return launch_partial<2, EXACT, T>(a, s, blocks_per_sm);
  return launch_partial<4, EXACT, T>(a, s, blocks_per_sm);
}

int launch(const Args& a, bool exact, bool bf16, cudaStream_t s,
           int* blocks_per_sm) {
  return bf16    ? launch_k<false, __nv_bfloat16>(a, s, blocks_per_sm)
         : exact ? launch_k<true, float>(a, s, blocks_per_sm)
                 : launch_k<false, float>(a, s, blocks_per_sm);
}

// The large-k partial kernel instance for (EXACT, T), or its blocks per SM.
template <bool EXACT, typename T>
int launch_large(const Args& a, cudaStream_t stream, int* blocks_per_sm) {
  const size_t smem = sizeof(float) * static_cast<size_t>(a.fq) * kTQ;
  auto kernel = fused_large_partial_kernel<EXACT, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks_per_sm)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, smem));
  const dim3 grid(static_cast<unsigned>((a.b + kTQ - 1) / kTQ),
                  static_cast<unsigned>(a.nsplit));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const float*>(a.qn),
      static_cast<const T*>(a.ft), a.ft_sd, a.ft_sc,
      static_cast<const float*>(a.cn), static_cast<const int64_t*>(a.excl),
      a.b, a.fq, a.fc, a.np, a.valid, a.k, a.eps, a.split_cols, a.nsplit,
      a.cap, static_cast<u64*>(a.pv));
  return static_cast<int>(cudaGetLastError());
}

int launch_large_any(const Args& a, bool exact, bool bf16, cudaStream_t s,
                     int* blocks_per_sm) {
  return bf16    ? launch_large<false, __nv_bfloat16>(a, s, blocks_per_sm)
         : exact ? launch_large<true, float>(a, s, blocks_per_sm)
                 : launch_large<false, float>(a, s, blocks_per_sm);
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
  const int err = launch(a, exact, bf16, s, nullptr);
  if (err != 0) return err;
  const int64_t blocks = (b + kMergeWarps - 1) / kMergeWarps;
  fused_merge_kernel<<<static_cast<unsigned>(blocks), kMergeWarps * 32, 0,
                       s>>>(static_cast<const float*>(pv),
                            static_cast<const int*>(pc), b, a.nsplit, a.k,
                            static_cast<float*>(ov),
                            static_cast<int64_t*>(oi));
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the partial kernel that srt_fused_topk launches for
// (fq, k, exact, bf16) an SM holds at once, into *out (int).  Returns a
// cudaError_t.
extern "C" int srt_fused_blocks_per_sm(int64_t fq, int64_t k, int64_t exact,
                                       int64_t bf16, void* out) {
  if (k < 1 || k > 128 || fq < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.fq = static_cast<int>(fq);
  a.k = static_cast<int>(k);
  return launch(a, exact, bf16, nullptr, static_cast<int*>(out));
}

// The large-k path (any k >= 1; the wrapper takes it for k > 128): the
// arguments of srt_fused_topk, with keys (b, nsplit, cap) u64 scratch in
// place of pv / pc; cap >= k + 128 and cap >= the least power of two >= k.
// Returns cudaGetLastError().
extern "C" int srt_fused_topk_large(
    const void* q, const void* qn, const void* ft, int64_t ft_sd,
    int64_t ft_sc, const void* cn, const void* excl, int64_t b, int64_t fq,
    int64_t fc, int64_t np, int64_t valid, int64_t k, int64_t exact,
    int64_t bf16, float eps, int64_t nsplit, int64_t split_cols, int64_t cap,
    void* keys, void* ov, void* oi, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  int64_t p2 = 1;
  while (p2 < k) p2 <<= 1;
  if (k < 1 || k > (INT_MAX >> 2) || cap < k + kTC || cap < p2 ||
      cap > (INT_MAX >> 1) || nsplit < 1 || nsplit > 65535 ||
      nsplit * k >= INT_MAX || fc < 1 ||
      (fq != fc && !(bf16 && fq == 2 * fc)) || (bf16 && exact) ||
      np >= INT_MAX || split_cols * nsplit < np || b > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q, qn, ft, ft_sd, ft_sc, cn, excl, b,
         static_cast<int>(fq), static_cast<int>(fc), np, valid,
         static_cast<int>(k), eps, static_cast<int>(nsplit),
         split_cols, keys, nullptr, cap};
  const int err = launch_large_any(a, exact, bf16, s, nullptr);
  if (err != 0) return err;
  const int sort_keys = p2 <= kSortSmemKeys ? static_cast<int>(p2) : 0;
  const size_t smem = sizeof(u64) * static_cast<size_t>(sort_keys);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_large_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_large_merge_kernel<<<static_cast<unsigned>(b), kMergeThreads, smem,
                             s>>>(static_cast<u64*>(keys), a.nsplit, cap,
                                  a.k, sort_keys, static_cast<float*>(ov),
                                  static_cast<int64_t*>(oi));
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the large-k partial kernel for (fq, exact, bf16) an
// SM holds at once, into *out (int).  Returns a cudaError_t.
extern "C" int srt_fused_large_blocks_per_sm(int64_t fq, int64_t exact,
                                             int64_t bf16, void* out) {
  if (fq < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.fq = static_cast<int>(fq);
  return launch_large_any(a, exact, bf16, nullptr, static_cast<int*>(out));
}
