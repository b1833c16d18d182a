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
//   dot(q, c)  = sum over d = 0..Fq-1, ascending, of q[d]*f[d mod Fc][c].
//                fp32 storage: one rounding per multiply and one per add
//                (__fmul_rn / __fadd_rn, which nvcc never contracts into
//                an FMA).  bf16 storage: the first product rounded, then
//                each next one added with one fused multiply-add
//                (__fmaf_rn); a product of two bf16 values is exact in fp32
//                above 2^-134, so the two chains differ only below it.  The
//                plain torch version (ops/cuda/fused.py) takes the same
//                steps and is bitwise equal.  Storage (the TPU kernel's
//                `is_bf16` branch, :112-136): fp32 (Fq = Fc = F); bf16 (Fq
//                = Fc = F); bf16x2, queries [qh, ql, ql, qh] (Fq = 4F)
//                against planes [hi; lo] (Fc = 2F) or [hi; lo; hi; lo] (Fc
//                = 4F): the same products in the same order either way
//   den        = qn * cn              (the raw norms, in both modes)
//   score      = den > eps ? clamp(dot / den, -1, 1) : 0     exact mode
//                den > eps ? clamp(dot, -1, 1)       : 0     prenormalized
//                (IEEE division, __fdiv_rn; no fast math)
//   columns >= valid and the query's excluded column score -inf after the
//   clamp and never enter the top-k;
//   out: the top-k (value, column) by value descending, lowest column first
//   on equal values; unfilled slots hold (-inf, -1).
//
// What bounds it on an H100: fp32 issue.  B x Np x Fq multiplies and as
// many adds (fp32: one instruction per flop; bf16: one FFMA a product),
// plus the filter per (query, column): at B = 1024, Np = 1M, F = 12 that is
// 25 G fp32 instructions (0.70 ms of issue on 132 SMs), against 48 bytes of
// catalog per column.  At B = 1 the catalog's bytes bound it (48 MB, 14 us),
// and the walk must keep enough of them in flight on every SM.  The top-k
// is cheap once a query's k-th best value has risen above almost every new
// score, as long as the scores that cannot enter cost no more than a
// compare.
//
// Design (both partial kernels share the walk, the dots and the filter):
//
// - the grid is (query tiles of TQ) x (catalog splits).  A split is a
//   contiguous range of whole 128-column groups; the wrapper sizes the
//   splits so that the grid fills one wave of the card's resident blocks
//   (srt_fused_blocks_per_sm), and takes TQ = 4 up to B = 128 (the
//   wrapper's SMALL_BATCH): fewer registers, four blocks an SM and no
//   slots past B, which beat TQ = 16 there on an H100;
// - the walk: a block of 4 warps walks its split in chunks of U groups of
//   128 columns (U x 128 columns).  Each chunk's catalog rows are copied
//   into shared memory through a ring of kStages stages with cp.async
//   (commit / wait groups) while the chunk before it is scored: the loads
//   no longer wait one after another in the dot loop, and B = 1 keeps its
//   catalog bytes in flight.  A chunk wider than kStageBytes is cut into
//   row blocks of equal height, one stage each.  The copies are 16-byte
//   where the catalog's base and row stride allow it, else 8- or 4-byte,
//   else (a row-major window read through `.t()`, a bf16 catalog at an odd
//   column) one value a copy; copies stop at the split's end;
// - the dots: thread l scores column 128g + l of each group g of the chunk
//   against the block's TQ queries, whose values sit in shared memory as
//   float4 broadcasts ([d][TQ], loaded once); it keeps U x TQ sums in
//   registers, so each float4 of query values feeds 4U products, and reads
//   its columns of a stage row at l, l + 128, ..., conflict-free;
// - each warp copies the stage columns its own lanes read (32 of each
//   group) and waits for its own copies only, so the walk has no block
//   barrier: a warp busy with inserts delays no other (a block barrier
//   per chunk cost the warp lists 0.35 ms of device time at B = 1024, k =
//   10 on an H100: 3.063 against 2.718);
// - the tiling (U, the blocks an SM must hold, so the register cap) is
//   fixed per instance in `tile()`, chosen on the card (PERF.md, kernel 3);
// - after a chunk's dots its groups go through the filter, the ballots,
//   the exact score and the insert in ascending g, so each warp still
//   sees its columns (32w + lane of each group) in ascending order, which
//   the tie rules below rest on;
// - warp-private lists (k <= kListsMaxK = 64): for each of the TQ queries
//   every warp
//   keeps its own running top-k (value descending, column ascending) over
//   its own columns, in shared memory ([warp][query][k] values and
//   columns); an insert is rare once a list has filled.  The wrapper's
//   route (ops/cuda/fused.fused_route) sends them k up to a limit that
//   depends on B and is at most 64: above it the large-k path won at every
//   batch measured on an H100 (PERF.md, kernel 3);
// - the filter sits in the warp that just scored, and costs a multiply and
//   a compare per (query, column) (an add and a compare prenormalized): a
//   column passes for query qq if dot >= rn(bound[qq] * ch), with ch the
//   column's norm and bound from filter_bound (below): -inf at first,
//   +inf for a query slot past B.  One __any_sync over the group's TQ
//   queries skips the rest in the common case; otherwise one __ballot_sync
//   per query, and only the set bits get their exact score (the guard, the
//   IEEE division, the clamp, the exclusion) and, in ascending lane order,
//   go through list_insert if it beats the k-th best.  That rare path runs
//   once per group as a loop over the queries, reading the group's scores
//   from a per-warp scratch in shared memory (take_group): unrolled over
//   U x TQ (sum, group) pairs it was ~16,000 instructions of code, and
//   each insert ran cold out of the instruction cache (on an H100 the
//   selection then took 4.1 of the 5.7 ms of B = 1024, k = 10);
// - the block's floor: each warp publishes, per query, the ceil(k/4)-th
//   best value of its list in shared memory.  The 4 warps' lists then hold
//   at least k columns at or above the least of the 4 values, so a column
//   below it is in no top-k of the split, and no warp needs to keep it.
//   The floor only rises, and a warp may read it late;
// - strict `>` against the warp's own k-th value, `>=` against the floor,
//   and an insert after the entries >= the new value keep the lowest column
//   first on equal values, because a warp's columns arrive in ascending
//   order (as the TPU's sequential grid and its `>=` insert count do);
// - after the walk the block folds its 4 warp lists per query (k rounds of
//   a pick of the best list head) and writes the split's top-k as 64-bit
//   keys (score_key, below; 0 for an unfilled slot);
// - one merge for both paths: a block per query selects the top k of its
//   nsplit lists' keys with a block-wide radix select and sorts them, so
//   the split count has no limit of its own (the warp merge it replaces
//   took 4 lists a lane, 128 splits, and held B = 1 to 128 blocks).
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
//   the split carry ch = NaN and never pass (their dots come from whatever
//   the stage held); the excluded column passes at most once per walk and
//   its exact score is -inf.  The domain: finite dots, and norms whose
//   product is finite.
//
// The warp lists grow with k (four lists per query, 16 queries, [4][16][k]
// x 8 bytes: 512 KB at k = 1000 against the 227 KB a block may use), their
// inserts and their fold (k rounds) with it.  The large-k path (any k; the
// wrapper's route takes it by (k, B), always above k = 64):
//
// - the same grid, block, walk, dots, filter and exact score;
// - one candidate buffer per (query, split) of `cap` 64-bit keys in device
//   memory (the wrapper's cap = 2k rounded up to 128, at least 384: 16 KB
//   a query at k = 1000), and a threshold t per query, -inf at first.  A
//   column whose score x > t is appended (a shared-memory count per query,
//   one atomic a warp and group for its TQ queries); the filter is
//   filter_bound's with t and no floor;
// - the key: the score's order-preserving bits (-0.0 made +0.0, as the
//   plain version ranks them equal) in the high word, the inverted column
//   in the low word (and the sign of a zero in its last bit, so that the
//   value comes back as it was scored).  Keys are unique and order as the
//   plain version does: value descending, lowest column first;
// - after each group of 128 columns, at a block barrier, a buffer that may
//   not take another group (more than cap - 128 keys) is cut back to its k
//   best by a block-wide radix select over the keys (8-bit digits from the
//   top, until the digit holds exactly the keys still needed) and an
//   in-place compaction, and t becomes the k-th key's value;
// - the scratch is (B, nsplit, cap) keys.  The wrapper (_large_plan) sizes
//   it to one wave of resident blocks but at most max(64 MiB, the buffers
//   of four blocks per SM), and never above LARGE_SCRATCH_CEILING = 512 MiB
//   (only one block's buffers may pass it, past k = 2^21): at large k and B
//   fewer splits, then batch chunks, keep it there.  A split is at least 8k
//   columns wide, so that the merge's input stays near the split's.
//
// Limits: column indices below 2^31; the warp lists k <= 64, the large-k
// path any k >= 1; nsplit x k below 2^31 and at most 65535 splits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = kThreads;        // columns a group: one per thread
constexpr int kStages = 2;              // depth of the shared-memory ring
constexpr int kStageBytes = 32 * 1024;  // most bytes of one stage
constexpr int kMergeThreads = 512;      // one block per query
constexpr int kMaxGridY = 65535;
constexpr int kListsMaxK = 64;          // the warp lists' largest k
constexpr float kTinyT = 0x1p-60f;      // below it the filter lets all through
constexpr float kShrink = 1.0f - 0x1p-22f;  // the exact filter's margin

// An instance's tiling: U groups a thread scores per chunk and the blocks
// an SM must hold (ptxas caps the registers to fit).  The warp lists at k
// <= 32 keep U x TQ = 64 sums beside the 16 bounds in ~150 registers
// (three blocks an SM); at k <= 64 their 32 KB of lists hold two blocks an
// SM anyway.  The large-k path pays a block barrier per group, and more
// resident blocks hide it better than wider chunks: U = 2 at four blocks
// an SM (3.92 against 4.36 ms at U = 4, three blocks, B = 1024, k = 10).
// The 4-query tile (B <= SMALL_BATCH) takes U = 4: its sums are few, and a
// wide chunk keeps more catalog bytes in flight.  Chosen on the card
// (PERF.md, kernel 3); to try another, edit this table and the wrapper's
// mirror (ops/cuda/fused.tile) and time it against the parent with
// tools/fused_k_sweep.py --checkout.
struct Tile {
  int u, min_blocks;
};
__host__ __device__ constexpr Tile tile(bool large, int kpl, int tq) {
  return tq == 4 ? Tile{4, 4}
         : large ? Tile{2, 4}
         : kpl == 2 ? Tile{4, 2}
                    : Tile{4, 3};
}

// The stage ring's geometry for storage T and U groups: a stage row holds
// U x 128 columns and 16 bytes of padding (so that a copy of one value a
// column from a row-major window spreads over the banks), and a stage at
// most kStageBytes of rows.
template <typename T, int U>
struct Geom {
  static constexpr int kWidth = U * kGroup;                 // columns a chunk
  static constexpr int kRow = kWidth + 16 / static_cast<int>(sizeof(T));
  static constexpr int kMaxRows =
      kStageBytes / (kRow * static_cast<int>(sizeof(T)));
  static_assert(kMaxRows >= 1, "a stage row exceeds kStageBytes");
};

// catalog rows of one stage for fc rows: the fewest row blocks of at most
// max_rows rows, of equal height
__host__ __device__ constexpr int stage_rows(int fc, int max_rows) {
  return (fc + (fc + max_rows - 1) / max_rows - 1) /
         ((fc + max_rows - 1) / max_rows);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc + q * x as the instance's chain rounds it (see the top of the file)
template <typename T>
__device__ __forceinline__ float mac(float q, float x, float acc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __fmaf_rn(q, x, acc);
  else
    return __fadd_rn(acc, __fmul_rn(q, x));
}

// One cp.async of `vec` bytes (16, 8 or 4) of which the first `bytes` are
// read from src and the rest of dst zero-filled.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int vec,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The calling warp's slice of catalog rows [r0, r0 + nr) of chunk columns
// [col0, col0 + ncol) into the stage st[r - r0][Geom::kRow]: the columns
// its lanes score, 128u + 32w + lane of each group u, and only those, so
// that a warp waits for its own copies alone (no block barrier in the
// walk).  With vec (bytes, the catalog's columns contiguous, its base and
// row stride multiples of vec): vector copies along each row, the last one
// cut at ncol.  Without: one value a copy, in the order the catalog holds
// them (down a column first where its rows are adjacent, a row-major
// window), by cp.async for fp32 and by a load and a store for bf16
// (cp.async copies at least 4 bytes).  Columns past ncol keep what the
// stage held.
template <typename T, int U>
__device__ __forceinline__ void load_stage(T* st, const T* __restrict__ ft,
                                           int64_t sd, int64_t sc,
                                           int64_t col0, int ncol, int r0,
                                           int nr, int vec) {
  using G = Geom<T, U>;
  constexpr int kSlice = U * 32;               // the warp's columns a row
  const int lane = threadIdx.x & 31;
  const int wcol = 32 * (threadIdx.x >> 5);    // its first column a group
  if (vec) {
    // vpg vectors a group's 32 columns; tpr lanes a row (a power of two),
    // each copying every tpr-th of the row's U x vpg vectors; a lane's
    // rows step by 32 / tpr
    const int per = vec / static_cast<int>(sizeof(T));
    const int vpg = 32 / per;
    const int gshift = __ffs(vpg) - 1;
    const int nvw = U * vpg;
    const int tpr = nvw < 32 ? nvw : 32;
    const int shift = __ffs(tpr) - 1;
    const int rstep = 32 >> shift;
    int r = lane >> shift;
    const T* src = ft + (r0 + r) * sd + col0;
    T* dst = st + r * G::kRow;
    for (; r < nr; r += rstep, src += rstep * sd, dst += rstep * G::kRow)
      for (int v = lane & (tpr - 1); v < nvw; v += tpr) {
        const int c = (v >> gshift) * kGroup + wcol + (v & (vpg - 1)) * per;
        if (c < ncol)
          cp_async(dst + c, src + c, vec,
                   c + per <= ncol
                       ? vec
                       : (ncol - c) * static_cast<int>(sizeof(T)));
      }
    return;
  }
  const bool down = sd == 1;                   // a column's rows adjacent
  const int n = nr * kSlice;
  int r = down ? lane % nr : lane / kSlice;
  int j = down ? lane / nr : lane % kSlice;    // the slice's column
  const int dr = down ? 32 % nr : 0;
  const int dj = down ? 32 / nr : 32;
  for (int i = lane; i < n; i += 32) {
    const int c = (j >> 5) * kGroup + wcol + (j & 31);
    if (c < ncol) {
      const T* src = ft + (r0 + r) * sd + (col0 + c) * sc;
      T* dst = st + r * G::kRow + c;
      if constexpr (std::is_same<T, float>::value)
        cp_async(dst, src, 4, 4);
      else
        *dst = __ldg(src);
    }
    if (down) {
      r += dr;
      j += dj;
      if (r >= nr) {
        r -= nr;
        ++j;
      }
    } else {
      j += dj;
      if (j >= kSlice) {
        j -= kSlice;
        ++r;
      }
    }
  }
}

// The walk of one split: its chunks of U groups, each one item (the whole
// catalog row range in one stage) or, where the rows take more than one
// stage, `npass` x `nb` items (each row block once per pass over the
// query's Fq = npass x Fc values), copied kStages - 1 items ahead of the
// one being scored.
template <typename T, int U>
struct Walk {
  using G = Geom<T, U>;
  T* ring;
  const T* ft;
  int64_t sd, sc, c_begin, c_end;
  int fc, vec, rows, nb, ipc, items;
  int next = 0, next_st = 0, st = 0;

  __device__ Walk(T* ring_, const T* ft_, int64_t sd_, int64_t sc_,
                  int64_t c_begin_, int64_t c_end_, int fc_, int npass,
                  int vec_)
      : ring(ring_), ft(ft_), sd(sd_), sc(sc_), c_begin(c_begin_),
        c_end(c_end_), fc(fc_), vec(vec_) {
    rows = stage_rows(fc, G::kMaxRows);
    nb = (fc + rows - 1) / rows;
    ipc = nb == 1 ? 1 : npass * nb;
    const int64_t span = c_end - c_begin;
    items = span > 0 ? static_cast<int>((span + G::kWidth - 1) / G::kWidth) *
                           ipc
                     : 0;
  }

  // the next item's copies into the next stage; an empty group past the
  // last item keeps the count of groups in flight
  __device__ __forceinline__ void issue() {
    if (next < items) {
      const int chunk = ipc == 1 ? next : next / ipc;
      const int rb = nb == 1 ? 0 : (next - chunk * ipc) % nb;
      const int64_t col0 = c_begin + static_cast<int64_t>(chunk) * G::kWidth;
      const int64_t left = c_end - col0;
      const int r0 = rb * rows;
      load_stage<T, U>(ring + next_st * rows * G::kRow, ft, sd, sc, col0,
                       left < G::kWidth ? static_cast<int>(left) : G::kWidth,
                       r0, fc - r0 < rows ? fc - r0 : rows, vec);
      ++next;
      if (++next_st == kStages) next_st = 0;
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int s = 0; s + 1 < kStages; ++s) issue();
  }

  // the next item's stage, once the warp's copies of it have landed and
  // its lanes have left the stage the next copy overwrites (each warp
  // copies and reads its own columns only: no block barrier)
  __device__ __forceinline__ const T* take() {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue();
    const T* s = ring + st * rows * G::kRow;
    if (++st == kStages) st = 0;
    return s;
  }
};

// acc[u][j] (+)= the product of query value d (qd = qs + d * TQ) for query
// j and x[u * 128], the thread's column of group u in a stage row; with
// kFirst, acc = the product, the chain's first step
template <typename T, int TQ, int U, bool kFirst = false>
__device__ __forceinline__ void dot_row(const float* qd, const T* x,
                                        float (&acc)[U][TQ]) {
  float xv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) xv[u] = to_float(x[u * kGroup]);
  const float4* q4 = reinterpret_cast<const float4*>(qd);
#pragma unroll
  for (int j = 0; j < TQ / 4; ++j) {
    const float4 a = q4[j];
    const float qv[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[u][4 * j + e] = kFirst ? __fmul_rn(qv[e], xv[u])
                                   : mac<T>(qv[e], xv[u], acc[u][4 * j + e]);
  }
}

// The dots of one chunk: acc[u][j] = the chain of query j with the
// thread's column of group u, over the chunk's items in ascending d.
template <typename T, int TQ, int U>
__device__ __forceinline__ void chunk_dots(Walk<T, U>& w, const float* qs,
                                           int npass, float (&acc)[U][TQ]) {
  using G = Geom<T, U>;
  const int t = threadIdx.x;
  for (int j = 0; j < w.ipc; ++j) {
    const T* stage = w.take() + t;
    const int p0 = w.nb == 1 ? 0 : j / w.nb;
    const int r0 = w.nb == 1 ? 0 : (j - p0 * w.nb) * w.rows;
    const int nr = w.fc - r0 < w.rows ? w.fc - r0 : w.rows;
    const int reps = w.nb == 1 ? npass : 1;
    for (int p = p0; p < p0 + reps; ++p) {
      const float* qd = qs + (p * w.fc + r0) * TQ;
      const T* x = stage;
      int r = 0;
      if (p == 0 && r0 == 0) {
        dot_row<T, TQ, U, true>(qd, x, acc);
        r = 1;
      }
      for (; r + 2 <= nr; r += 2) {
        dot_row<T, TQ, U>(qd + r * TQ, x + r * G::kRow, acc);
        dot_row<T, TQ, U>(qd + (r + 1) * TQ, x + (r + 1) * G::kRow, acc);
      }
      if (r < nr) dot_row<T, TQ, U>(qd + r * TQ, x + r * G::kRow, acc);
    }
  }
}

// The groups of a chunk that hold columns of the split: U, or fewer in
// the split's last chunk.
template <int U>
__device__ __forceinline__ int groups_left(int64_t cols) {
  const int64_t g = (cols + kGroup - 1) / kGroup;
  return g < U ? static_cast<int>(g) : U;
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

// The block's query tile into shared memory: qs[d * TQ + qq] the value d
// of query q0 + qq (0 past B), sqn its raw norm, sex its excluded column
// (-1 = none or out of range).  Every thread of a kThreads block calls it.
template <int TQ, typename T>
__device__ __forceinline__ void load_query_tile(
    const T* __restrict__ q, const float* __restrict__ qn,
    const int64_t* __restrict__ excl, int64_t b, int fq, int64_t np,
    int64_t q0, float* qs, float* sqn, int* sex) {
  const int t = threadIdx.x;
  for (int i = t; i < fq * TQ; i += kThreads) {
    const int d = i / TQ;
    const int qq = i % TQ;
    qs[i] = (q0 + qq < b) ? load(q + (q0 + qq) * fq + d) : 0.0f;
  }
  if (t < TQ) {
    const bool in = q0 + t < b;
    sqn[t] = in ? qn[q0 + t] : 0.0f;
    const int64_t e = in ? excl[q0 + t] : -1;
    sex[t] = (e >= 0 && e < np) ? static_cast<int>(e) : -1;
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
__device__ __forceinline__ bool let_through(float dot, float bnd, float ch) {
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

typedef unsigned long long u64;

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

// The arguments both partial kernels take.
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
  int64_t cap;           // key slots per (query, split): k for the lists
  int vec;               // the stage copies' bytes (0: one value a copy)
  void* keys;            // (b, nsplit, cap) u64
};

// Dynamic shared memory of a partial kernel: the stage ring, the query
// tile, and (the warp lists) their values and columns.
template <typename T, int U, int TQ>
__host__ __device__ size_t partial_smem(int fq, int fc, int lists_k) {
  using G = Geom<T, U>;
  return sizeof(T) * static_cast<size_t>(kStages) *
             stage_rows(fc, G::kMaxRows) * G::kRow +
         sizeof(float) * static_cast<size_t>(fq) * TQ +
         (sizeof(float) + sizeof(int)) * static_cast<size_t>(kWarps) * TQ *
             lists_k;
}

// The warp lists' rare path for one group: the warp's scores sc[qq * 32 +
// lane] of its 32 columns (column col of lane, gcol + bit of lane `bit`),
// its lists lv / lc ([TQ][k]) and its filter bounds wb ([TQ]); for each
// query of wm (bit qq: a column of the warp passed for query qq), the
// exact score of the columns that passed, their inserts in ascending lane
// order, the warp's published ceil(k/4)-th value and the query's new
// bound.  Warp-uniform.
template <int KPL, bool EXACT, int TQ>
__device__ __forceinline__ void take_group(
    const float* sc, float* wb, unsigned wm, float* lv_w, int* lc_w,
    volatile float (*pub)[kWarps], const float* sqn, const int* sex,
    float cnorm, float ch, int64_t col, int gcol, int k, int kq, int warp,
    int lane, float eps) {
  for (; wm; wm &= wm - 1) {
    const int qq = __ffs(wm) - 1;
    const float s = sc[qq * 32 + lane];
    const bool pass = let_through<EXACT>(s, wb[qq], ch);
    unsigned m = __ballot_sync(kFull, pass);
    float* lv = lv_w + qq * k;
    int* lc = lc_w + qq * k;
    float kth = lv[k - 1];
    const float floor_q = block_floor(pub[qq]);
    // the exact score of a column that passed; the division only here
    const float x = pass && col != sex[qq]
                        ? column_score<EXACT>(s, sqn[qq], cnorm, eps)
                        : -INFINITY;
    bool grew = false;
    do {
      const int bit = __ffs(m) - 1;
      m &= m - 1;
      const float xv = __shfl_sync(kFull, x, bit);
      if (xv > kth && xv >= floor_q) {
        list_insert<KPL>(lv, lc, k, xv, gcol + bit, lane);
        kth = lv[k - 1];
        grew = true;
      }
    } while (m);
    if (grew && lane == 0) pub[qq][warp] = lv[kq - 1];
    const float nb = filter_bound<EXACT>(kth, block_floor(pub[qq]), sqn[qq]);
    __syncwarp();
    if (lane == 0) wb[qq] = nb;
    __syncwarp();
  }
}

template <int KPL, bool EXACT, typename T, int TQ>
__global__ void __launch_bounds__(kThreads, tile(false, KPL, TQ).min_blocks)
    fused_partial_kernel(Args a) {
  constexpr int U = tile(false, KPL, TQ).u;
  using G = Geom<T, U>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int fq = a.fq, fc = a.fc, k = a.k;
  const int npass = fq / fc;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(
      smem + sizeof(T) * kStages * stage_rows(fc, G::kMaxRows) * G::kRow);
  float* lv_all = qs + fq * TQ;                    // [kWarps][TQ][k]
  int* lc_all = reinterpret_cast<int*>(lv_all + kWarps * TQ * k);
  __shared__ float sqn[TQ];
  __shared__ int sex[TQ];
  __shared__ volatile float pub[TQ][kWarps];  // each warp's ceil(k/4)-th best
  __shared__ float scratch[kWarps][TQ * 32];  // a warp's scores of a group
  __shared__ float wbnd[kWarps][TQ];          // a warp's filter bounds

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t b = a.b;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;
  const int split = blockIdx.y;
  const int64_t c_begin = static_cast<int64_t>(split) * a.split_cols;
  const int64_t c_end =
      c_begin + a.split_cols < a.np ? c_begin + a.split_cols : a.np;
  const float* __restrict__ cn = static_cast<const float*>(a.cn);

  Walk<T, U> w(ring, static_cast<const T*>(a.ft), a.ft_sd, a.ft_sc, c_begin,
               c_end, fc, npass, a.vec);
  w.start();
  load_query_tile<TQ>(static_cast<const T*>(a.q),
                      static_cast<const float*>(a.qn),
                      static_cast<const int64_t*>(a.excl), b, fq, a.np, q0,
                      qs, sqn, sex);
  for (int i = t; i < kWarps * TQ * k; i += kThreads) {
    lv_all[i] = -INFINITY;
    lc_all[i] = -1;
  }
  if (t < TQ * kWarps) pub[t / kWarps][t % kWarps] = -INFINITY;
  const int kq = (k + kWarps - 1) / kWarps;
  // the filter's bound per query (filter_bound): -inf at first; +inf for
  // a query slot past B, which then never passes
  float bnd[TQ];
#pragma unroll
  for (int qq = 0; qq < TQ; ++qq) bnd[qq] = q0 + qq < b ? -INFINITY : INFINITY;
  float* sc = scratch[warp];
  float* wb = wbnd[warp];
  if (lane < TQ) wb[lane] = q0 + lane < b ? -INFINITY : INFINITY;
  __syncthreads();

  for (int64_t base = c_begin; base < c_end; base += G::kWidth) {
    const int ngroups = groups_left<U>(c_end - base);
    // the chunk's norms, loaded while its dots run
    float cnorm[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t col = base + u * kGroup + t;
      cnorm[u] = col < c_end ? __ldg(cn + col) : 0.0f;
    }
    float acc[U][TQ];
    chunk_dots<T, TQ, U>(w, qs, npass, acc);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= ngroups) break;  // block-uniform: the split's short last chunk
      const int64_t gbase = base + u * kGroup;
      const int64_t col = gbase + t;
      const float ch =
          filter_operand<EXACT>(col < c_end && col < a.valid, cnorm[u]);
      unsigned qm = 0;  // bit qq: the column passes for query qq
#pragma unroll
      for (int qq = 0; qq < TQ; ++qq)
        qm |= static_cast<unsigned>(
                  let_through<EXACT>(acc[u][qq], bnd[qq], ch))
              << qq;
      const unsigned wm = __reduce_or_sync(kFull, qm);
      if (!wm) continue;  // the common case
      // the group's scores to the warp's scratch, then one pass over the
      // queries that passed in the warp (a loop, not unrolled: the rare
      // path's code stays small)
#pragma unroll
      for (int qq = 0; qq < TQ; ++qq) sc[qq * 32 + lane] = acc[u][qq];
      __syncwarp();
      take_group<KPL, EXACT, TQ>(sc, wb, wm, lv_all + warp * TQ * k,
                                 lc_all + warp * TQ * k, pub, sqn, sex,
                                 cnorm[u], ch, col,
                                 static_cast<int>(gbase) + 32 * warp, k, kq,
                                 warp, lane, a.eps);
#pragma unroll
      for (int qq = 0; qq < TQ; ++qq) bnd[qq] = wb[qq];
    }
  }
  __syncthreads();

  // fold the 4 warp lists of each query into its split's top-k keys: lane
  // l < kWarps holds the head of warp l's list; k rounds of a pick of the
  // best head
  u64* keys = static_cast<u64*>(a.keys);
#pragma unroll 1
  for (int qq = warp; qq < TQ; qq += kWarps) {
    const int64_t qg = q0 + qq;
    if (qg >= b) continue;  // warp-uniform
    u64* out = keys + (qg * a.nsplit + split) * a.cap;
    const int src = lane < kWarps ? lane : 0;
    const float* hv = lv_all + (src * TQ + qq) * k;
    const int* hc = lc_all + (src * TQ + qq) * k;
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
        for (int j = r + lane; j < k; j += 32) out[j] = 0ull;
        break;
      }
      if (lane == bl) ++head;
      if (lane == 0) out[r] = score_key(bv, bc);
    }
  }
}

// ------------------------------------------------------------ the large k
//
// The large-k path keeps each (query, split)'s candidates as 64-bit keys
// in a buffer of `cap` entries in device memory (L2-resident while the
// grid's buffers fit the 50 MB L2): see the notes at the top.

constexpr int kU = 4;                   // keys a thread per select step
constexpr int kSortSmemKeys = 8192;     // the merge sorts in shared memory
                                        // up to this (64 KB), else in place

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

// The large-k partial kernel: the same grid, block, walk, scores and
// filter as fused_partial_kernel, one list per query instead of four warp
// lists: every column of the split that passes the filter against the
// query's threshold t and scores above it is appended to the query's
// buffer (keys[(q * nsplit + split) * cap ...], a shared-memory count per
// query: lane qq of a warp reserves query qq's slots, one atomic a warp
// and group for the TQ queries), and after each group a buffer that may
// not take another group is cut back to its k best (select_threshold,
// then compact) at a block barrier, t becoming its k-th key's value.  The
// split's columns arrive group by group in ascending order and t moves
// only between groups, so a column scoring exactly t ranks below the
// entry that set it: `x > t` keeps every column of the split's top k (the
// small-k kernel's `>`), and the filter passes every x >= t.  At the end
// each query's first k slots hold its split's top k, unsorted, and 0 in
// the slots it could not fill: the merge selects and sorts.
template <bool EXACT, typename T, int TQ>
__global__ void __launch_bounds__(kThreads, tile(true, 0, TQ).min_blocks)
    fused_large_partial_kernel(Args a) {
  constexpr int U = tile(true, 0, TQ).u;
  using G = Geom<T, U>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int fq = a.fq, fc = a.fc, k = a.k;
  const int npass = fq / fc;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(
      smem + sizeof(T) * kStages * stage_rows(fc, G::kMaxRows) * G::kRow);
  __shared__ float sqn[TQ];
  __shared__ int sex[TQ];
  __shared__ int cnt[TQ];                  // keys in each query's buffer
  __shared__ float thr[TQ];                // each query's threshold t
  __shared__ int full;                     // a buffer passed `limit`
  __shared__ SelectShared sh;
  __shared__ float sbnd[TQ];               // each query's filter bound
  __shared__ float scratch[kWarps][TQ * 32];  // a warp's scores of a group
  __shared__ unsigned wem_all[kWarps][TQ];    // a warp's entering lanes

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int64_t b = a.b;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;
  const int split = blockIdx.y;
  const int64_t c_begin = static_cast<int64_t>(split) * a.split_cols;
  const int64_t c_end =
      c_begin + a.split_cols < a.np ? c_begin + a.split_cols : a.np;
  const int64_t cap = a.cap;
  // a buffer at or below `limit` takes one more group of kGroup columns
  const int limit = static_cast<int>(cap) - kGroup;
  const float* __restrict__ cn = static_cast<const float*>(a.cn);
  u64* keys = static_cast<u64*>(a.keys);

  Walk<T, U> w(ring, static_cast<const T*>(a.ft), a.ft_sd, a.ft_sc, c_begin,
               c_end, fc, npass, a.vec);
  w.start();
  load_query_tile<TQ>(static_cast<const T*>(a.q),
                      static_cast<const float*>(a.qn),
                      static_cast<const int64_t*>(a.excl), b, fq, a.np, q0,
                      qs, sqn, sex);
  if (t < TQ) {
    cnt[t] = 0;
    thr[t] = -INFINITY;
    sbnd[t] = q0 + t < b ? -INFINITY : INFINITY;
  }
  if (t == 0) full = 0;
  float bnd[TQ];
#pragma unroll
  for (int qq = 0; qq < TQ; ++qq) bnd[qq] = q0 + qq < b ? -INFINITY : INFINITY;
  float* sc = scratch[t >> 5];
  unsigned* wem = wem_all[t >> 5];
  __syncthreads();

  for (int64_t base = c_begin; base < c_end; base += G::kWidth) {
    const int ngroups = groups_left<U>(c_end - base);
    float cnorm[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t col = base + u * kGroup + t;
      cnorm[u] = col < c_end ? __ldg(cn + col) : 0.0f;
    }
    float acc[U][TQ];
    chunk_dots<T, TQ, U>(w, qs, npass, acc);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= ngroups) break;  // block-uniform
      const int64_t col = base + u * kGroup + t;
      const float ch =
          filter_operand<EXACT>(col < c_end && col < a.valid, cnorm[u]);
      unsigned qm = 0;  // bit qq: the column passes for query qq
#pragma unroll
      for (int qq = 0; qq < TQ; ++qq)
        qm |= static_cast<unsigned>(
                  let_through<EXACT>(acc[u][qq], bnd[qq], ch))
              << qq;
      const unsigned wm = __reduce_or_sync(kFull, qm);
      if (wm) {
        // the group's scores to the warp's scratch; for each query that
        // passed in the warp, the exact scores (back into the scratch)
        // and the entering lanes (wem); then lane qq reserves query qq's
        // slots, one atomic a warp and group for the TQ queries, and the
        // entering lanes write their keys
#pragma unroll
        for (int qq = 0; qq < TQ; ++qq) sc[qq * 32 + lane] = acc[u][qq];
        __syncwarp();
        for (unsigned m = wm; m; m &= m - 1) {
          const int qq = __ffs(m) - 1;
          const float s = sc[qq * 32 + lane];
          const bool pass = let_through<EXACT>(s, sbnd[qq], ch);
          const float x = pass && col != sex[qq]
                              ? column_score<EXACT>(s, sqn[qq], cnorm[u],
                                                    a.eps)
                              : -INFINITY;
          sc[qq * 32 + lane] = x;
          const unsigned em = __ballot_sync(kFull, x > thr[qq]);
          if (lane == 0) wem[qq] = em;
        }
        __syncwarp();
        int at = 0;
        if (lane < TQ && (wm >> lane & 1u) && wem[lane]) {
          const int mine = __popc(wem[lane]);
          at = atomicAdd(&cnt[lane], mine);
          if (at + mine > limit) full = 1;
        }
        const unsigned below = (1u << lane) - 1u;
        for (unsigned m = wm; m; m &= m - 1) {
          const int qq = __ffs(m) - 1;
          const unsigned em = wem[qq];
          const int base_q = __shfl_sync(kFull, at, qq);
          if (em >> lane & 1u)
            keys[((q0 + qq) * a.nsplit + split) * cap + base_q +
                 __popc(em & below)] =
                score_key(sc[qq * 32 + lane], static_cast<int>(col));
        }
        __syncwarp();
      }
      __syncthreads();
      if (full) {  // block-uniform: read after the barrier, reset after two
        for (int qq = 0; qq < TQ; ++qq)
          if (cnt[qq] > limit)
            cut_buffer(keys + ((q0 + qq) * a.nsplit + split) * cap, k,
                       &cnt[qq], &thr[qq], sh);
        __syncthreads();
        if (t == 0) full = 0;
#pragma unroll
        for (int qq = 0; qq < TQ; ++qq)
          bnd[qq] = q0 + qq < b
                        ? filter_bound<EXACT>(thr[qq], -INFINITY, sqn[qq])
                        : INFINITY;
        if (t < TQ)
          sbnd[t] = q0 + t < b
                        ? filter_bound<EXACT>(thr[t], -INFINITY, sqn[t])
                        : INFINITY;
        __syncthreads();
      }
    }
  }
  __syncthreads();

  for (int qq = 0; qq < TQ && q0 + qq < b; ++qq) {
    const int c = cnt[qq];
    u64* row = keys + ((q0 + qq) * a.nsplit + split) * cap;
    if (c > k) cut_buffer(row, k, &cnt[qq], &thr[qq], sh);
    for (int j = (c < k ? c : k) + t; j < k; j += kThreads) row[j] = 0ull;
  }
}

// One block per query: the top k of its nsplit partial lists (k keys each
// at stride cap, 0 = empty) by select_threshold, compacted into the first
// split's slots, sorted (in shared memory when the launch gives it
// sort_keys >= P keys, else in those slots: cap >= P), and written out as
// (value, column), unfilled slots (-inf, -1).  Both paths' partial kernels
// end in it.
__global__ void __launch_bounds__(kMergeThreads)
    fused_merge_kernel(u64* keys, int nsplit, int64_t cap, int k,
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
  u64* s = P <= sort_keys ? sorted : row;
  for (int i = t; i < P; i += kMergeThreads) s[i] = i < c ? row[i] : 0ull;
  __syncthreads();
  sort_desc<kMergeThreads>(s, P);
  for (int j = t; j < k; j += kMergeThreads) {
    const u64 key = j < c ? s[j] : 0ull;
    ov[qg * k + j] = key ? key_value(key) : -INFINITY;
    oi[qg * k + j] = key ? static_cast<int64_t>(key_column(key)) : -1;
  }
}

constexpr int kMaxDevices = 64;

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device: cudaFuncSetAttribute where a call needs more than the device's
// last setting for this kernel (`set`, per device), not on every launch
// (host time at B = 1).  Returns a cudaError_t.
template <typename K>
int allow_smem(K kernel, size_t smem, int (&set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && set[dev] >= static_cast<int>(smem)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && dev < kMaxDevices) set[dev] = static_cast<int>(smem);
  return static_cast<int>(e);
}

// Launch a partial kernel over grid (query tiles, splits) with its dynamic
// shared memory, or, with blocks_per_sm, write how many of its blocks an
// SM holds at once instead.
template <auto kernel>
int launch_partial(int tq, size_t smem, const Args& a, cudaStream_t stream,
                   int* blocks_per_sm) {
  static int set[kMaxDevices] = {};   // one table per kernel instance
  const int e = allow_smem(kernel, smem, set);
  if (e != 0) return e;
  if (blocks_per_sm)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, smem));
  const dim3 grid(static_cast<unsigned>((a.b + tq - 1) / tq),
                  static_cast<unsigned>(a.nsplit));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXACT, typename T, int TQ>
int launch_tq(const Args& a, bool large, cudaStream_t s, int* bps) {
  if (large)
    return launch_partial<fused_large_partial_kernel<EXACT, T, TQ>>(TQ,
                          partial_smem<T, tile(true, 0, TQ).u, TQ>(a.fq, a.fc,
                                                                   0),
                          a, s, bps);
  if (a.k <= 32)
    return launch_partial<fused_partial_kernel<1, EXACT, T, TQ>>(TQ,
                          partial_smem<T, tile(false, 1, TQ).u, TQ>(
                              a.fq, a.fc, a.k),
                          a, s, bps);
  return launch_partial<fused_partial_kernel<2, EXACT, T, TQ>>(TQ,
                        partial_smem<T, tile(false, 2, TQ).u, TQ>(a.fq, a.fc,
                                                                  a.k),
                        a, s, bps);
}

template <bool EXACT, typename T>
int launch_t(const Args& a, int tq, bool large, cudaStream_t s, int* bps) {
  return tq == 4 ? launch_tq<EXACT, T, 4>(a, large, s, bps)
                 : launch_tq<EXACT, T, 16>(a, large, s, bps);
}

// The partial kernel instance for (path, k, tq, exact, bf16).
int launch(const Args& a, int tq, bool large, bool exact, bool bf16,
           cudaStream_t s, int* blocks_per_sm) {
  return bf16    ? launch_t<false, __nv_bfloat16>(a, tq, large, s,
                                                  blocks_per_sm)
         : exact ? launch_t<true, float>(a, tq, large, s, blocks_per_sm)
                 : launch_t<false, float>(a, tq, large, s, blocks_per_sm);
}

int kpl_of(int64_t k) { return k <= 32 ? 1 : 2; }

// The arguments common to both entry points, checked: 0, or
// cudaErrorInvalidValue.
int check_args(const Args& a, int64_t fq, int64_t fc, int64_t k,
               int64_t exact, int64_t bf16, int64_t nsplit, int64_t tq) {
  const int64_t es = bf16 ? 2 : 4;
  const bool aligned =
      a.vec == 0 ||
      ((a.vec == 4 || a.vec == 8 || a.vec == 16) && a.ft_sc == 1 &&
       reinterpret_cast<uintptr_t>(a.ft) % a.vec == 0 &&
       (fc == 1 || (a.ft_sd * es) % a.vec == 0));
  if (k < 1 || nsplit < 1 || nsplit > kMaxGridY || nsplit * k >= INT_MAX ||
      fc < 1 || (fq != fc && !(fq == 2 * fc)) || (fq != fc && !bf16) ||
      (bf16 && exact) || (tq != 4 && tq != 16) || !aligned ||
      a.np >= INT_MAX || a.split_cols * nsplit < a.np || a.split_cols < 1 ||
      a.split_cols % kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Launch the merge of a partial kernel's (b, nsplit, cap) keys.
int launch_merge(const Args& a, int64_t k, cudaStream_t s, void* ov,
                 void* oi) {
  int64_t p2 = 1;
  while (p2 < k) p2 <<= 1;
  const int sort_keys = p2 <= kSortSmemKeys ? static_cast<int>(p2) : 0;
  const size_t smem = sizeof(u64) * static_cast<size_t>(sort_keys);
  static int set[kMaxDevices] = {};
  const int e = allow_smem(fused_merge_kernel, smem, set);
  if (e != 0) return e;
  fused_merge_kernel<<<static_cast<unsigned>(a.b), kMergeThreads, smem, s>>>(
      static_cast<u64*>(a.keys), a.nsplit, a.cap, a.k, sort_keys,
      static_cast<float*>(ov), static_cast<int64_t*>(oi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, fq) contiguous, f32 or (bf16 != 0) bf16; qn (b,) f32; catalog value
// (d, c) at ft[d * ft_sd + c * ft_sc], d < fc, c < np, of q's type, with
// fq == fc, or, bf16 only, fq == 2 * fc (bf16x2 over [hi; lo]); cn (np,)
// f32; excl (b,) int64; tq the query tile (4 or 16); vec the stage copies'
// bytes (16, 8 or 4 where ft_sc == 1 and the base and the row stride are
// multiples of it; 0: one value a copy); keys (b, nsplit, k) u64 scratch;
// out ov (b, k) f32, oi (b, k) int64.  Split s covers columns [s *
// split_cols, (s + 1) * split_cols), split_cols a multiple of 128.  bf16
// storage takes prenormalized rows only (exact == 0).  k <= 64.  Returns
// cudaGetLastError().
extern "C" int srt_fused_topk(const void* q, const void* qn, const void* ft,
                              int64_t ft_sd, int64_t ft_sc, const void* cn,
                              const void* excl, int64_t b, int64_t fq,
                              int64_t fc, int64_t np, int64_t valid,
                              int64_t k, int64_t exact, int64_t bf16,
                              float eps, int64_t nsplit, int64_t split_cols,
                              int64_t tq, int64_t vec, void* keys, void* ov,
                              void* oi, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, qn, ft, ft_sd, ft_sc, cn, excl, b,
               static_cast<int>(fq), static_cast<int>(fc), np, valid,
               static_cast<int>(k), eps, static_cast<int>(nsplit),
               split_cols, k, static_cast<int>(vec), keys};
  int err = check_args(a, fq, fc, k, exact, bf16, nsplit, tq);
  if (err) return err;
  if (k > kListsMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch(a, static_cast<int>(tq), false, exact, bf16, s, nullptr);
  if (err != 0) return err;
  return launch_merge(a, k, s, ov, oi);
}

// How many blocks of the warp-list partial kernel that srt_fused_topk
// launches for (fq, fc, k, exact, bf16, tq) an SM holds at once, into *out
// (int).  Returns a cudaError_t.
extern "C" int srt_fused_blocks_per_sm(int64_t fq, int64_t fc, int64_t k,
                                       int64_t exact, int64_t bf16,
                                       int64_t tq, void* out) {
  if (k < 1 || k > kListsMaxK || fq < 1 || fc < 1 || (tq != 4 && tq != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.fq = static_cast<int>(fq);
  a.fc = static_cast<int>(fc);
  a.k = static_cast<int>(k);
  return launch(a, static_cast<int>(tq), false, exact, bf16, nullptr,
                static_cast<int*>(out));
}

// The large-k path (any k >= 1): the arguments of srt_fused_topk, with keys
// (b, nsplit, cap) u64 scratch; cap >= k + 128 and cap >= the least power
// of two >= k.  Returns cudaGetLastError().
extern "C" int srt_fused_topk_large(
    const void* q, const void* qn, const void* ft, int64_t ft_sd,
    int64_t ft_sc, const void* cn, const void* excl, int64_t b, int64_t fq,
    int64_t fc, int64_t np, int64_t valid, int64_t k, int64_t exact,
    int64_t bf16, float eps, int64_t nsplit, int64_t split_cols, int64_t cap,
    int64_t tq, int64_t vec, void* keys, void* ov, void* oi, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  int64_t p2 = 1;
  while (p2 < k) p2 <<= 1;
  const Args a{q, qn, ft, ft_sd, ft_sc, cn, excl, b,
               static_cast<int>(fq), static_cast<int>(fc), np, valid,
               static_cast<int>(k), eps, static_cast<int>(nsplit),
               split_cols, cap, static_cast<int>(vec), keys};
  int err = check_args(a, fq, fc, k, exact, bf16, nsplit, tq);
  if (err) return err;
  if (k > (INT_MAX >> 2) || cap < k + kGroup || cap < p2 ||
      cap > (INT_MAX >> 1) || b > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch(a, static_cast<int>(tq), true, exact, bf16, s, nullptr);
  if (err != 0) return err;
  return launch_merge(a, k, s, ov, oi);
}

// How many blocks of the large-k partial kernel for (fq, fc, exact, bf16,
// tq) an SM holds at once, into *out (int).  Returns a cudaError_t.
extern "C" int srt_fused_large_blocks_per_sm(int64_t fq, int64_t fc,
                                             int64_t exact, int64_t bf16,
                                             int64_t tq, void* out) {
  if (fq < 1 || fc < 1 || (tq != 4 && tq != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.fq = static_cast<int>(fq);
  a.fc = static_cast<int>(fc);
  return launch(a, static_cast<int>(tq), true, exact, bf16, nullptr,
                static_cast<int*>(out));
}

// The tiling of the partial kernel for (large, k, tq) at fc catalog rows of
// bf16 or fp32, into out[0..3] (int): U, the blocks an SM must hold, the
// ring's stages, the catalog rows a stage.  Returns cudaErrorInvalidValue
// for a tile the library does not hold.
extern "C" int srt_fused_tiling(int64_t large, int64_t k, int64_t tq,
                                int64_t fc, int64_t bf16, void* out) {
  if (k < 1 || (!large && k > kListsMaxK) || fc < 1 ||
      (tq != 4 && tq != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile ti = tile(large != 0, large ? 0 : kpl_of(k), static_cast<int>(tq));
  int* o = static_cast<int*>(out);
  o[0] = ti.u;
  o[1] = ti.min_blocks;
  o[2] = kStages;
  const int max_rows = bf16 ? (ti.u == 4 ? Geom<__nv_bfloat16, 4>::kMaxRows
                                         : Geom<__nv_bfloat16, 2>::kMaxRows)
                            : (ti.u == 4 ? Geom<float, 4>::kMaxRows
                                         : Geom<float, 2>::kMaxRows);
  o[3] = stage_rows(static_cast<int>(fc), max_rows);
  return 0;
}
