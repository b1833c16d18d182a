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
//   dot       over r = 0..f-1, ascending: fp32 storage sums q[r] * ft[r][col]
//             with one rounding per multiply and per add (__fmul_rn /
//             __fadd_rn, never contracted), as csrc/fused_topk.cu; bf16
//             storage starts from the rounded first product and adds each
//             next product with one fused multiply-add (__fmaf_rn), so a
//             product below 2^-134, which fp32 cannot hold, is not rounded
//             on its own (above it a bf16 x bf16 product is exact in fp32
//             and the two chains agree)
//   epilogue  flags, applied in this order: DIV s = dot / (qn*cn), MUL
//             s = dot * (qn*cn), CLIP s = clamp(s, -1, 1) by comparisons
//             that pass NaN (jnp.clip), GUARD s = qn*cn > eps ? s : 0,
//             MASK s = -inf for col >= valid and col == excl[q]
//   reduce    FIRST: the raw dots of the tile's first `width` columns;
//             MAX: the max over the tile, NaN winning (jnp.max); TOP2: per
//             lane (col mod 128) the walk of the TPU body over the tile's
//             tc/128 groups in ascending order: v1 from group 0, then
//             strict `>` (v2 from -inf, g2 from 0), so a NaN in group 0
//             stays v1 and a later NaN never enters; then the max of v1
//             (NaN winning) and the max over lanes of g1 + g2
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
// What bounds it on an H100: instruction issue on the CUDA cores.  Each
// score takes f products (fp32: an FMUL and an FADD each; bf16: one FFMA),
// about 0.2 shared-memory loads a product, and an epilogue and reduction
// of ~1-15 instructions (an IEEE division, ~10 dependent instructions and
// a branch to its slow path, in the DIV bodies), against f x 4 (bf16:
// f x 2) bytes of catalog per column.  chip_smoke.py counts the issue
// floor from each instance's SASS (phase 13).  Bitwise equality with the
// plain version keeps the dot off the tensor cores (their fp32 sum
// truncates, PERF.md section 6, PR 15).
//
// Design:
// - a block of 128 threads owns TQ queries and one catalog tile; thread l
//   owns lane l and scores U consecutive groups per step, a chunk (columns
//   t*tc + 128*(g+u) + l, u < U), so each query float4 read from shared
//   memory feeds 4U products; the U scores go through the epilogue and the
//   reduction in ascending g, so TOP2's tie rule is the TPU's sequential
//   one and needs no merge; a tile whose group count U does not divide
//   ends with a shorter chunk (its missing groups are scored from stale
//   shared memory and dropped);
// - the catalog tile streams through shared memory: each chunk is cut
//   into row blocks of at most kStageBytes (ceil(f / rows) blocks of equal
//   height), and each (chunk, row block) is one stage of a kStages-deep
//   ring, copied with 16-byte cp.async (commit_group / wait_group) while
//   the stage before it is scored; thread l reads its columns of a stage
//   row back at l, l + 128, ..., so consecutive lanes hit consecutive
//   words.  The registers, not the stages, bound the blocks an SM holds
//   (srt_ablation_blocks_per_sm: 3 to 5);
// - the tiling (U, TQ, a register cap, rows a dot step) is chosen per
//   instance (`tile`); TOP2 keeps g2 in shared memory to fit 4 blocks an
//   SM without spilling;
// - the dots: row 0's products start the chain (no initial add), the
//   other rows follow one `mac` each;
// - MAX with GUARD and no DIV / MUL skips the guard where a warp's
//   columns pass it for every query of the block (one vote a group);
// - the grid is (query tiles x catalog tiles), query tiles fastest, so
//   the blocks that read one catalog tile run together and share it in
//   L2;
// - the query values sit in shared memory transposed, [row][query], read
//   as float4 broadcasts (kernel 3's layout);
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
constexpr int kMaxF = 64;    // query width the shared buffer holds
constexpr int kStageBytes = 32 * 1024;  // most shared memory of one stage
constexpr int kStages = 2;              // depth of the shared-memory ring

// epilogue flags and reductions (ops/cuda/ablation.py has the same values)
constexpr int kGuard = 1, kDiv = 2, kMul = 4, kClip = 8, kMask = 16;
constexpr int kFirst = 0, kMax = 1, kTop2 = 2;

// An instance's tiling: U groups a thread scores per step, TQ queries per
// block, the blocks an SM must hold (ptxas caps the registers to fit; 1:
// no cap) and the rows a step of the dot loop takes.  TOP2 keeps three
// registers per query (v1, v2, g1) beside the U x TQ accumulators, so it
// takes U = 2 and a cap of 128 registers (4 blocks an SM; with a division
// that cap spills, so TQ = 8 there); an IEEE division is a chain of ~10
// dependent instructions with a branch to its slow path, and the DIV
// instances gain from more warps (U = 2) over more products per query
// load (U = 4).  Chosen on the card (PERF.md section 6); to try another,
// edit this table and time it against the parent's build with
// tools/ablation_sweep.py.
struct Tile {
  int u, tq, min_blocks, row_unroll;
};
__host__ __device__ constexpr Tile tile(bool bf16, int epi, int red) {
  return red == kTop2    ? Tile{2, (epi & kDiv) ? 8 : 16,
                                (epi & kDiv) ? 1 : 4, 2}
         : (epi & kDiv)  ? Tile{2, 16, 1, 2}
         : red == kFirst ? Tile{4, 16, bf16 ? 4 : 1, 2}
                         : Tile{4, 16, 1, bf16 ? 4 : 2};
}
template <typename T, int EPI, int RED>
struct Tiling {
  static constexpr Tile kTile =
      tile(std::is_same<T, __nv_bfloat16>::value, EPI, RED);
  static constexpr int U = kTile.u;
  static constexpr int TQ = kTile.tq;
  static constexpr int kMinBlocks = kTile.min_blocks;
  static constexpr int kRowUnroll = kTile.row_unroll;
};

// rows of one stage for width f: f split into the fewest row blocks of at
// most kStageBytes, of equal height
template <typename T, int U>
__host__ __device__ constexpr int stage_rows(int f) {
  constexpr int kMaxRows =
      kStageBytes / (U * kLanes * static_cast<int>(sizeof(T)));
  static_assert(kMaxRows >= 1, "a stage row exceeds kStageBytes");
  const int nblocks = (f + kMaxRows - 1) / kMaxRows;
  return (f + nblocks - 1) / nblocks;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// max and min that keep NaN, whichever side it is on (jnp.max); one
// FMNMX.NAN each
__device__ __forceinline__ float nanmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nanmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// acc + q * x as the instance's chain rounds it (see the top of the file)
template <typename T>
__device__ __forceinline__ float mac(float q, float x, float acc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __fmaf_rn(q, x, acc);
  else
    return __fadd_rn(acc, __fmul_rn(q, x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r1) of catalog columns [col0, col0 + 128 * ngr) into the stage
// st[r - r0][U * 128] with 16-byte copies: thread t copies vector t % kVecs
// of rows r0 + t / kVecs, then every kLanes / kVecs-th row.
template <typename T, int U>
__device__ __forceinline__ void load_stage(T* st, const T* ft,
                                           int64_t ft_stride, int64_t col0,
                                           int r0, int r1, int ngr, int t) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a copy
  constexpr int kVecs = U * kLanes / kPer;                 // copies a row
  static_assert(kVecs <= kLanes && kLanes % kVecs == 0, "stage row copies");
  const int v = t % kVecs;
  if (v >= ngr * (kLanes / kPer)) return;  // past the tile's last group
  for (int r = r0 + t / kVecs; r < r1; r += kLanes / kVecs)
    cp_async16(st + (r - r0) * (U * kLanes) + v * kPer,
               ft + r * ft_stride + col0 + v * kPer);
}

// acc[u][j] += the product of row r for query j (qs row r) and the stage
// row's column u * 128 (x: the thread's column of that stage row); with
// kFirst, acc[u][j] = the product, the chain's first step
template <typename T, int TQ, int U, bool kFirst = false>
__device__ __forceinline__ void dot_row(const float* qs, const T* x, int r,
                                        float (&acc)[U][TQ]) {
  float xv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) xv[u] = to_float(x[u * kLanes]);
  const float4* q4 = reinterpret_cast<const float4*>(qs + r * TQ);
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

// acc[u][j] += the products of rows [r0, r1) for query j and the stage's
// column u * 128 + t, in ascending row order: UNROLL rows a step, then the
// rest one by one
template <typename T, int TQ, int U, int UNROLL>
__device__ __forceinline__ void dot_rows(const float* qs, const T* st,
                                         int r0, int r1, int t,
                                         float (&acc)[U][TQ]) {
  const T* x = st + t;
  int r = r0;
  for (; r + UNROLL <= r1; r += UNROLL, x += UNROLL * U * kLanes)
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      dot_row<T, TQ, U>(qs, x + k * U * kLanes, r + k, acc);
  for (; r < r1; ++r, x += U * kLanes) dot_row<T, TQ, U>(qs, x, r, acc);
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

// Group gi's scores of column col (the thread's) for the TQ queries, from
// their dots acc, folded into the running reductions in query order: MAX /
// FIRST the running max m (and the first group's dots); TOP2 v1 (m), and
// v2 and g1 beside it, and g2 in shared memory (g2[j * 128], the thread's
// column): only written in the walk, it costs a store where a register
// would cost a select, and frees TQ registers.
template <int EPI, int RED, int TQ>
__device__ __forceinline__ void fold_group(
    const float (&acc)[TQ], const float* sqn, const int* sex, float cnorm,
    float eps, bool pad, int col, int gi, bool first_group, float (&m)[TQ],
    float (&v2)[TQ], int (&g1)[TQ], int* g2, float (&first)[TQ]) {
#pragma unroll
  for (int j = 0; j < TQ; ++j) {
    const float s =
        epilogue<EPI>(acc[j], sqn[j], cnorm, eps, pad || col == sex[j]);
    if (RED == kTop2) {
      // the walk's step as selects: v1 >= v2 unless v1 is NaN, so beating
      // v1 implies beating v2; group 0 is taken as v1
      const bool beat1 = (s > m[j]) | first_group;
      const bool beat2 = s > v2[j];
      const float lo = beat1 ? m[j] : s;
      v2[j] = beat2 ? lo : v2[j];
      m[j] = beat1 ? s : m[j];
      if (beat2) g2[j * kLanes] = beat1 ? g1[j] : gi;
      g1[j] = beat1 ? gi : g1[j];
    } else {
      m[j] = nanmax(m[j], s);
      if (RED == kFirst) first[j] = first_group ? s : first[j];
    }
  }
}

template <typename T, int EPI, int RED>
__global__ void __launch_bounds__(kLanes, Tiling<T, EPI, RED>::kMinBlocks)
    ablation_kernel(const T* __restrict__ q, const float* __restrict__ qn,
                    const T* __restrict__ ft, int64_t ft_stride,
                    const float* __restrict__ cn,
                    const int32_t* __restrict__ excl, int64_t valid,
                    int64_t b, int f, int tc, int ntiles, float eps,
                    int width, float* __restrict__ out_s,
                    int32_t* __restrict__ out_i, float* __restrict__ dmax,
                    int32_t* __restrict__ dg) {
  constexpr int U = Tiling<T, EPI, RED>::U;
  constexpr int TQ = Tiling<T, EPI, RED>::TQ;
  constexpr int kRowUnroll = Tiling<T, EPI, RED>::kRowUnroll;
  static_assert(TQ % 4 == 0 && TQ <= kLanes, "queries per block");
  extern __shared__ __align__(16) unsigned char smem[];  // the stage ring
  __shared__ __align__(16) float qs[kMaxF * TQ];  // [d][query]
  __shared__ __align__(16) float sqn[TQ];
  __shared__ int sex[TQ];
  __shared__ float rmax[kWarps][TQ];
  __shared__ int rg[kWarps][TQ];
  __shared__ float smax[TQ];
  __shared__ int sg[TQ];
  __shared__ int sg2[RED == kTop2 ? TQ : 1][kLanes];  // TOP2's g2, by lane

  const int l = threadIdx.x;
  const int lane = l & 31;
  const int warp = l >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;
  const int tile = blockIdx.y;
  const int c0 = tile * tc;  // np < INT_MAX

  for (int i = l; i < f * TQ; i += kLanes) {
    const int d = i / TQ;
    const int j = i % TQ;
    qs[i] = q0 + j < b ? ld(q + (q0 + j) * f + d) : 0.0f;
  }
  if (l < TQ) {
    const bool in = q0 + l < b;
    sqn[l] = in ? qn[q0 + l] : 0.0f;
    sex[l] = (in && excl != nullptr) ? excl[q0 + l] : -1;
  }
  // MAX with GUARD and no DIV / MUL: where qn_min > 0, cn > 0 and qn_min *
  // cn > eps, every query of the block passes the guard (each qn_j >=
  // qn_min, so qn_j * cn >= qn_min * cn: rounding is monotonic; a NaN,
  // zero or negative norm fails the test), so a warp whose columns all
  // pass folds them without it (MAX only: with two folds, TOP2 spilled at
  // its register cap)
  constexpr bool kGuardOnly =
      RED == kMax && (EPI & kGuard) && !(EPI & (kDiv | kMul));
  float qn_min = 0.0f;
  if constexpr (kGuardOnly) {
    __syncthreads();  // sqn is written
#pragma unroll
    for (int j = 0; j < TQ; ++j) qn_min = j ? nanmin(qn_min, sqn[j]) : sqn[0];
  }
  // columns >= valid are masked; col < np < INT_MAX
  const int vcol =
      static_cast<int>(valid < 0 ? 0 : (valid > INT_MAX ? INT_MAX : valid));

  // the stage ring: each chunk of U groups (U*128 columns) is cut into
  // row blocks of `rows` rows, and each (chunk, row block) item is copied
  // into the next stage of the kStages-deep ring, kStages - 1 items ahead
  // of the one being scored
  T* ring = reinterpret_cast<T*>(smem);
  const int groups = tc / kLanes;
  const int nchunks = (groups + U - 1) / U;
  const int rows = stage_rows<T, U>(f);
  const int nblocks = (f + rows - 1) / rows;
  const int items = nchunks * nblocks;
  const int stage_elems = rows * U * kLanes;
  int next = 0, next_c = 0, next_rb = 0, next_st = 0;  // the next load
  auto issue = [&]() {
    if (next < items) {
      const int r0 = next_rb * rows;
      load_stage<T, U>(ring + next_st * stage_elems, ft, ft_stride,
                       c0 + next_c * U * kLanes, r0, min(f, r0 + rows),
                       min(U, groups - next_c * U), l);
      ++next;
      if (++next_rb == nblocks) {
        next_rb = 0;
        ++next_c;
      }
      if (++next_st == kStages) next_st = 0;
    }
    cp_async_commit();  // an empty group past the last item keeps the count
  };
  // the next item's stage, once every thread's copies of it have landed
  // and every thread has left the stage the next load overwrites
  int st = 0;
  auto take = [&]() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue();
    const T* stage = ring + st * stage_elems;
    if (++st == kStages) st = 0;
    return stage;
  };
#pragma unroll
  for (int s = 0; s + 1 < kStages; ++s) issue();

  float m[TQ], v2[TQ], first[TQ];
  int g1[TQ];
  int* g2 = &sg2[0][l];
#pragma unroll
  for (int j = 0; j < TQ; ++j) {
    m[j] = v2[j] = first[j] = -INFINITY;
    g1[j] = 0;
    if (RED == kTop2) g2[j * kLanes] = 0;
  }
  for (int c = 0; c < nchunks; ++c) {
    const int ngroups = min(U, groups - c * U);
    // the chunk's catalog norms, loaded while its dots run
    float cnorm[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      cnorm[u] = ((EPI & (kGuard | kDiv | kMul)) && u < ngroups)
                     ? __ldg(cn + c0 + (c * U + u) * kLanes + l)
                     : 0.0f;
    // the dots: row 0 starts the chain, the rest of the row block and the
    // next ones follow in ascending order
    float acc[U][TQ];
    const T* stage = take();
    dot_row<T, TQ, U, true>(qs, stage + l, 0, acc);
    dot_rows<T, TQ, U, kRowUnroll>(qs, stage + U * kLanes, 1, min(f, rows),
                                   l, acc);
    for (int rb = 1; rb < nblocks; ++rb) {
      stage = take();
      dot_rows<T, TQ, U, kRowUnroll>(qs, stage, rb * rows,
                                     min(f, rb * rows + rows), l, acc);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= ngroups) break;  // block-uniform: the tile's short last chunk
      const int gi = c * U + u;
      const int col = c0 + gi * kLanes + l;
      const bool first_group = u == 0 && c == 0;
      const bool pad = (EPI & kMask) && col >= vcol;
      if constexpr (kGuardOnly) {
        if (__all_sync(kFull, qn_min > 0.0f && cnorm[u] > 0.0f &&
                                  __fmul_rn(qn_min, cnorm[u]) > eps)) {
          fold_group<EPI & ~kGuard, RED, TQ>(acc[u], sqn, sex, cnorm[u], eps,
                                             pad, col, gi, first_group, m,
                                             v2, g1, g2, first);
          continue;
        }
      }
      fold_group<EPI, RED, TQ>(acc[u], sqn, sex, cnorm[u], eps, pad, col, gi,
                               first_group, m, v2, g1, g2, first);
    }
  }

  // the block's lanes -> one max (and max g1 + g2) per query
#pragma unroll
  for (int j = 0; j < TQ; ++j) {
    float x = m[j];
    int g = RED == kTop2 ? g1[j] + g2[j * kLanes] : 0;
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
  if (l < TQ) {
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
      for (int j = 0; j < TQ; ++j) {
        const int64_t qg = q0 + j;
        if (qg >= b) break;
        out_s[qg * width + l] = first[j];
        if (out_i != nullptr) out_i[qg * width + l] = 0;
      }
    }
    return;
  }
  for (int i = l; i < TQ * width; i += kLanes) {
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

// Launch the instance (T, EPI, RED), or, with blocks_per_sm, write how
// many of its blocks an SM holds at once instead.
template <typename T, int EPI, int RED>
int launch(const Args& a, cudaStream_t s, int* blocks_per_sm) {
  constexpr int U = Tiling<T, EPI, RED>::U;
  constexpr int TQ = Tiling<T, EPI, RED>::TQ;
  const size_t smem = sizeof(T) * static_cast<size_t>(kStages) *
                      stage_rows<T, U>(a.f) * U * kLanes;
  auto kernel = ablation_kernel<T, EPI, RED>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks_per_sm)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kLanes, smem));
  const dim3 grid(static_cast<unsigned>((a.b + TQ - 1) / TQ),
                  static_cast<unsigned>(a.ntiles));
  kernel<<<grid, kLanes, smem, s>>>(
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

int dispatch(const Args& a, bool bf16, int epi, int red, cudaStream_t s,
             int* blocks_per_sm) {
#define SRT_ABLATION_CASE(T, E, R)                                     \
  if (bf16 == std::is_same<T, __nv_bfloat16>::value && epi == (E) &&   \
      red == (R))                                                      \
    return launch<T, (E), (R)>(a, s, blocks_per_sm);
  SRT_ABLATION_INSTANCES(SRT_ABLATION_CASE)
#undef SRT_ABLATION_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (b, f) contiguous, f32 or (bf16 != 0) bf16; qn (b,) f32; ft (>= f rows
// of row stride ft_stride, np columns) of q's type, its base and row stride
// multiples of 16 bytes (the stages' cp.async; ops/cuda/ablation.Body
// copies any other catalog into such a buffer first); cn (np,) f32; excl
// (b,) int32 or null (no exclusion); columns >= valid are masked (MASK
// bodies); np a multiple of tc, tc a multiple of 128.  out_s (b, width)
// f32; out_i (b, width) int32 or null; dmax (b, np / tc) f32; dg (b, np /
// tc) int32 for TOP2, else unused.  FIRST takes width <= 128.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments or an (epi,
// red, type) instance the library does not hold.
extern "C" int srt_ablation(const void* q, const void* qn, const void* ft,
                            int64_t ft_stride, const void* cn,
                            const void* excl, int64_t valid, int64_t b,
                            int f, int64_t np, int tc, int bf16, int epi,
                            int red, int width, float eps, void* out_s,
                            void* out_i, void* dmax, void* dg, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  const int64_t esize = bf16 ? 2 : 4;
  if (f < 1 || f > kMaxF || tc < kLanes || tc % kLanes || np < tc ||
      np % tc || np >= INT_MAX || np / tc > 65535 || width < 1 ||
      (red == kFirst && width > kLanes) || (red == kTop2 && dg == nullptr) ||
      reinterpret_cast<uintptr_t>(ft) % 16 || (ft_stride * esize) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  qn, ft, ft_stride, cn, excl, valid, b, f, tc,
               static_cast<int>(np / tc), eps, width, out_s, out_i, dmax,
               dg};
  return dispatch(a, bf16 != 0, epi, red, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// How many blocks of the instance (bf16, epi, red) an SM holds at once at
// query width f, into *out (int).  Returns a cudaError_t.
extern "C" int srt_ablation_blocks_per_sm(int f, int bf16, int epi, int red,
                                          void* out) {
  if (f < 1 || f > kMaxF) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.f = f;
  return dispatch(a, bf16 != 0, epi, red, nullptr, static_cast<int*>(out));
}

// The tiling of the instance (bf16, epi, red) at query width f, into
// out[0..4] (int): U, TQ, min blocks, rows a dot step, rows a stage.
// Returns cudaErrorInvalidValue for an instance the library does not hold.
extern "C" int srt_ablation_tiling(int f, int bf16, int epi, int red,
                                   void* out) {
  int* o = static_cast<int*>(out);
#define SRT_ABLATION_TILING(T, E, R)                                   \
  if (bf16 == std::is_same<T, __nv_bfloat16>::value && epi == (E) &&   \
      red == (R)) {                                                    \
    using Ti = Tiling<T, (E), (R)>;                                    \
    o[0] = Ti::U;                                                      \
    o[1] = Ti::TQ;                                                     \
    o[2] = Ti::kMinBlocks;                                             \
    o[3] = Ti::kRowUnroll;                                             \
    o[4] = stage_rows<T, Ti::U>(f);                                    \
    return 0;                                                          \
  }
  if (f >= 1 && f <= kMaxF) {
    SRT_ABLATION_INSTANCES(SRT_ABLATION_TILING)
  }
#undef SRT_ABLATION_TILING
  return static_cast<int>(cudaErrorInvalidValue);
}
