// The bin scan shared by kernel 1 (v3, csrc/scan_v3.cu), kernel 4 (v2,
// csrc/scan_v2.cu) and the prototype scans of csrc/proto_scans.cu.
//
// What it computes, for every query q of a batch against a transposed
// (rows, Np) bf16 catalog:
//
//   dot(q, col), by the contraction policy C:
//     SplitPlanes  sum_f qh*hi + ql*lo + ql*hi + qh*lo   (4F fp32 FMAs of
//                  exact bf16 x bf16 products, in a fixed order; kernels 1
//                  and 4)
//     Plain        sum_r q[r] * ft[r], r = 0 .. qw-1     (qw FMAs in
//                  ascending row order; the prototypes' `dot_general`)
//   score, by the epilogue kind E:
//     kNone          dot                                 (v3, scan_d1)
//     kGuardClipMask qn*cn > eps ? clamp(dot, -1, 1) : 0, then -inf where
//                    col >= valid or col == excl  (v2, proto_scan, scan3)
//   bin(col)    = col mod W
//   columns >= ncols (the catalog's rows; the layout's pad columns lie
//   above) never enter a bin: the scan kernel walks only the whole W-column
//   groups below ncols, and the merge scores the up to W-1 columns of the
//   group that straddles ncols (SplitPlanes) and inserts them after every
//   slice, the single walk's last inserts, so no scan step carries a
//   compare
//   each bin keeps its top-D (value, column) with strict `>`, so the lowest
//   column wins ties, plus the largest value evicted past D (the (D+1)-th
//   best: the coverage bound);
//   out, compact (topc > 0): the top-`topc` of the D*W slots (slot =
//   level*W + bin) by value descending, slot ascending, and the max bound
//   over the bins;
//   out, full (topc = 0): the (D*W) slot values and columns and the (W)
//   per-bin bounds.
//
// This reproduces the TPU kernels' candidate structures exactly: their bin
// of a global column is `col mod W` because W divides the catalog tile
// (spotify_recommender_tpu/ops/pallas/fused_topk.py:947-950, :1171-1174).
// The BF16X2_EPS derivation (48 rounded fp32 additions, Cauchy-Schwarz)
// holds for any order of the additions, and each FMA here rounds once after
// an exact product, so the certificate's bound carries over.
//
// Catalog layout: the TPU's transposed (rows, Np) bf16 planes.  SplitPlanes
// reads rows [0, 2F) = [hi; lo] (a 4-plane [hi; lo; hi; lo] layout works
// unchanged) against (B, 4F) queries [qh, ql, ql, qh], of which it reads
// [qh, ql].  Plain reads rows [0, qw) against (B, qw) queries.
//
// What bounds it on an H100: fp32 FMA issue.  B x Np x 4F FMAs (1024 x 1M x
// 48 = 50 G FMAs at the benchmark shape, 1.5 ms at the CUDA cores' 67
// TFLOP/s) against 48 bytes of catalog per column.  The TPU ran a grid of
// (query tiles, catalog tiles) in order on one core and carried the bins
// across catalog tiles in VMEM; a port that kept one block per query tile
// walked the whole catalog in each block, so B = 1 cost a full walk and
// B = 1024 filled fewer than half of the 132 SMs.  Design:
//
// - two kernels.  `scan_kernel` runs a grid of (query tiles x catalog
//   slices), a slice being a run of whole W-column groups; each block walks
//   its slice and writes that slice's full structures (D*W values and
//   columns, W bounds per query) to scratch.  `merge_kernel` folds the
//   slices of each (query, bin) in ascending order and then extracts the
//   compact output or writes the merged full structures.  The wrappers
//   pick the slice so that the grid covers the card's block slots a few
//   times over at any B (ops/cuda/scan_v3.split_slice);
// - the merge inserts a later slice's D pairs, in their order, into the
//   running D-list with the walk's own insert (strict `>`: the earlier
//   slice, so the lower column, wins ties), and takes the max of the two
//   bounds.  The values it evicts are the smallest D of the 2D, so the
//   bound becomes max(b_a, b_b, (D+1)-th of the union): the bin's (D+1)-th
//   largest value, as the single walk's bound is.  Only compares, max and
//   min touch the values, so the result is bitwise the single walk's;
// - in a block of W threads, thread t owns bin t and walks its columns t,
//   t+W, ... in ascending order.  It scores U of them per step
//   (`cols_per_step`), so each query broadcast read from shared memory
//   feeds U columns' FMAs, and inserts them in ascending column order.  W
//   is a template parameter (every multiple of 128 up to 1024): with W read
//   from blockDim.x the W = 128 scan took 22.1 ms instead of 15.4 ms at
//   1024 x 1M (NVIDIA H100 80GB HBM3, 700 W; PERF.md);
// - a block takes a tile of TQ queries, and per query the thread keeps D
//   (value, column) pairs and the bound in registers.  The register file
//   (65,536 per SM) bounds TQ * W: TQ = 16 up to W = 256, 8 up to 512, 4 up
//   to 1024;
// - catalog tiles of rows x tc bf16 (tc a multiple of U*W) are double
//   buffered in shared memory with 16-byte `cp.async` copies: tile i+1 is
//   in flight while tile i is scored.  The query tile sits in shared
//   memory transposed, so one row's TQ values are read as float4
//   broadcasts;
// - the merge block takes one query with W*R threads: R groups fold R runs
//   of slices in parallel, then group 0 folds the R partial lists in order.
//   For the compact output, warp 0 extracts the top-topc by warp-wide
//   argmax rounds (value descending, slot ascending), as the TPU's
//   masked-argmax rounds do; a picked slot is knocked out as NaN, which
//   never ranks.
//
// The prototypes' single walk (scan_d1, proto_scan) is the scan kernel over
// one slice writing straight to the outputs, without the merge.
//
// These "flat" instances take W <= 1024, depth <= 4, rows whose two tiles
// of one W-column group fit the shared memory, and extract by argmax
// rounds.  Kernels 1 and 4 take every other shape on csrc/scan_wide.cu's
// "wide" route (bin groups of 128, a runtime depth, row chunks, a radix
// selection), which reuses SplitPlanes and bin_insert from here, so both
// routes give the same bits (ops/cuda/scan_v3.scan_route picks).
// Tensor cores (wgmma) are later work: BF16X2_EPS assumes that each fp32
// addition rounds to nearest, and wgmma's accumulation does not.  Measured
// on an H100 with kernel 10 (csrc/mxu_wgmma.cu; PERF.md section 6):
// it truncates (1 + 0.75 ulp sums to 1, -(1 + 0.75 ulp) to -1), and one
// model gives every measured dot bitwise (experiments/kernel_r3.
// step_model): per k step of 16, take the largest exponent E of the
// accumulator and the products (a product's: ea + eb), truncate each term
// to a multiple of 2^(E - 25), sum, truncate once to fp32.  That model
// errs by less than 0.65 of the 48-term round-to-nearest budget (48 *
// 2^-24 * S); the measured worst was 0.49 (a directed dot), 0.21 over 1.0e8
// random ones.  So a tensor-core scan may keep BF16X2_EPS, but the model
// is measured, not documented: proving it comes first (ROADMAP 2b item 2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace bin_scan {

constexpr int kMaxBins = 1024;       // W: one bin per thread (the flat
                                     // instances; csrc/scan_wide.cu takes
                                     // any W)
constexpr int kTileBytes = 24576;    // shared memory of one catalog tile
constexpr int kMaxSlices = 65535;    // gridDim.y
constexpr int kMergeThreads = 1024;  // threads of a merge block
// dynamic shared memory of a block on an H100 (232,448 bytes) less room
// for the kernel's static arrays
constexpr int kMaxSmem = 232448 - 1024;

// queries per block for W bins
__host__ __device__ constexpr int queries_per_block(int w) {
  return w <= 256 ? 16 : (w <= 512 ? 8 : 4);
}

// columns a thread scores per step: U * TQ accumulators beside the TQ * D
// pairs and TQ bounds, as many as the registers hold without spilling, and
// one column above W = 512, where two W-column groups would overflow the
// tile's shared memory.  U = 4 at depth <= 2 for W <= 256 timed fastest of
// 1, 2 and 4 at 1024 x 1M (variant builds on the card, not kept)
__host__ __device__ constexpr int cols_per_step(int w, int d) {
  return w > 512 ? 1 : (w > 256 ? 2 : (d <= 2 ? 4 : (d == 3 ? 2 : 1)));
}

// slice-folding groups of a merge block: W * R threads
__host__ __device__ constexpr int merge_groups(int w) {
  return w >= kMergeThreads ? 1 : kMergeThreads / w;
}

// ---- contraction policies: which catalog rows a query meets, and how.
// `f` is the width argument of the call: F for SplitPlanes, qw for Plain.
// The staged query tile is qs[r * TQ + q], fp32, for r < rows(f).  `dot`
// scores columns cc, cc+W, ..., cc+(U-1)W of the tile into acc[u][q]; its
// loop over the rows is unrolled twice where kUnroll2 (see score_step).

struct SplitPlanes {
  __host__ __device__ static int rows(int f) { return 2 * f; }
  __host__ __device__ static int64_t q_stride(int f) { return 4 * f; }
  // feature j's 4 * TQ * U FMAs
  template <int TQ, int U, int W>
  __device__ __forceinline__ static void row(const float* qs,
                                             const __nv_bfloat16* tile,
                                             int tc, int cc, int f, int j,
                                             float (&acc)[U][TQ]) {
    float h[U], l[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h[u] = __bfloat162float(tile[j * tc + cc + u * W]);
      l[u] = __bfloat162float(tile[(f + j) * tc + cc + u * W]);
    }
    const float4* qh4 = reinterpret_cast<const float4*>(qs + j * TQ);
    const float4* ql4 = reinterpret_cast<const float4*>(qs + (f + j) * TQ);
#pragma unroll
    for (int q4 = 0; q4 < TQ / 4; ++q4) {
      const float4 a = qh4[q4];
      const float4 e = ql4[q4];
      const float qh[4] = {a.x, a.y, a.z, a.w};
      const float ql[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float s = acc[u][4 * q4 + k];
          s = fmaf(qh[k], h[u], s);
          s = fmaf(ql[k], l[u], s);
          s = fmaf(ql[k], h[u], s);
          s = fmaf(qh[k], l[u], s);
          acc[u][4 * q4 + k] = s;
        }
      }
    }
  }
  template <int TQ, int U, int W, bool kUnroll2>
  __device__ static void dot(const float* qs, const __nv_bfloat16* tile,
                             int tc, int cc, int f, float (&acc)[U][TQ]) {
    if constexpr (kUnroll2) {
#pragma unroll 2
      for (int j = 0; j < f; ++j) row<TQ, U, W>(qs, tile, tc, cc, f, j, acc);
    } else {
      for (int j = 0; j < f; ++j) row<TQ, U, W>(qs, tile, tc, cc, f, j, acc);
    }
  }
};

struct Plain {
  __host__ __device__ static int rows(int f) { return f; }
  __host__ __device__ static int64_t q_stride(int f) { return f; }
  // row r's TQ * U FMAs
  template <int TQ, int U, int W>
  __device__ __forceinline__ static void row(const float* qs,
                                             const __nv_bfloat16* tile,
                                             int tc, int cc, int r,
                                             float (&acc)[U][TQ]) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = __bfloat162float(tile[r * tc + cc + u * W]);
    const float4* q4p = reinterpret_cast<const float4*>(qs + r * TQ);
#pragma unroll
    for (int q4 = 0; q4 < TQ / 4; ++q4) {
      const float4 a = q4p[q4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[u][4 * q4 + 0] = fmaf(a.x, x[u], acc[u][4 * q4 + 0]);
        acc[u][4 * q4 + 1] = fmaf(a.y, x[u], acc[u][4 * q4 + 1]);
        acc[u][4 * q4 + 2] = fmaf(a.z, x[u], acc[u][4 * q4 + 2]);
        acc[u][4 * q4 + 3] = fmaf(a.w, x[u], acc[u][4 * q4 + 3]);
      }
    }
  }
  template <int TQ, int U, int W, bool kUnroll2>
  __device__ static void dot(const float* qs, const __nv_bfloat16* tile,
                             int tc, int cc, int f, float (&acc)[U][TQ]) {
    if constexpr (kUnroll2) {
#pragma unroll 2
      for (int r = 0; r < f; ++r) row<TQ, U, W>(qs, tile, tc, cc, r, acc);
    } else {
      for (int r = 0; r < f; ++r) row<TQ, U, W>(qs, tile, tc, cc, r, acc);
    }
  }
};

// The query tile of queries q0 .. q0+TQ-1 into qs, transposed; rows past b
// are zeros.
template <int NT, int TQ, class C>
__device__ __forceinline__ void load_queries(float* qs,
                                             const __nv_bfloat16* q,
                                             int64_t b, int64_t q0, int f,
                                             int t) {
  const int rows = C::rows(f);
  const int64_t stride = C::q_stride(f);
  for (int i = t; i < rows * TQ; i += NT) {
    const int j = i / TQ;
    const int qq = i % TQ;
    qs[i] = (q0 + qq < b) ? __bfloat162float(q[(q0 + qq) * stride + j])
                          : 0.0f;
  }
}

// Catalog columns [base, base + cols) of `rows` rows into tile[rows][tc]
// with 16-byte copies (cols a multiple of 8, rows 16-byte aligned).
template <int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* ft,
                                          int64_t ft_stride, int64_t base,
                                          int rows, int cols, int tc, int t) {
  const int vec_per_row = cols / 8;  // 8 bf16 per 16-byte copy
  for (int i = t; i < rows * vec_per_row; i += NT) {
    const int r = i / vec_per_row;
    const int c = i % vec_per_row;
    reinterpret_cast<uint4*>(tile + static_cast<int64_t>(r) * tc)[c] =
        reinterpret_cast<const uint4*>(ft + r * ft_stride + base)[c];
  }
}

// As load_tile, with asynchronous copies (cp.async.cg: global -> shared,
// bypassing L1); the caller commits the group and waits for it.
template <int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile,
                                                const __nv_bfloat16* ft,
                                                int64_t ft_stride,
                                                int64_t base, int rows,
                                                int cols, int tc, int t) {
  const int vec_per_row = cols / 8;
  for (int i = t; i < rows * vec_per_row; i += NT) {
    const int r = i / vec_per_row;
    const int c = i % vec_per_row;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        tile + static_cast<int64_t>(r) * tc + 8 * c));
    const void* src = ft + r * ft_stride + base + 8 * c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__device__ __forceinline__ void bin_insert(float (&v)[D], int (&ix)[D],
                                           float& bnd, float s, int col) {
  // the value evicted past depth is min(s, v[D-1]): s when it lands below,
  // the old deepest when s inserts anywhere above (fused_topk.py:1178-1180)
  bnd = fmaxf(bnd, fminf(s, v[D - 1]));
  bool c[D];
#pragma unroll
  for (int l = 0; l < D; ++l) c[l] = s > v[l];
#pragma unroll
  for (int l = D - 1; l > 0; --l) {
    v[l] = c[l - 1] ? v[l - 1] : (c[l] ? s : v[l]);
    ix[l] = c[l - 1] ? ix[l - 1] : (c[l] ? col : ix[l]);
  }
  v[0] = c[0] ? s : v[0];
  ix[0] = c[0] ? col : ix[0];
}

// (a_val, a_slot) ranks before (b_val, b_slot): value descending, slot
// ascending.  NaN never ranks before anything.
__device__ __forceinline__ bool ranks_before(float av, int as, float bv,
                                             int bs) {
  return av > bv || (av == bv && as < bs);
}

enum class Epi { kNone, kGuardClipMask };

// The epilogue's inputs; kNone reads none.
struct Epilogue {
  const float* qn;      // (b,) raw query norms
  const float* cn;      // (np,) raw catalog norms, zero on pad columns
  const int64_t* excl;  // (b,) excluded column, -1 = none
  int64_t valid;        // columns >= valid are padding
  float eps;
};

// The arguments of one call, as the C entry points receive them.
struct Args {
  const void* q2;       // the queries (SplitPlanes: (b, 4f); Plain: (b, f))
  int64_t b;
  int f;                // the policy's width: F, or qw
  const void* ft;
  int64_t ft_stride, np;
  int topc;             // > 0 compact output, 0 full structures
  Epilogue epi;
  int64_t slice;        // columns per catalog slice; 0 = one slice
  void* wv;             // per-slice structures (slices, b, D*W) f32,
  void* wi;             //   (slices, b, D*W) i32, (slices, b, W) f32
  void* wb;
  bool merge;           // fold wv/wi/wb into ov/oi/ob; false: one slice,
                        //   and wv/wi/wb are the full outputs
  void* ov;
  void* oi;
  void* ob;
  int64_t ncols = INT64_MAX;  // columns >= ncols never enter a bin
};

// The columns [col0, col0 + n) of the group that straddles ncols (n < W,
// col0 a multiple of W), which the merge scores and inserts: SplitPlanes
// queries (b, q_stride) and catalog planes, as the scan reads them.
struct Tail {
  const __nv_bfloat16* q2;
  int64_t q_stride;
  int f;
  const __nv_bfloat16* ft;
  int64_t ft_stride;
  int64_t col0;
  int n;
};

// Scores the U columns cc, cc+W, ... of the staged tile (global columns
// base + cc + u*W) for the TQ queries, and inserts them in ascending order.
template <int W, int TQ, int D, int U, Epi E, class C>
__device__ __forceinline__ void score_step(
    const float* qs, const __nv_bfloat16* tile, int tc, int cc, int f,
    int64_t base, const Epilogue& epi, const float* sqn, const int64_t* sex,
    float (&v)[TQ][D], int (&ix)[TQ][D], float (&bnd)[TQ]) {
  float acc[U][TQ];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int q = 0; q < TQ; ++q) acc[u][q] = 0.0f;
  // the epilogue-free instances above W = 512 (64-85 registers a thread)
  // spill with the row loop unrolled twice; the others gain from it
  C::template dot<TQ, U, W, !(W > 512 && E == Epi::kNone)>(qs, tile, tc, cc,
                                                           f, acc);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int col = static_cast<int>(base + cc + u * W);
    if (E != Epi::kNone) {
      // the cosine epilogue on the raw norms, then the masks
      // (fused_topk.py:922-929)
      const float cnorm = epi.cn[col];
      const bool pad = col >= epi.valid;
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        const float den = __fmul_rn(sqn[q], cnorm);
        const float s =
            den > epi.eps ? fminf(fmaxf(acc[u][q], -1.0f), 1.0f) : 0.0f;
        acc[u][q] = (pad || col == sex[q]) ? -INFINITY : s;
      }
    }
#pragma unroll
    for (int q = 0; q < TQ; ++q)
      bin_insert<D>(v[q], ix[q], bnd[q], acc[u][q], col);
  }
}

// Block (x, y): queries [x*TQ, x*TQ + TQ) over catalog columns [y*slice,
// min(np, y*slice + slice)); writes the slice's full structures to rows
// y*b + query of wv (D*W), wi (D*W), wb (W).
template <int W, int D, Epi E, class C>
__global__ void __launch_bounds__(W)
    scan_kernel(const __nv_bfloat16* __restrict__ q2, int64_t b, int f,
                const __nv_bfloat16* __restrict__ ft, int64_t ft_stride,
                int64_t np, int tc, int64_t slice, Epilogue epi,
                float* __restrict__ wv, int32_t* __restrict__ wi,
                float* __restrict__ wb) {
  constexpr int TQ = queries_per_block(W);
  constexpr int U = cols_per_step(W, D);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sqn[TQ];
  __shared__ int64_t sex[TQ];
  const int t = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * slice;
  const int64_t c1 = np - c0 < slice ? np : c0 + slice;
  const int rows = C::rows(f);

  // qs[rows][TQ] fp32, then two tile buffers [rows][tc] bf16
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(qs + rows * TQ);
  const int64_t buf = static_cast<int64_t>(rows) * tc;
  load_queries<W, TQ, C>(qs, q2, b, q0, f, t);
  if (E != Epi::kNone && t < TQ) {
    const bool in = q0 + t < b;
    sqn[t] = in ? epi.qn[q0 + t] : 0.0f;
    sex[t] = in ? epi.excl[q0 + t] : -1;
  }

  float v[TQ][D];
  int ix[TQ][D];
  float bnd[TQ];
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
#pragma unroll
    for (int l = 0; l < D; ++l) {
      v[q][l] = -INFINITY;
      ix[q][l] = -1;
    }
    bnd[q] = -INFINITY;
  }

  const int64_t ntiles = c1 > c0 ? (c1 - c0 + tc - 1) / tc : 0;
  if (ntiles > 0) {
    load_tile_async<W>(tiles, ft, ft_stride, c0, rows,
                       static_cast<int>(c1 - c0 < tc ? c1 - c0 : tc), tc, t);
    cp_async_commit();
  }
  for (int64_t i = 0; i < ntiles; ++i) {
    const int64_t base = c0 + i * tc;
    const int cols = static_cast<int>(c1 - base < tc ? c1 - base : tc);
    if (i + 1 < ntiles) {
      // tile i+1 into the other buffer, which every thread left at the end
      // of step i-1
      const int64_t next = base + tc;
      load_tile_async<W>(tiles + ((i + 1) & 1) * buf, ft, ft_stride, next,
                         rows, static_cast<int>(c1 - next < tc ? c1 - next : tc),
                         tc, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i (and, at i = 0, qs) is visible to all
    const __nv_bfloat16* tile = tiles + (i & 1) * buf;
    const int groups = cols / W;
    int g = 0;
    for (; g + U <= groups; g += U)
      score_step<W, TQ, D, U, E, C>(qs, tile, tc, t + g * W, f, base, epi,
                                    sqn, sex, v, ix, bnd);
    for (; g < groups; ++g)
      score_step<W, TQ, D, 1, E, C>(qs, tile, tc, t + g * W, f, base, epi,
                                    sqn, sex, v, ix, bnd);
    __syncthreads();  // tile i is consumed before its buffer is refilled
  }

  // this slice's full structures: slot = level*W + bin
  constexpr int S = D * W;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * b + q0;
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
    if (q0 + q >= b) break;
    const int64_t qg = row0 + q;
#pragma unroll
    for (int l = 0; l < D; ++l) {
      wv[qg * S + l * W + t] = v[q][l];
      wi[qg * S + l * W + t] = ix[q][l];
    }
    wb[qg * W + t] = bnd[q];
  }
}

// Block x: query x.  Folds the `slices` per-slice structures of each bin in
// ascending slice order, then the `tail` columns, then writes the compact
// output (topc > 0: ov, oi (b, topc), ob (b,)) or the merged full
// structures (ov, oi (b, D*W), ob (b, W)).
template <int W, int D>
__global__ void __launch_bounds__(W * merge_groups(W))
    merge_kernel(const float* __restrict__ wv, const int32_t* __restrict__ wi,
                 const float* __restrict__ wb, int64_t slices, int64_t b,
                 Tail tail, int topc, float* __restrict__ ov,
                 int32_t* __restrict__ oi, float* __restrict__ ob) {
  constexpr int R = merge_groups(W);
  constexpr int S = D * W;
  // each group's partial structure: pv[R][S], pi[R][S], pb[R][W]
  extern __shared__ __align__(16) unsigned char smem[];
  float* pv = reinterpret_cast<float*>(smem);
  int* pi = reinterpret_cast<int*>(pv + R * S);
  float* pb = reinterpret_cast<float*>(pi + R * S);
  const int t = threadIdx.x % W;   // the bin
  const int r = threadIdx.x / W;   // the group
  const int64_t qg = blockIdx.x;

  float v[D];
  int ix[D];
  float bnd = -INFINITY;
#pragma unroll
  for (int l = 0; l < D; ++l) {
    v[l] = -INFINITY;
    ix[l] = -1;
  }
  // group r folds slices [s0, s1); an empty list (-inf, -1) merges as the
  // identity
  const int per = static_cast<int>((slices + R - 1) / R);  // <= 65,535
  const int s0 = r * per;
  const int s1 = slices < s0 + per ? static_cast<int>(slices) : s0 + per;
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {
    const int64_t row = s * b + qg;
#pragma unroll
    for (int l = 0; l < D; ++l)
      bin_insert<D>(v, ix, bnd, wv[row * S + l * W + t],
                    wi[row * S + l * W + t]);
    bnd = fmaxf(bnd, wb[row * W + t]);
  }
  if (R > 1) {
#pragma unroll
    for (int l = 0; l < D; ++l) {
      pv[r * S + l * W + t] = v[l];
      pi[r * S + l * W + t] = ix[l];
    }
    pb[r * W + t] = bnd;
    __syncthreads();
    if (r == 0) {
      for (int g = 1; g < R; ++g) {
#pragma unroll
        for (int l = 0; l < D; ++l)
          bin_insert<D>(v, ix, bnd, pv[g * S + l * W + t],
                        pi[g * S + l * W + t]);
        bnd = fmaxf(bnd, pb[g * W + t]);
      }
    }
  }
  if (r == 0 && t < tail.n) {
    // column col0 + t lies in bin t; its dot sums the products in the
    // scan's order (SplitPlanes::row), so it is the scan's value
    const __nv_bfloat16* q = tail.q2 + qg * tail.q_stride;
    const int64_t col = tail.col0 + t;
    float s = 0.0f;
    for (int j = 0; j < tail.f; ++j) {
      const float qh = __bfloat162float(q[j]);
      const float ql = __bfloat162float(q[tail.f + j]);
      const float h = __bfloat162float(tail.ft[j * tail.ft_stride + col]);
      const float l =
          __bfloat162float(tail.ft[(tail.f + j) * tail.ft_stride + col]);
      s = fmaf(qh, h, s);
      s = fmaf(ql, l, s);
      s = fmaf(ql, h, s);
      s = fmaf(qh, l, s);
    }
    bin_insert<D>(v, ix, bnd, s, static_cast<int>(col));
  }
  if (topc == 0) {
    if (r == 0) {
#pragma unroll
      for (int l = 0; l < D; ++l) {
        ov[qg * S + l * W + t] = v[l];
        oi[qg * S + l * W + t] = ix[l];
      }
      ob[qg * W + t] = bnd;
    }
    return;
  }
  __syncthreads();  // every group has read the partials
  if (r == 0) {
#pragma unroll
    for (int l = 0; l < D; ++l) {
      pv[l * W + t] = v[l];
      pi[l * W + t] = ix[l];
    }
    pb[t] = bnd;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  // warp 0: the top-topc slots by warp-wide argmax rounds
  const int lane = threadIdx.x;
  for (int k = 0; k < topc; ++k) {
    float bv = -INFINITY;
    int bs = INT_MAX;  // "none": ranks after every real slot
    for (int slot = lane; slot < S; slot += 32) {
      if (ranks_before(pv[slot], slot, bv, bs)) {
        bv = pv[slot];
        bs = slot;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov2 = __shfl_xor_sync(0xffffffffu, bv, off);
      const int os2 = __shfl_xor_sync(0xffffffffu, bs, off);
      if (ranks_before(ov2, os2, bv, bs)) {
        bv = ov2;
        bs = os2;
      }
    }
    if (lane == 0) {
      ov[qg * topc + k] = bv;
      oi[qg * topc + k] = pi[bs];
      pv[bs] = NAN;  // taken: never ranks again
    }
    __syncwarp();
  }
  float m = -INFINITY;
  for (int i = lane; i < W; i += 32) m = fmaxf(m, pb[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) ob[qg] = m;
}

// W-column groups per catalog tile: the tile budget, at least one group and
// a multiple of `u`, but no more than two tile buffers in `avail` bytes
// hold.  The shared memory is sized from the real tile (at qw = 48 and W =
// 512 one group is 49,152 bytes, twice the budget).  Wide rows get fewer
// than `u` groups (F = 64 at W = 128: 3 of 32,768 bytes, where u = 4 would
// need 262,144 for the two buffers); the scan then scores each group of the
// tile on its own, as it scores the groups past a tile's last full step.
inline int tile_cols(int rows, int w, int u = 1, int avail = kMaxSmem) {
  int groups = kTileBytes / (rows * w * 2);
  groups = groups < u ? u : groups - groups % u;
  const int fit = avail / (2 * rows * w * 2);
  if (groups > fit) groups = fit > 1 ? fit : 1;
  return groups * w;
}

inline int64_t slice_count(int64_t np, int64_t slice) {
  return np > slice ? (np + slice - 1) / slice : 1;
}

template <int W, int D, Epi E, class C>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int TQ = queries_per_block(W);
  const int rows = C::rows(a.f);
  const int qbytes = static_cast<int>(sizeof(float)) * rows * TQ;
  const int tc = tile_cols(rows, W, cols_per_step(W, D), kMaxSmem - qbytes);
  const size_t smem = qbytes + 2 * (2ull * rows * tc);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto scan = scan_kernel<W, D, E, C>;
  cudaError_t e = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t slice = a.slice > 0 ? a.slice : (a.np > 0 ? a.np : 1);
  // the scan walks the whole W-column groups below ncols; the merge scores
  // the rest of the live columns (SplitPlanes only)
  const int64_t live = a.ncols < a.np ? a.ncols : a.np;
  const int64_t np_scan = live < a.np ? live / W * W : a.np;
  if (np_scan < a.np && !std::is_same<C, SplitPlanes>::value)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tail tail{static_cast<const __nv_bfloat16*>(a.q2), C::q_stride(a.f),
                  a.f, static_cast<const __nv_bfloat16*>(a.ft), a.ft_stride,
                  np_scan, static_cast<int>(live - np_scan)};
  const int64_t slices = slice_count(np_scan, slice);
  const dim3 grid(static_cast<unsigned>((a.b + TQ - 1) / TQ),
                  static_cast<unsigned>(slices));
  scan<<<grid, W, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q2), a.b, a.f,
      static_cast<const __nv_bfloat16*>(a.ft), a.ft_stride, np_scan, tc, slice,
      a.epi, static_cast<float*>(a.wv), static_cast<int32_t*>(a.wi),
      static_cast<float*>(a.wb));
  e = cudaGetLastError();
  if (e != cudaSuccess || !a.merge) return static_cast<int>(e);
  constexpr int R = merge_groups(W);
  const size_t msmem = sizeof(float) * R * (2 * D * W + W);
  merge_kernel<W, D><<<static_cast<unsigned>(a.b), W * R, msmem, stream>>>(
      static_cast<const float*>(a.wv), static_cast<const int32_t*>(a.wi),
      static_cast<const float*>(a.wb), slices, a.b, tail, a.topc,
      static_cast<float*>(a.ov), static_cast<int32_t*>(a.oi),
      static_cast<float*>(a.ob));
  return static_cast<int>(cudaGetLastError());
}

// W bins: a multiple of 128, at most kMaxBins, dividing np and the slice;
// the compact output needs the merge, one slice without it.
inline bool args_ok(const Args& a, int w, int d) {
  return w >= 128 && w <= kMaxBins && w % 128 == 0 && a.np % w == 0 &&
         a.f >= 1 && a.topc >= 0 && a.topc <= d * w && a.np < INT_MAX &&
         a.ncols >= 0 && (a.merge || a.ncols >= a.np) &&
         a.slice >= 0 && a.slice % w == 0 &&
         slice_count(a.np, a.slice > 0 ? a.slice : (a.np > 0 ? a.np : 1)) <=
             (a.merge ? kMaxSlices : 1) &&
         (a.merge || a.topc == 0);
}

template <int D, Epi E, class C>
int dispatch_w(const Args& a, int w, cudaStream_t s) {
  if (a.b == 0) return static_cast<int>(cudaGetLastError());
  if (!args_ok(a, w, D)) return static_cast<int>(cudaErrorInvalidValue);
  switch (w / 128) {
    case 1: return launch<128, D, E, C>(a, s);
    case 2: return launch<256, D, E, C>(a, s);
    case 3: return launch<384, D, E, C>(a, s);
    case 4: return launch<512, D, E, C>(a, s);
    case 5: return launch<640, D, E, C>(a, s);
    case 6: return launch<768, D, E, C>(a, s);
    case 7: return launch<896, D, E, C>(a, s);
    case 8: return launch<1024, D, E, C>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bin_scan
