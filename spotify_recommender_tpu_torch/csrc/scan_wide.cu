// Kernels 1 and 4 at every shape the JAX package's layout gives them: the
// "wide" route of the bin scan, beside the flat instances of bin_scan.cuh.
//
// Replaces, with csrc/scan_v3.cu and csrc/scan_v2.cu, the TPU kernels
// `_scan_kernel_v3` (spotify_recommender_tpu/ops/pallas/fused_topk.py:1069)
// and `_scan_kernel` (v2, :834) at the shapes where the flat instances
// stop: W (bins) above 1024, depth above 4, feature rows too wide for the
// flat tile (F = 64 at W >= 512, F = 256 at any W), and a top-C that the
// merge's argmax rounds would extract slowly.  The TPU kernel keeps depth
// x W in VMEM and a whole (2F, tile) block in one buffer, so it takes them
// all; here a block holds at most 227 KB of shared memory and 255 registers
// a thread.  What it computes is bin_scan.cuh's, bitwise: the same dots
// (SplitPlanes: feature j ascending, then qh*hi, ql*lo, ql*hi, qh*lo), the
// same per-bin top-`depth` with strict `>`, the same bound, the same slot
// layout (slot = level*W + bin).  What bounds it is what bounds the flat
// scan: fp32 FMA issue (B x N x 4F).  Design:
//
// - bin groups.  A scan block owns 128 bins (one a thread) of one
//   W-column group: grid (query tiles of 16, catalog slices, W / 128 bin
//   groups).  Block g stages only columns [g*128, g*128 + 128) of each
//   W-column group, contiguous runs of 256 bytes, with 16-byte `cp.async`
//   copies, so the catalog is still read once per query tile in all.  So
//   every W that is a multiple of 128 runs on the W = 128 block's tiling
//   (16 queries, U = 4 / 2 / 1 columns a step at depth <= 2 / 3 / 4);
// - row chunks.  A stage holds features [j0, j0 + fc) of U W-groups: hi
//   rows [j0, j0+fc) and lo rows [F+j0, F+j0+fc), with the matching query
//   rows (the whole query tile once where one chunk holds all of F).  The
//   accumulators stay in registers across a step's chunks and the
//   features run in ascending order, so each column's FMA sequence is
//   SplitPlanes::row's: the values are bitwise the flat scan's.  fc keeps
//   a stage near the flat tile's 24 KB, so any F fits;
// - depth.  Depths 1-4 keep the flat scan's register lists; 5-8 keep
//   register lists too, on 8 queries a block (TQ * (2D + 1 + U) values
//   under the 255 registers a thread).  Any deeper depth runs one
//   runtime-depth instance whose lists live in the slice's own scratch
//   rows (device memory): per query the thread keeps only the list's last
//   value (`floor`) and the bound in registers, and `s > floor` fails for
//   most columns, but each insert is a chain of dependent loads and
//   stores (depth 9 takes 16x depth 2's time at 1024 x 1M, PERF.md).
//   Its insert is bin_insert's (strict `>`), so the lists are the
//   register lists';
// - the merge folds the slices of each (query, bin) in ascending order, as
//   bin_scan.cuh's does, in blocks of 128 bins x R <= 8 slice groups
//   (group r folds a run of slices; group 0 folds the partials in order),
//   then inserts the columns of the group that straddles `ncols`, and
//   writes the merged full structures (slot = level*W + bin);
// - the compact top-C (`srt_bin_select`): one block of 1024 threads a
//   query.  Each slot's 64-bit key is its value's order-preserving bits
//   (-0.0 made +0.0, so zeros tie as `==` ties them; NaN lowest) over
//   the inverted slot, so key order is value descending, slot ascending,
//   and no two keys are equal.  A radix select (8 passes of 8 bits,
//   warp-aggregated shared-memory histograms) finds the C-th largest key,
//   the keys at or above it are gathered and bitonic-sorted; past 8192
//   keys it goes in chunks of 8192, each below the last chunk's smallest.
//   Any selection in that order is the argmax rounds' output, so the
//   result is bitwise theirs (kernel 3's large-k path, csrc/fused_topk.cu,
//   uses the same keys).

#include "bin_scan.cuh"

namespace {

using bin_scan::Epi;
using bin_scan::Epilogue;
using bin_scan::SplitPlanes;
using bin_scan::Tail;

constexpr int kBins = 128;         // bins of a scan block: one a thread
constexpr int kMaxGroups = 8;      // slice groups of a merge block
constexpr int kSelectThreads = 1024;
constexpr int kSelectChunk = 8192;  // keys sorted at a time

// queries of a scan block: the flat W = 128 instances' 16, and 8 for the
// register lists of depth 5-8, so that TQ * (2D + 1 + U) values (the
// lists, the bounds, the accumulators) stay under 255 registers a thread
__host__ __device__ constexpr int wide_queries(int d) {
  return d > 4 ? 8 : 16;
}

// columns a thread scores per step: the flat W = 128 instances' count at
// depth 1-4, 2 at depth 5-8, and 4 for the runtime depth (D = 0: its
// lists take no registers)
__host__ __device__ constexpr int wide_cols(int d) {
  return d == 0 ? 4 : (d > 4 ? 2 : bin_scan::cols_per_step(kBins, d));
}

// features per stage: a stage of U groups near the flat tile's budget
// (2 rows a feature, U * 128 columns of 2 bytes), balanced over the chunks
inline int chunk_features(int f, int u) {
  const int most = bin_scan::kTileBytes / (2 * u * kBins * 2);
  const int n = (f + most - 1) / most;
  return (f + n - 1) / n;
}

// Inserts s (> the list's last value) into a descending list of `depth`
// (value, column) pairs `stride` apart in device memory, after every
// value >= s (strict `>`, bin_insert's rule); returns the new last value.
__device__ float list_insert(float* lv, int32_t* li, int depth,
                             int64_t stride, float s, int col) {
  int l = depth - 1;
  for (; l > 0; --l) {
    const float up = lv[(l - 1) * stride];
    if (!(s > up)) break;
    lv[l * stride] = up;
    li[l * stride] = li[(l - 1) * stride];
  }
  lv[l * stride] = s;
  li[l * stride] = col;
  return lv[(depth - 1) * stride];
}

// The query rows [j0, j0 + fcs) and [F + j0, F + j0 + fcs) of queries
// q0 .. q0+TQ-1 into qs[2*fcs][TQ], fp32; rows past b are zeros.
template <int TQ>
__device__ __forceinline__ void load_query_chunk(
    float* qs, const __nv_bfloat16* q2, int64_t b, int64_t q0, int f,
    int j0, int fcs, int t) {
  for (int i = t; i < 2 * fcs * TQ; i += kBins) {
    const int r = i / TQ;
    const int qq = i % TQ;
    const int row = r < fcs ? j0 + r : f + j0 + (r - fcs);
    qs[i] = q0 + qq < b ? __bfloat162float(q2[(q0 + qq) * 4LL * f + row])
                        : 0.0f;
  }
}

// Block (x, y, z): queries [TQ x, TQ x + TQ) over the W-column groups of
// slice y, bins [128z, 128z + 128); writes the slice's structures to rows
// y*b + query of wv, wi (slot level*W + bin) and wb (bin).  D = 0: the
// runtime `depth`, its lists kept in wv / wi themselves.
template <int D, Epi E>
__global__ void __launch_bounds__(kBins)
    wide_scan_kernel(const __nv_bfloat16* __restrict__ q2, int64_t b, int f,
                     const __nv_bfloat16* __restrict__ ft, int64_t ft_stride,
                     int64_t np, int w, int depth, int fc, int64_t slice,
                     Epilogue epi, float* wv, int32_t* wi,
                     float* __restrict__ wb) {
  constexpr int kTq = wide_queries(D);
  constexpr int U = wide_cols(D);
  constexpr int TC = U * kBins;   // columns of a stage's tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sqn[kTq];
  __shared__ int64_t sex[kTq];
  const int t = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTq;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * slice;
  const int64_t c1 = np - c0 < slice ? np : c0 + slice;
  const int64_t gcol = static_cast<int64_t>(blockIdx.z) * kBins;
  const int bin = static_cast<int>(gcol) + t;
  const int64_t groups = c1 > c0 ? (c1 - c0) / w : 0;
  const int nchunks = (f + fc - 1) / fc;
  const int64_t stages = (groups + U - 1) / U * nchunks;
  // buffer i: qs[2fc][TQ] f32, then tile[2fc][TC] bf16
  const int64_t qbytes = 4LL * 2 * fc * kTq;
  const int64_t buf = qbytes + 2LL * 2 * fc * TC;
  auto qs_of = [&](int i) {
    return reinterpret_cast<float*>(smem + i * buf);
  };
  auto tile_of = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + i * buf + qbytes);
  };
  // stage s: the W-groups [g, g + nu) of step s / nchunks, the features of
  // chunk s % nchunks, into buffer i
  auto load_stage = [&](int64_t s, int i) {
    const int64_t g = s / nchunks * U;
    const int nu = groups - g < U ? static_cast<int>(groups - g) : U;
    const int j0 = static_cast<int>(s % nchunks) * fc;
    const int fcs = f - j0 < fc ? f - j0 : fc;
    constexpr int kVecs = kBins / 8;   // 16-byte copies of a group's row
    __nv_bfloat16* tile = tile_of(i);
    for (int it = t; it < 2 * fcs * nu * kVecs; it += kBins) {
      const int v = it % kVecs;
      const int u = (it / kVecs) % nu;
      const int r = it / (kVecs * nu);
      const int64_t row = r < fcs ? j0 + r : f + j0 + (r - fcs);
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
          tile + static_cast<int64_t>(r) * TC + u * kBins + 8 * v));
      const void* src = ft + row * ft_stride + c0 + (g + u) * w + gcol + 8 * v;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src));
    }
    if (nchunks > 1)
      load_query_chunk<kTq>(qs_of(i), q2, b, q0, f, j0, fcs, t);
  };

  if (nchunks == 1) {     // the whole query tile, once, in both buffers
    load_query_chunk<kTq>(qs_of(0), q2, b, q0, f, 0, f, t);
    load_query_chunk<kTq>(qs_of(1), q2, b, q0, f, 0, f, t);
  }
  if (E != Epi::kNone && t < kTq) {
    const bool in = q0 + t < b;
    sqn[t] = in ? epi.qn[q0 + t] : 0.0f;
    sex[t] = in ? epi.excl[q0 + t] : -1;
  }

  const int64_t S = static_cast<int64_t>(D > 0 ? D : depth) * w;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * b + q0;
  constexpr int DL = D > 0 ? D : 1;
  float v[kTq][DL];
  int ix[kTq][DL];
  float bnd[kTq];
  float floor_[kTq];   // D = 0: each list's last value (+inf past b)
#pragma unroll
  for (int q = 0; q < kTq; ++q) {
#pragma unroll
    for (int l = 0; l < DL; ++l) {
      v[q][l] = -INFINITY;
      ix[q][l] = -1;
    }
    bnd[q] = -INFINITY;
    floor_[q] = -INFINITY;
    if constexpr (D == 0) {
      if (q0 + q < b) {
        for (int l = 0; l < depth; ++l) {
          wv[(row0 + q) * S + l * w + bin] = -INFINITY;
          wi[(row0 + q) * S + l * w + bin] = -1;
        }
      } else {
        floor_[q] = INFINITY;   // never inserts
      }
    }
  }

  float acc[U][kTq];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int q = 0; q < kTq; ++q) acc[u][q] = 0.0f;
  if (stages > 0) {
    load_stage(0, 0);
    bin_scan::cp_async_commit();
  }
  for (int64_t s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      // stage s+1 into the other buffer, which every thread left at the
      // end of stage s-1
      load_stage(s + 1, static_cast<int>((s + 1) & 1));
      bin_scan::cp_async_commit();
      bin_scan::cp_async_wait<1>();
    } else {
      bin_scan::cp_async_wait<0>();
    }
    __syncthreads();  // stage s (and, at s = 0, the queries) is visible
    const int i = static_cast<int>(s & 1);
    const int c = static_cast<int>(s % nchunks);
    const int fcs = f - c * fc < fc ? f - c * fc : fc;
    SplitPlanes::dot<kTq, U, kBins, true>(qs_of(i), tile_of(i), TC, t, fcs,
                                          acc);
    if (c == nchunks - 1) {
      const int64_t g = s / nchunks * U;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g + u < groups) {
          const int col = static_cast<int>(c0 + (g + u) * w + gcol + t);
          if (E != Epi::kNone) {
            // the cosine epilogue on the raw norms, then the masks
            // (fused_topk.py:922-929)
            const float cnorm = epi.cn[col];
            const bool pad = col >= epi.valid;
#pragma unroll
            for (int q = 0; q < kTq; ++q) {
              const float den = __fmul_rn(sqn[q], cnorm);
              const float sc = den > epi.eps
                                   ? fminf(fmaxf(acc[u][q], -1.0f), 1.0f)
                                   : 0.0f;
              acc[u][q] = (pad || col == sex[q]) ? -INFINITY : sc;
            }
          }
#pragma unroll
          for (int q = 0; q < kTq; ++q) {
            if constexpr (D > 0) {
              bin_scan::bin_insert<DL>(v[q], ix[q], bnd[q], acc[u][q], col);
            } else {
              const float sc = acc[u][q];
              bnd[q] = fmaxf(bnd[q], fminf(sc, floor_[q]));
              if (sc > floor_[q])
                floor_[q] = list_insert(wv + (row0 + q) * S + bin,
                                        wi + (row0 + q) * S + bin, depth, w,
                                        sc, col);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kTq; ++q) acc[u][q] = 0.0f;
      }
    }
    __syncthreads();  // stage s is consumed before its buffer is refilled
  }

#pragma unroll
  for (int q = 0; q < kTq; ++q) {
    if (q0 + q >= b) break;
    const int64_t qg = row0 + q;
    if constexpr (D > 0) {
#pragma unroll
      for (int l = 0; l < DL; ++l) {
        wv[qg * S + l * w + bin] = v[q][l];
        wi[qg * S + l * w + bin] = ix[q][l];
      }
    }
    wb[qg * w + bin] = bnd[q];
  }
}

// Block (x, y): query x, bins [128y, 128y + 128), 128 x R threads.
// Folds the `slices` per-slice structures of each bin in ascending slice
// order (group r a run of them; group 0 then the groups' partials in
// order), then the `tail` columns, and writes the merged full structures
// to ov, oi (b, depth*W) and ob (b, W).  ov / oi may be the scratch's
// slice 0 (each thread rewrites only the slots it read).  D = 0: the
// runtime depth, group r's list kept in its first slice's rows.
template <int D>
__global__ void __launch_bounds__(kBins * kMaxGroups)
    wide_merge_kernel(float* wv, int32_t* wi, const float* wb,
                      int64_t slices, int64_t b, int w, int depth, Tail tail,
                      float* ov, int32_t* oi, float* ob) {
  constexpr int DL = D > 0 ? D : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = blockDim.x / kBins;
  const int t = threadIdx.x % kBins;
  const int r = threadIdx.x / kBins;
  const int bin = blockIdx.y * kBins + t;
  const int64_t qg = blockIdx.x;
  const int64_t S = static_cast<int64_t>(D > 0 ? D : depth) * w;
  // partials: pb[R][128], then (D > 0) pv[R][D][128], pi[R][D][128]
  float* pb = reinterpret_cast<float*>(smem);
  float* pv = pb + R * kBins;
  int* pi = reinterpret_cast<int*>(pv + R * DL * kBins);
  const int64_t per = (slices + R - 1) / R;
  const int64_t s0 = r * per;
  const int64_t s1 = slices < s0 + per ? slices : s0 + per;

  float v[DL];
  int ix[DL];
  float bnd = -INFINITY;
  float fl = -INFINITY;
  float* lv = wv + (s0 * b + qg) * S + bin;   // D = 0: this group's list
  int32_t* li = wi + (s0 * b + qg) * S + bin;
#pragma unroll
  for (int l = 0; l < DL; ++l) {
    v[l] = -INFINITY;
    ix[l] = -1;
  }
  // one (value, column) of a later list into this group's list
  auto insert = [&](float x, int col) {
    if constexpr (D > 0) {
      bin_scan::bin_insert<DL>(v, ix, bnd, x, col);
    } else {
      bnd = fmaxf(bnd, fminf(x, fl));
      if (x > fl) fl = list_insert(lv, li, depth, w, x, col);
    }
  };
  if (s0 < s1) {
    int64_t s = s0;
    if constexpr (D == 0) {
      // the first slice's list is the fold of it into an empty list
      fl = lv[(depth - 1) * static_cast<int64_t>(w)];
      bnd = wb[(s0 * b + qg) * w + bin];
      ++s;
    }
    for (; s < s1; ++s) {
      const int64_t row = s * b + qg;
      for (int l = 0; l < (D > 0 ? D : depth); ++l)
        insert(wv[row * S + l * w + bin], wi[row * S + l * w + bin]);
      bnd = fmaxf(bnd, wb[row * w + bin]);
    }
  }
  if (R > 1) {
    pb[r * kBins + t] = bnd;
    if constexpr (D > 0) {
#pragma unroll
      for (int l = 0; l < DL; ++l) {
        pv[(r * DL + l) * kBins + t] = v[l];
        pi[(r * DL + l) * kBins + t] = ix[l];
      }
    }
    __syncthreads();  // the partials (and D = 0: the groups' lists) are set
    if (r == 0) {
      for (int g = 1; g < R && g * per < slices; ++g) {
        if constexpr (D > 0) {
#pragma unroll
          for (int l = 0; l < DL; ++l)
            insert(pv[(g * DL + l) * kBins + t], pi[(g * DL + l) * kBins + t]);
        } else {
          const int64_t row = g * per * b + qg;
          for (int l = 0; l < depth; ++l)
            insert(wv[row * S + l * w + bin], wi[row * S + l * w + bin]);
        }
        bnd = fmaxf(bnd, pb[g * kBins + t]);
      }
    }
  }
  if (r != 0) return;
  if (bin < tail.n) {
    // column col0 + bin lies in bin `bin`; its dot sums the products in
    // the scan's order (SplitPlanes::row), so it is the scan's value
    const __nv_bfloat16* q = tail.q2 + qg * tail.q_stride;
    const int64_t col = tail.col0 + bin;
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
    insert(s, static_cast<int>(col));
  }
  if constexpr (D > 0) {
#pragma unroll
    for (int l = 0; l < D; ++l) {
      ov[qg * S + l * w + bin] = v[l];
      oi[qg * S + l * w + bin] = ix[l];
    }
  } else {
    for (int l = 0; l < depth; ++l) {
      ov[qg * S + l * w + bin] = lv[l * static_cast<int64_t>(w)];
      oi[qg * S + l * w + bin] = li[l * static_cast<int64_t>(w)];
    }
  }
  ob[qg * w + bin] = bnd;
}

// The order of the compact output as one 64-bit key: larger ranks first.
__device__ __forceinline__ unsigned long long slot_key(float x, int slot) {
  unsigned u = __float_as_uint(x);
  if (x == 0.0f) u = 0u;                                // -0.0 ties +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);       // order-preserving
  if (x != x) u = 0u;                                   // NaN ranks last
  return (static_cast<unsigned long long>(u) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(slot));
}

// Block x: query x.  The top-`topc` of the S = depth*W slots of sv / si
// (b, S) by value descending, slot ascending, into ov, oi (b, topc), and
// the max over sb (b, W) into ob (b,).
__global__ void __launch_bounds__(kSelectThreads)
    select_kernel(const float* __restrict__ sv, const int32_t* __restrict__ si,
                  const float* __restrict__ sb, int64_t S, int w, int topc,
                  float* __restrict__ ov, int32_t* __restrict__ oi,
                  float* __restrict__ ob) {
  extern __shared__ __align__(16) unsigned long long keys[];  // chunk
  __shared__ unsigned hist[256];
  __shared__ float red[kSelectThreads / 32];
  __shared__ unsigned sel_digit, sel_rank;
  __shared__ int count;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int64_t qg = blockIdx.x;
  const float* vals = sv + qg * S;

  float m = -INFINITY;
  for (int i = t; i < w; i += kSelectThreads) m = fmaxf(m, sb[qg * w + i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = red[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) ob[qg] = m;
  }

  unsigned long long upper = ~0ull;   // this chunk's keys lie below it
  for (int lo = 0; lo < topc; lo += kSelectChunk) {
    const int c = topc - lo < kSelectChunk ? topc - lo : kSelectChunk;
    // the c-th largest key below `upper`, 8 bits a pass from the top
    unsigned long long prefix = 0, mask = 0;
    unsigned rank = static_cast<unsigned>(c);
    for (int shift = 56; shift >= 0; shift -= 8) {
      if (t < 256) hist[t] = 0;
      __syncthreads();
      for (int64_t base = 0; base < S; base += kSelectThreads) {
        const int64_t slot = base + t;
        unsigned digit = 256u;   // no key
        if (slot < S) {
          const unsigned long long k = slot_key(vals[slot],
                                                static_cast<int>(slot));
          if (k < upper && (k & mask) == prefix)
            digit = static_cast<unsigned>(k >> shift) & 255u;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, digit);
        if (digit < 256u && __ffs(peers) - 1 == lane)
          atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
      }
      __syncthreads();
      if (warp == 0) {
        // lane L holds digits 255 - 8L down to 248 - 8L; count the keys
        // above each and find the digit that holds the rank-th
        unsigned n[8], tot = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          n[j] = hist[255 - 8 * lane - j];
          tot += n[j];
        }
        unsigned incl = tot;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned x = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += x;
        }
        unsigned above = incl - tot;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above < rank && rank <= above + n[j]) {
            sel_digit = 255u - 8u * lane - j;
            sel_rank = rank - above;
          }
          above += n[j];
        }
      }
      __syncthreads();
      prefix |= static_cast<unsigned long long>(sel_digit) << shift;
      mask |= 0xFFull << shift;
      rank = sel_rank;
    }
    // the c keys in [prefix, upper), sorted descending
    if (t == 0) count = 0;
    __syncthreads();
    for (int64_t slot = t; slot < S; slot += kSelectThreads) {
      const unsigned long long k = slot_key(vals[slot], static_cast<int>(slot));
      if (k >= prefix && k < upper) keys[atomicAdd(&count, 1)] = k;
    }
    int p = 1;
    while (p < c) p <<= 1;
    __syncthreads();
    for (int i = c + t; i < p; i += kSelectThreads) keys[i] = 0ull;
    __syncthreads();
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        for (int i = t; i < p / 2; i += kSelectThreads) {
          const int a = 2 * i - (i & (stride - 1));
          const int e = a + stride;
          const unsigned long long ka = keys[a], ke = keys[e];
          if ((ka < ke) == ((a & size) == 0)) {
            keys[a] = ke;
            keys[e] = ka;
          }
        }
        __syncthreads();
      }
    }
    for (int i = t; i < c; i += kSelectThreads) {
      const int slot = static_cast<int>(0xFFFFFFFFu -
                                        static_cast<unsigned>(keys[i]));
      ov[qg * topc + lo + i] = vals[slot];
      oi[qg * topc + lo + i] = si[qg * S + slot];
    }
    upper = prefix;
    __syncthreads();  // the keys are written out before the next chunk
  }
}

struct WideArgs {
  const void* q2;
  int64_t b;
  int f;
  const void* ft;
  int64_t ft_stride, np, ncols;
  Epilogue epi;
  int w, depth;
  int64_t slice;
  void* wv;
  void* wi;
  void* wb;
  void* ov;
  void* oi;
  void* ob;
};

template <int D, Epi E>
int run_wide(const WideArgs& a, cudaStream_t stream) {
  constexpr int kTq = wide_queries(D);
  constexpr int U = wide_cols(D);
  const int fc = chunk_features(a.f, U);
  const size_t smem = 2 * (4ull * 2 * fc * kTq + 2ull * 2 * fc * U * kBins);
  auto scan = wide_scan_kernel<D, E>;
  cudaError_t e = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // the scan walks the whole W-column groups below ncols; the merge scores
  // the rest of the live columns
  const int64_t live = a.ncols < a.np ? a.ncols : a.np;
  const int64_t np_scan = live < a.np ? live / a.w * a.w : a.np;
  const Tail tail{static_cast<const __nv_bfloat16*>(a.q2), 4LL * a.f, a.f,
                  static_cast<const __nv_bfloat16*>(a.ft), a.ft_stride,
                  np_scan, static_cast<int>(live - np_scan)};
  const int64_t slices = bin_scan::slice_count(np_scan, a.slice);
  const dim3 grid(static_cast<unsigned>((a.b + kTq - 1) / kTq),
                  static_cast<unsigned>(slices),
                  static_cast<unsigned>(a.w / kBins));
  scan<<<grid, kBins, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q2), a.b, a.f,
      static_cast<const __nv_bfloat16*>(a.ft), a.ft_stride, np_scan, a.w,
      a.depth, fc, a.slice, a.epi, static_cast<float*>(a.wv),
      static_cast<int32_t*>(a.wi), static_cast<float*>(a.wb));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = static_cast<int>(slices < kMaxGroups ? slices : kMaxGroups);
  const size_t msmem =
      sizeof(float) * R * kBins * (1 + (D > 0 ? 2 * D : 0));
  e = cudaFuncSetAttribute(wide_merge_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(msmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_merge_kernel<D><<<dim3(static_cast<unsigned>(a.b),
                              static_cast<unsigned>(a.w / kBins)),
                         kBins * R, msmem, stream>>>(
      static_cast<float*>(a.wv), static_cast<int32_t*>(a.wi),
      static_cast<const float*>(a.wb), slices, a.b, a.w, a.depth, tail,
      static_cast<float*>(a.ov), static_cast<int32_t*>(a.oi),
      static_cast<float*>(a.ob));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernels 1 (epi 0: no epilogue, columns >= ncols out of the bins, any
// depth >= 1) and 4 (epi 1: the cosine epilogue and masks of
// csrc/scan_v2.cu, depth 3, ncols = np) on the wide route.  q2 (b, 4f)
// bf16; qn (b,) f32 (epi 1); ft (>= 2f rows, row stride ft_stride, a
// multiple of 8) bf16 with np columns, a multiple of w (a multiple of 128);
// cn (np,) f32, excl (b,) int64 (epi 1); slice: columns per catalog slice
// (a multiple of w, at most 65,535 slices); scratch wv, wi (ceil(np /
// slice), b, depth*w) f32 / i32, wb (ceil(np / slice), b, w) f32; out the
// merged full structures ov, oi (b, depth*w) f32 / i32 (may be wv, wi)
// and ob (b, w) f32.  Returns cudaGetLastError().
extern "C" int srt_scan_wide(const void* q2, const void* qn, int64_t b, int f,
                             const void* ft, int64_t ft_stride,
                             const void* cn, int64_t np, int64_t ncols,
                             const void* excl, int64_t valid, float eps,
                             int epi, int w, int depth, int64_t slice,
                             void* wv, void* wi, void* wb, void* ov, void* oi,
                             void* ob, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (w < kBins || w % kBins || w / kBins > 65535 || np % w || f < 1 ||
      depth < 1 || slice < 1 || slice % w || np >= INT_MAX || ncols < 0 ||
      bin_scan::slice_count(np, slice) > bin_scan::kMaxSlices ||
      ft_stride % 8 || (epi == 1 && ncols < np))
    return invalid;
  const WideArgs a{q2, b, f, ft, ft_stride, np, ncols,
                   {static_cast<const float*>(qn),
                    static_cast<const float*>(cn),
                    static_cast<const int64_t*>(excl), valid, eps},
                   w, depth, slice, wv, wi, wb, ov, oi, ob};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr Epi kNone = Epi::kNone;
  if (epi == 1)
    return depth == 3 ? run_wide<3, Epi::kGuardClipMask>(a, s) : invalid;
  if (epi != 0) return invalid;
  switch (depth) {
    case 1: return run_wide<1, kNone>(a, s);
    case 2: return run_wide<2, kNone>(a, s);
    case 3: return run_wide<3, kNone>(a, s);
    case 4: return run_wide<4, kNone>(a, s);
    case 5: return run_wide<5, kNone>(a, s);
    case 6: return run_wide<6, kNone>(a, s);
    case 7: return run_wide<7, kNone>(a, s);
    case 8: return run_wide<8, kNone>(a, s);
    default: return run_wide<0, kNone>(a, s);   // depth > 8
  }
}

// The compact output from full structures: sv, si (b, depth*w) f32 / i32,
// sb (b, w) f32 -> ov, oi (b, topc), 1 <= topc <= depth*w, ob (b,) the max
// bound.  Returns cudaGetLastError().
extern "C" int srt_bin_select(const void* sv, const void* si, const void* sb,
                              int64_t b, int w, int depth, int topc, void* ov,
                              void* oi, void* ob, void* stream) {
  const int64_t S = static_cast<int64_t>(depth) * w;
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (w < 1 || depth < 1 || topc < 1 || topc > S || S >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int p = 1;
  while (p < topc && p < kSelectChunk) p <<= 1;
  const size_t smem = sizeof(unsigned long long) * p;
  cudaError_t e = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(unsigned long long) * kSelectChunk));
  if (e != cudaSuccess) return static_cast<int>(e);
  select_kernel<<<static_cast<unsigned>(b), kSelectThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sv), static_cast<const int32_t*>(si),
      static_cast<const float*>(sb), S, w, topc, static_cast<float*>(ov),
      static_cast<int32_t*>(oi), static_cast<float*>(ob));
  return static_cast<int>(cudaGetLastError());
}
