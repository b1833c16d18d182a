// The bin-scan prototypes of `experiments/`: TPU kernels 9-12.
//
// Replaces:
//   srt_mxu_only   `_mxu_kernel` / `mxu_only` (experiments/kernel_r3.py:53,
//                   :78): the running max, per lane `col mod 128`, of the
//                   dots; no index, no bound;
//   srt_scan_d1     the closure `kern` of `scan_d1` (kernel_r3.py:151, :137):
//                   depth-1 bins plus the 2nd-best bound on the raw dots;
//   srt_scan_d1_split  `scan_d1(invert=True)`, the catalog-outer schedule,
//                   as a catalog split across blocks plus a per-bin merge;
//   srt_proto_scan  `_scan_kernel` / `scan_call` (experiments/
//                   certified_proto.py:18, :86): depth-3 bins plus the
//                   4th-value bound, guard, clip and masks; and, at
//                   W = 256 with the masks off (no exclusion, every column
//                   valid), `k_scan3` / `run_scan3` (experiments/
//                   kernel_ablation_r2e.py:26, :74), the same scan with
//                   guard and clip alone.
//
// Every prototype contracts its (B, qw) bf16 query with catalog rows
// [0, qw) in one `dot_general`: the Plain policy of bin_scan.cuh (qw FMAs
// of exact bf16 products in ascending row order).  Rows 9 and 12 feed
// qw = 24 ([qh, ql] against [hi; lo]: qh*hi + ql*lo, without the cross
// terms ql*hi + qh*lo, as the prototypes do); kernel_r3.py feeds qw = 48.
// The scans with bins are instances of bin_scan.cuh's kernel (full
// structures, slot = level*W + bin, which is the prototypes' output
// layout); rows 9 and 12 are one instance.
//
// What bounds them on an H100: fp32 FMA issue, B x Np x qw FMAs (1024 x
// 10M x 48 = 0.5 T FMAs for kernel_r3.py's main) against qw * 2 bytes of
// catalog per column.  Design:
//
// - `mxu_only` stays the floor probe it was written as: one running max
//   per lane per query, so a thread of a 128-thread block keeps TQ = 16
//   maxima and nothing else.  Its blocks cover (query tile x catalog
//   slice), so every SM works at any B, and a second kernel takes the max
//   over the slices (exact, so the result does not depend on the split);
// - `scan_d1_split` splits the catalog the same way: it is bin_scan.cuh's
//   two kernels at depth 1 (each block walks one slice, a multiple of W
//   columns, and writes its slice's depth-1 structures; the merge folds
//   the slices in order: the earlier slice, the lower column, wins ties,
//   and the bound is max(b_a, b_b, min(v1_a, v1_b))).  Max and min are
//   exact, so the result is bitwise the single walk's.  The wrappers
//   (ops/cuda/proto_scans.py) pick the slices so that the grid covers the
//   card several times over;
// - `scan_d1` and `proto_scan` keep the prototypes' single walk: the scan
//   kernel over one slice, writing the outputs directly.

#include "bin_scan.cuh"

namespace {

using bin_scan::Args;
using bin_scan::Epi;
using bin_scan::Epilogue;
using bin_scan::Plain;

constexpr int kLanes = 128;   // mxu_only's lanes: column mod 128
constexpr int kMxuTQ = 16;    // queries per mxu_only block
constexpr int kMergeThreads = 256;

int err_invalid() { return static_cast<int>(cudaErrorInvalidValue); }

unsigned merge_blocks(int64_t n) {
  return static_cast<unsigned>((n + kMergeThreads - 1) / kMergeThreads);
}

// Per (query, lane) the max of the dots of the slice's columns in that
// lane, to part[(slice * b + query) * 128 + lane].
__global__ void __launch_bounds__(kLanes)
    mxu_kernel(const __nv_bfloat16* __restrict__ q, int64_t b, int qw,
               const __nv_bfloat16* __restrict__ ft, int64_t ft_stride,
               int64_t np, int tc, int64_t slice, float* __restrict__ part) {
  constexpr int TQ = kMxuTQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * slice;
  const int64_t c1 = np - c0 < slice ? np : c0 + slice;
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(qs + qw * TQ);
  bin_scan::load_queries<kLanes, TQ, Plain>(qs, q, b, q0, qw, t);

  float m[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) m[i] = -INFINITY;
  for (int64_t base = c0; base < c1; base += tc) {
    const int cols = static_cast<int>(c1 - base < tc ? c1 - base : tc);
    __syncthreads();  // the previous tile is consumed; qs is written
    bin_scan::load_tile<kLanes>(tile, ft, ft_stride, base, qw, cols, tc, t);
    __syncthreads();
    for (int cc = t; cc < cols; cc += kLanes) {
      float acc[1][TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[0][i] = 0.0f;
      Plain::dot<TQ, 1, kLanes, false>(qs, tile, tc, cc, qw, acc);
#pragma unroll
      for (int i = 0; i < TQ; ++i) m[i] = fmaxf(m[i], acc[0][i]);
    }
  }
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * b + q0;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (q0 + i >= b) break;
    part[(row0 + i) * kLanes + t] = m[i];
  }
}

// out[i] = the max over the slices of part[s * n + i].
__global__ void max_merge(const float* __restrict__ part, int64_t slices,
                          int64_t n, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kMergeThreads +
                    threadIdx.x;
  if (i >= n) return;
  float m = part[i];
  for (int64_t s = 1; s < slices; ++s) m = fmaxf(m, part[s * n + i]);
  out[i] = m;
}

}  // namespace

// q (b, qw) bf16; ft (>= qw rows, row stride ft_stride) bf16 with np
// columns (a multiple of 128); slice: columns per catalog slice (a multiple
// of 128); part (ceil(np / slice), b, 128) f32 scratch; out (b, 128) f32.
// Returns cudaGetLastError().
extern "C" int srt_mxu_only(const void* q, int64_t b, int qw, const void* ft,
                            int64_t ft_stride, int64_t np, int64_t slice,
                            void* part, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (qw < 1 || np % kLanes || np >= INT_MAX || slice < kLanes ||
      slice % kLanes)
    return err_invalid();
  const int64_t slices = bin_scan::slice_count(np, slice);
  if (slices > bin_scan::kMaxSlices) return err_invalid();
  const int tc = bin_scan::tile_cols(qw, kLanes);
  const size_t smem = sizeof(float) * qw * kMxuTQ + 2ull * qw * tc;
  if (smem > static_cast<size_t>(bin_scan::kMaxSmem)) return err_invalid();
  cudaError_t e = cudaFuncSetAttribute(
      mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((b + kMxuTQ - 1) / kMxuTQ),
                  static_cast<unsigned>(slices));
  mxu_kernel<<<grid, kLanes, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), b, qw,
      static_cast<const __nv_bfloat16*>(ft), ft_stride, np, tc, slice,
      static_cast<float*>(part));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n = b * kLanes;
  max_merge<<<merge_blocks(n), kMergeThreads, 0, s>>>(
      static_cast<const float*>(part), slices, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// q (b, qw) bf16; ft as above with np a multiple of w; out ov (b, w) f32,
// oi (b, w) i32, ob (b, w) f32: per bin the best (value, column) and the
// 2nd-best value, over one walk of the catalog per query tile.
extern "C" int srt_scan_d1(const void* q, int64_t b, int qw, const void* ft,
                           int64_t ft_stride, int64_t np, int w, void* ov,
                           void* oi, void* ob, void* stream) {
  const Args a{q, b, qw, ft, ft_stride, np, 0, {}, 0, ov, oi, ob, false,
               ov, oi, ob};
  return bin_scan::dispatch_w<1, Epi::kNone, Plain>(
      a, w, static_cast<cudaStream_t>(stream));
}

// As srt_scan_d1, over catalog slices of `slice` columns (a multiple of w):
// wv, wi, wb (ceil(np / slice), b, w) scratch, then the merge into ov, oi,
// ob.
extern "C" int srt_scan_d1_split(const void* q, int64_t b, int qw,
                                 const void* ft, int64_t ft_stride,
                                 int64_t np, int w, int64_t slice, void* wv,
                                 void* wi, void* wb, void* ov, void* oi,
                                 void* ob, void* stream) {
  if (slice <= 0) return err_invalid();
  const Args a{q, b, qw, ft, ft_stride, np, 0, {}, slice, wv, wi, wb, true,
               ov, oi, ob};
  return bin_scan::dispatch_w<1, Epi::kNone, Plain>(
      a, w, static_cast<cudaStream_t>(stream));
}

// q (b, qw) bf16; qn (b,) f32 raw query norms; ft as above with np a
// multiple of w (a multiple of 128 up to 1024); cn (np,) f32 raw catalog
// norms; excl (b,) int64 (-1 = none) and columns >= valid score -inf.  Out
// ov (b, 3w) f32 [v1 | v2 | v3], oi (b, 3w) i32 [i1 | i2 | i3], ob (b, w)
// f32 v4.  `scan3` is this scan at W = 256 with no exclusion and
// valid = np.
extern "C" int srt_proto_scan(const void* q, const void* qn, int64_t b,
                              int qw, const void* ft, int64_t ft_stride,
                              const void* cn, int64_t np, const void* excl,
                              int64_t valid, float eps, int w, void* ov,
                              void* oi, void* ob, void* stream) {
  const Epilogue epi{static_cast<const float*>(qn),
                     static_cast<const float*>(cn),
                     static_cast<const int64_t*>(excl), valid, eps};
  const Args a{q, b, qw, ft, ft_stride, np, 0, epi, 0, ov, oi, ob, false,
               ov, oi, ob};
  return bin_scan::dispatch_w<3, Epi::kGuardClipMask, Plain>(
      a, w, static_cast<cudaStream_t>(stream));
}
