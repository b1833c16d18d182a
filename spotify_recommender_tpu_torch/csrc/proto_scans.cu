// The bin-scan prototypes of `experiments/`: TPU kernels 9, 11 and 12
// (kernel 10, `mxu_only`, runs on the tensor cores: csrc/mxu_wgmma.cu).
//
// Replaces:
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
// [0, qw) in one `dot_general`: here the Plain policy of bin_scan.cuh (qw
// FMAs of exact bf16 products in ascending row order).  Rows 9 and 12 feed
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
// - `scan_d1_split` splits the catalog across blocks: it is bin_scan.cuh's
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

int err_invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// q (b, qw) bf16; ft (>= qw rows, row stride ft_stride) bf16 with np
// columns, a multiple of w; out ov (b, w) f32, oi (b, w) i32, ob (b, w)
// f32: per bin the best (value, column) and the 2nd-best value, over one
// walk of the catalog per query tile.
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
