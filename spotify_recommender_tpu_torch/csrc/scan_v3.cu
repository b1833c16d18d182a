// Kernel 1 of the certified exact tier: the epilogue-free bf16x2 bin scan
// (v3).
//
// Replaces the TPU kernel `_scan_kernel_v3` / `_scan_call_v3`
// (spotify_recommender_tpu/ops/pallas/fused_topk.py:1069, :1230).  The scan
// itself, what bounds it and its design are in bin_scan.cuh; v3 scores are
// the raw split-plane dots of unit vectors (no epilogue, no masks: the
// rerank drops the excluded row), on the flat instances: depth 1-4, any W
// that is a multiple of 128 up to 1024, rows that fit the tile, a top-C
// the argmax rounds extract: the catalog-split scan, then the merge with
// the top-C extraction.  Every other shape runs csrc/scan_wide.cu's wide
// route (ops/cuda/scan_v3.scan_route picks).  Columns >= ncols (the layout's pad columns past
// the catalog's rows) never enter a bin, so a query whose real scores are
// all below 0 still fills its bins with real columns.

#include "bin_scan.cuh"

// q2 (b, 4f) bf16; ft (>= 2f rows, row stride ft_stride) bf16 with np
// columns (a multiple of w), of which the first ncols are scanned; slice:
// columns per catalog slice (a multiple of w, at most 65,535 slices);
// scratch wv, wi (ceil(np / slice), b, depth*w) f32 / i32, wb (ceil(np /
// slice), b, w) f32; out ov (b, topc) f32, oi (b, topc) i32, ob (b,) f32.
// Returns cudaGetLastError().
extern "C" int srt_scan_v3(const void* q2, int64_t b, int f, const void* ft,
                           int64_t ft_stride, int64_t np, int64_t ncols,
                           int w, int depth, int topc, int64_t slice,
                           void* wv, void* wi, void* wb, void* ov, void* oi,
                           void* ob, void* stream) {
  using bin_scan::dispatch_w;
  using bin_scan::SplitPlanes;
  constexpr bin_scan::Epi kNone = bin_scan::Epi::kNone;
  const bin_scan::Args a{q2, b, f, ft, ft_stride, np, topc, {}, slice,
                         wv, wi, wb, true, ov, oi, ob, ncols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (topc < 1 || slice < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (depth) {
    case 1: return dispatch_w<1, kNone, SplitPlanes>(a, w, s);
    case 2: return dispatch_w<2, kNone, SplitPlanes>(a, w, s);
    case 3: return dispatch_w<3, kNone, SplitPlanes>(a, w, s);
    case 4: return dispatch_w<4, kNone, SplitPlanes>(a, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
