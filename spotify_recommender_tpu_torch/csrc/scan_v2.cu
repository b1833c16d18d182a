// Kernel 4 of the certified exact tier: the bf16x2 bin scan with the cosine
// epilogue and the masks inside (v2).
//
// Replaces the TPU kernel `_scan_kernel` / `_scan_call`
// (spotify_recommender_tpu/ops/pallas/fused_topk.py:834, :1007), which
// `CertifiedRetriever` runs under `RetrievalConfig(scan="v2")`.  The scan
// itself, what bounds it and its design are in bin_scan.cuh.  What v2 adds,
// per (query, column), after the split-plane dot of the unit vectors:
//
//   score = qn*cn > eps ? clamp(dot, -1, 1) : 0      on the RAW norms, the
//                                                    exact tier's guard
//   score = -inf where col >= valid or col == excl
//
// at depth 3, so the certificate needs no guard clause and the rerank no
// masks.  Bins: any W that is a multiple of 128 up to 1024 (the TPU default
// is 512) on these flat instances; wider W, rows too wide for their tile
// and a large top-C run csrc/scan_wide.cu's wide route.  topc = 0 writes
// the full (B, 3W) / (B, 3W) / (B, W) structures.  Like kernel 1, it runs
// as the catalog-split scan and the merge.

#include "bin_scan.cuh"

// q2 (b, 4f) bf16; qn (b,) f32; ft (>= 2f rows, row stride ft_stride) bf16
// with np columns (a multiple of w); cn (np,) f32; excl (b,) int64; slice:
// columns per catalog slice (a multiple of w, at most 65,535 slices);
// scratch wv, wi (ceil(np / slice), b, 3w) f32 / i32, wb (ceil(np / slice),
// b, w) f32.
// Compact (topc > 0): ov (b, topc) f32, oi (b, topc) i32, ob (b,) f32.
// Full (topc = 0): ov (b, 3w) f32, oi (b, 3w) i32, ob (b, w) f32.
// Returns cudaGetLastError().
extern "C" int srt_scan_v2(const void* q2, const void* qn, int64_t b, int f,
                           const void* ft, int64_t ft_stride, const void* cn,
                           int64_t np, const void* excl, int64_t valid,
                           float eps, int w, int topc, int64_t slice,
                           void* wv, void* wi, void* wb, void* ov, void* oi,
                           void* ob, void* stream) {
  const bin_scan::Epilogue epi{static_cast<const float*>(qn),
                               static_cast<const float*>(cn),
                               static_cast<const int64_t*>(excl), valid, eps};
  const bin_scan::Args a{q2, b, f, ft, ft_stride, np, topc, epi, slice,
                         wv, wi, wb, true, ov, oi, ob};
  if (slice < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bin_scan::dispatch_w<3, bin_scan::Epi::kGuardClipMask,
                              bin_scan::SplitPlanes>(
      a, w, static_cast<cudaStream_t>(stream));
}
