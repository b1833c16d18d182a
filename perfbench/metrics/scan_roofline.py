"""scan_roofline: kernel 1's share of its roofline, in %: the same least
time as step_mfu (metrics/_roofline.py), over kernel 1's device time per
batch in the traced window.  Kernel 1 is the v3 bin scan with its merge:
the flat instances of csrc/bin_scan.cuh (`bin_scan::scan_kernel`,
`bin_scan::merge_kernel`) and the wide route of csrc/scan_wide.cu
(`wide_scan_kernel`, `wide_merge_kernel`, `select_kernel`), the depth-3
rescan's launches included.  Moves queries_per_s."""

from __future__ import annotations

from perfbench.metrics import _roofline

KERNELS = ("bin_scan::scan_kernel", "bin_scan::merge_kernel",
           "wide_scan_kernel", "wide_merge_kernel", "select_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or not t.batches:
        return None
    busy = sum(d for name, d in t.kernel_seconds.items()
               if any(p in name for p in KERNELS))
    if busy <= 0.0:
        return None
    return _roofline.share_pct(
        _roofline.min_batch_s(ctx.batch, ctx.rows, ctx.features, ctx.k),
        busy / t.batches)
