"""The yardstick of the roofline metrics: the card's published peaks and
the operations and bytes that an exact top-k batch needs, counted from the
problem's shapes, never from one implementation's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the full
700 W power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.  bf16 is the
highest rate at which any exact split of the fp32 products can run
(a bf16x2 split multiplies on those units), so a share of it cannot pass
100 % whatever implements the batch.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense
PEAK_BYTES_PER_S = 3.35e12   # HBM3


def batch_ops(b: int, n: int, f: int) -> float:
    """Multiply-adds of B queries against N rows of F features, as flops."""
    return 2.0 * b * n * f


def batch_bytes(b: int, n: int, f: int, k: int) -> float:
    """Each input byte read once, each output byte written once: the fp32
    catalog, the fp32 queries, and (fp32 score, int32 row) per answer."""
    return 4.0 * n * f + 4.0 * b * f + 8.0 * b * k


def min_batch_s(b: int, n: int, f: int, k: int) -> float:
    """The least time any exact implementation could take for one batch:
    the larger of its operations over the peak rate and its bytes over the
    peak bandwidth."""
    return max(batch_ops(b, n, f) / PEAK_FLOPS,
               batch_bytes(b, n, f, k) / PEAK_BYTES_PER_S)


def bound_by(b: int, n: int, f: int, k: int) -> str:
    """"operations" or "bytes": which of the two sets `min_batch_s`."""
    return ("operations" if batch_ops(b, n, f) / PEAK_FLOPS
            >= batch_bytes(b, n, f, k) / PEAK_BYTES_PER_S else "bytes")


def share_pct(min_s: float, measured_s: float):
    """100 * min_s / measured_s, or None where nothing was measured."""
    if not measured_s or measured_s <= 0.0:
        return None
    return 100.0 * min_s / measured_s
