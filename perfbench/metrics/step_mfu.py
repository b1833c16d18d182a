"""step_mfu: the whole batch's share of the card's peak, in %: the least
time any exact implementation could take (metrics/_roofline.py) over the
mean batch time of the measured window (its whole time over its batches).
Moves queries_per_s."""

from __future__ import annotations

from perfbench.metrics import _roofline


def read(ctx):
    w = ctx.window
    if not w.batches:
        return None
    return _roofline.share_pct(
        _roofline.min_batch_s(ctx.batch, ctx.rows, ctx.features, ctx.k),
        w.seconds / w.batches)
