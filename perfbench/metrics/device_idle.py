"""device_idle: the share of the traced window, in %, in which no
operation ran on the card (torch.profiler's device events, their union
taken).  Moves queries_per_s."""

from __future__ import annotations


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
