"""fallbacks_per_batch: queries a batch sends to the certified tier's
oracle fallback (`CertifiedRetriever.fallbacks`, counted by the program),
over the measured window.  Moves queries_per_s."""

from __future__ import annotations


def snapshot(system):
    cert = getattr(system, "certified", None)
    return None if cert is None else cert.fallbacks


def read(ctx):
    before, after = ctx.snapshots.get("fallbacks_per_batch", (None, None))
    if before is None or after is None or not ctx.window.batches:
        return None
    return (after - before) / ctx.window.batches
