"""card_wait_ms: host milliseconds a batch blocked on the card: the
program's "cert.sync" spans (the certified tier's reads of the failures)
and its "entry.to_host" span (the answers' copies to the host, after the
card's queued work), over the measured window's batches.  Moves
queries_per_s: a host-side gain raises it while the batch time falls, and
it bounds what such a gain can take.

The spans are the program's own (`Retriever.record_spans`, a
`core/timing.Spans`), read from the recorder's totals, which `snapshot`
copies before and after the window.  `snapshot` turns recording on, so a
`--trace 1` run records spans from its first snapshot on, and its
`step_mfu` includes the recording's cost (a few microseconds of host time
a span).  A program without `record_spans` has nothing to read: None."""

from __future__ import annotations

WAITS = ("cert.sync", "entry.to_host")


def snapshot(system):
    """The recorder's totals ({name: {"count", "s", "self_s"}}), recording
    turned on; None where the system cannot record spans."""
    on = getattr(system, "record_spans", None)
    return None if on is None else on().totals()


def read(ctx):
    before, after = ctx.snapshots.get("card_wait_ms", (None, None))
    if (before is None or after is None or not ctx.window.batches
            or not any(n in after for n in WAITS)):
        return None
    wait = sum(after.get(n, {}).get("s", 0.0) - before.get(n, {}).get("s", 0.0)
               for n in WAITS)
    return 1e3 * wait / ctx.window.batches
