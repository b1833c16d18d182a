"""certified_host_ms: host milliseconds a batch that the certified tier
spends issuing its work: the program's "cert.start" and "cert.finish"
spans less its "cert.sync" spans (the host's reads of the failures, each
wait for the card included), over the measured window's batches.  Moves
queries_per_s.

The spans are the program's own (`Retriever.record_spans`, a
`core/timing.Spans`), read from the recorder's totals, which `snapshot`
copies before and after the window.  `snapshot` turns recording on, so a
`--trace 1` run records spans from its first snapshot on, and its
`step_mfu` includes the recording's cost (a few microseconds of host time
a span).  A program without `record_spans` has nothing to read: None."""

from __future__ import annotations


def snapshot(system):
    """The recorder's totals ({name: {"count", "s", "self_s"}}), recording
    turned on; None where the system cannot record spans."""
    on = getattr(system, "record_spans", None)
    return None if on is None else on().totals()


def read(ctx):
    before, after = ctx.snapshots.get("certified_host_ms", (None, None))
    if (before is None or after is None or not ctx.window.batches
            or "cert.start" not in after):
        return None

    def s(name):
        return (after.get(name, {}).get("s", 0.0)
                - before.get(name, {}).get("s", 0.0))

    host = s("cert.start") + s("cert.finish") - s("cert.sync")
    return 1e3 * host / ctx.window.batches
