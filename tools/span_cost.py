"""What recording the port's spans costs, where a batch's host time goes,
and what the card's idle gaps are named by, on a benchmark cell.

    python3 tools/span_cost.py --workload audio12-1m.b1024-k10 \
        [--pairs 10] [--seconds 3] [--trace-batches 0] [--seed N]
                                                        (one CUDA card)

Builds the cell's system once, as `perfbench/run.py` does (inputs from the
seed, the port's `Retriever`, the mix's warm batches).  Then:

- `--pairs`: the cell's closed loop for `--seconds` a window, recording
  off and on (`Retriever.record_spans`) in turns, off first in even
  pairs, on first in odd ones: per side the median and quartiles
  (`statistics.quantiles`) of `queries_per_s` and of the mean batch in
  ms, the on-cost per pair (on less off, in us a batch), and from the
  windows recording on: `certified_host_ms`, `card_wait_ms` (as
  `perfbench/metrics/` reads them), their sum's share of the mean batch
  (`coverage`), and count, ms and self ms a batch per span;
- `--trace-batches N`: the pool's first N batches under torch.profiler,
  each in the benchmark's `bench.batch` span (`perfbench/harness/
  trace.py`), recording off and then on: device operations and the
  host's launches and copies a batch, the idle share, the share of idle
  time in gaps named by a program phase (`cert.*`, `entry.*`),
  `bench.batch > (python between ops)`, the idle seconds by phase and the
  largest gaps.

A checkout whose `Retriever` cannot record spans (an older one) gets the
off side of the trace alone.  Prints one JSON line, headed by the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("cert.", "entry.")
# the host's CUDA runtime calls that put work on the card
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def _quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return {"median": q2, "q1": q1, "q3": q3}


def _per_batch(before, after, batches):
    out = {}
    for name, t in after.items():
        b = before.get(name, {"count": 0, "s": 0.0, "self_s": 0.0})
        out[name] = {
            "count": (t["count"] - b["count"]) / batches,
            "ms": 1e3 * (t["s"] - b["s"]) / batches,
            "self_ms": 1e3 * (t["self_s"] - b["self_s"]) / batches,
        }
    return out


def _off(system) -> None:
    system.spans = None
    if getattr(system, "certified", None) is not None:
        system.certified.spans = None


def pairs(su, traffic, n: int, seconds: float, seed: int) -> dict:
    """`n` pairs of windows, recording off and on."""
    system = su.system

    def window():
        w = su.traffic.run_window(su.call, su.pool, traffic, seconds, 0, seed)
        if w.failed:
            raise RuntimeError(f"{w.failed} queries failed")
        return w

    runs = {"off": [], "on": []}
    per_pair_us = []
    phases = []          # (spans per batch, mean batch s) of each on window
    for j in range(n):
        batch_s = {}
        for side in (("off", "on") if j % 2 == 0 else ("on", "off")):
            if side == "on":
                before = system.record_spans().totals()
            w = window()
            if side == "on":
                after = system.spans.totals()
                _off(system)
                phases.append((_per_batch(before, after, w.batches),
                               w.seconds / w.batches))
            runs[side].append((w.queries / w.seconds, w.seconds / w.batches))
            batch_s[side] = w.seconds / w.batches
        per_pair_us.append(1e6 * (batch_s["on"] - batch_s["off"]))

    spans = {}
    for name in sorted({n for ph, _ in phases for n in ph}):
        rows = [ph[name] for ph, _ in phases if name in ph]
        spans[name] = {k: statistics.median(r[k] for r in rows)
                       for k in ("count", "ms", "self_ms")}
    host, wait, cover = [], [], []
    for ph, batch in phases:
        def ms(n):
            return ph.get(n, {}).get("ms", 0.0)
        host.append(ms("cert.start") + ms("cert.finish") - ms("cert.sync"))
        wait.append(ms("cert.sync") + ms("entry.to_host"))
        cover.append((host[-1] + wait[-1]) / (1e3 * batch))
    return {
        "pairs": n,
        "seconds": seconds,
        "queries_per_s": {s: _quartiles([r[0] for r in runs[s]])
                          for s in runs},
        "batch_ms": {s: _quartiles([1e3 * r[1] for r in runs[s]])
                     for s in runs},
        "on_cost_us_per_batch": _quartiles(per_pair_us),
        "on_slower_pairs": sum(d > 0 for d in per_pair_us),
        "certified_host_ms": _quartiles(host),
        "card_wait_ms": _quartiles(wait),
        "coverage": _quartiles(cover),
        "spans_per_batch": spans,
    }


def traced(su, device, batches: int) -> dict:
    """The pool's first `batches` batches under torch.profiler, recording
    off, then on where the system can record spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.harness import trace

    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    out = {}
    sides = ["off"] + (["on"] if hasattr(su.system, "record_spans") else [])
    for side in sides:
        if side == "on":
            su.system.record_spans()
        with profile(activities=activities) as prof:
            if cuda:
                trace._warm_up(device)
            with record_function(trace.WINDOW_SPAN):
                for j in range(batches):
                    with record_function(trace.BATCH_SPAN):
                        su.call(*su.pool[j % len(su.pool)])
                if cuda:
                    torch.cuda.synchronize(device)
        _off(su.system)
        events = trace.events_of(prof)
        t = trace.reduce(events, batches)
        w = next(e for e in events
                 if e.name == trace.WINDOW_SPAN and not e.device)
        ops = sum(e.device and w.start <= e.start < w.end for e in events)
        launches = sum(not e.device and e.name.startswith(LAUNCHES)
                       and w.start <= e.start < w.end for e in events)
        idle = sum(t.idle_gaps.values())
        by_phase = collections.defaultdict(float)
        for name, s in t.idle_gaps.items():
            parts = name.split(" > ")
            key = (parts[1] if len(parts) > 1 and parts[1].startswith(PHASES)
                   else name)
            by_phase[key] += s
        named = sum(s for k, s in by_phase.items() if k.startswith(PHASES))
        out[side] = {
            "batches": batches,
            "device_ops_per_batch": ops / batches,
            "host_launches_per_batch": launches / batches,
            "window_s": t.window_s,
            "busy_s": t.busy_s,
            "idle_s": idle,
            "phase_named_idle_share": named / idle if idle else None,
            "python_between_ops_s": t.idle_gaps.get(
                f"{trace.BATCH_SPAN} > (python between ops)", 0.0),
            "idle_by_phase": trace.top(dict(by_phase), 16),
            "idle_gaps": trace.top(t.idle_gaps, 16),
        }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--trace-batches", type=int, default=0)
    p.add_argument("--seed", type=int, default=2_000_000_021)
    args = p.parse_args(argv)

    import torch

    from perfbench.harness import bench, spec

    if not torch.cuda.is_available():
        print("needs a CUDA card; torch sees none", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    su = bench.set_up(cell, args.seed, device)
    out = {"card": _card(), "torch": torch.__version__,
           "workload": args.workload, "seed": args.seed}
    if args.pairs and hasattr(su.system, "record_spans"):
        out.update(pairs(su, cell.traffic, args.pairs, args.seconds,
                         args.seed))
    if args.trace_batches:
        out["trace"] = traced(su, device, args.trace_batches)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
