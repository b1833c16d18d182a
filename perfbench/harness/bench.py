"""One run of one cell: set-up, the cell's traffic for --seconds, with
--trace 1 a traced stretch after it, the check of the window's answers
against the reference, and the result's line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in `setup_s`, from the start of the process): the inputs
from the seed on the device (the catalog through its maker in inputs/, a
pool of query batches through the mix's generator in traffic/), the
system under test built over them (systems/), and the mix's
`warm_batches` of the pool answered, which builds the kernels on a
checkout's first run and warms the one shape the window uses.  The
window then runs the mix's generator (traffic/<generator>.py), which
times each batch on the host from the call to the answer in host arrays.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed` (queries), `metrics`, `device`, with --trace 1
`breakdown`, and last `check`: each number compared with its limit, which
also end standard error."""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import check, spec, trace
from perfbench.harness.window import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "spotify_recommender_tpu")


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    batch: int
    k: int
    rows: int
    features: int
    window: Window
    trace: Optional[trace.Trace]
    snapshots: Dict[str, tuple]


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class SetUp:
    features: torch.Tensor      # (N, F) float32 catalog on the device
    traffic: object             # the mix's generator (traffic/<generator>.py)
    pool: list                  # the mix's distinct batches
    system: object              # the system under test
    call: Callable              # one batch: (queries, exclusions) -> answer


def set_up(cell: spec.Cell, seed: int, device: torch.device,
           call_wrapper: Optional[Callable] = None) -> SetUp:
    """Inputs from the seed, the system over them, and the mix's
    `warm_batches` answered.  `call_wrapper` (tests only) wraps the batch
    call."""
    conf, traffic = cell.config, cell.traffic
    system_mod = spec.module("systems", conf["system"])
    generator = spec.module("traffic", traffic["generator"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    features = spec.module("inputs", conf["inputs"]).make(conf, gen, device)
    pool = generator.make_pool(features, traffic, gen)
    system = system_mod.build(conf, features.cpu().numpy(), device)
    k = traffic["k"]

    def call(q, ex):
        return system_mod.call(system, q, ex, k)

    if call_wrapper is not None:
        call = call_wrapper(call)
    for q, ex in pool[:traffic["warm_batches"]]:      # every batch has the
        call(q, ex)                                   # window's one shape
    _sync(device)
    return SetUp(features, generator, pool, system, call)


def run(args: argparse.Namespace, t0: float, device: torch.device,
        root=None, call_wrapper: Optional[Callable] = None) -> dict:
    """One run on `device`; returns the result's object."""
    cell = spec.load_cell(args.workload, root)
    conf, traffic = cell.config, cell.traffic
    k, b = traffic["k"], traffic["batch"]
    su = set_up(cell, args.seed, device, call_wrapper)
    features, system, call, pool = su.features, su.system, su.call, su.pool
    setup_s = time.perf_counter() - t0

    readers = {m["name"]: spec.module("metrics", m["name"])
               for m in cell.per_layer} if args.trace else {}
    before = {n: r.snapshot(system) for n, r in readers.items()
              if hasattr(r, "snapshot")}
    window = su.traffic.run_window(call, pool, traffic, args.seconds,
                                   traffic["check_batches"], args.seed)
    after = {n: r.snapshot(system) for n, r in readers.items()
             if hasattr(r, "snapshot")}
    traced = None
    if args.trace:
        def spanned(q, ex):
            with torch.profiler.record_function(trace.BATCH_SPAN):
                return call(q, ex)

        traced = trace.traced_window(
            lambda: su.traffic.run_window(spanned, pool, traffic,
                                          traffic["trace_seconds"], 0,
                                          args.seed).batches, device)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise ImportError("loaded in the run: " + ", ".join(found))

    del system, call, su
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(features, window.sample, k)
    correct = check.verdict(numbers, cell.limits) and window.failed == 0

    if args.trace:
        ctx = Context(b, k, conf["rows"], conf["features"], window, traced,
                      {n: (before[n], after[n]) for n in before})
        values = {m["name"]: readers[m["name"]].read(ctx)
                  for m in cell.per_layer}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if values[m["name"]] is not None}
    else:
        times_ms = np.asarray(window.times) * 1e3
        e2e = {
            "queries_per_s": window.queries / window.seconds,
            "batch_p95_ms": float(np.percentile(times_ms, 95)),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": window.queries,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {
            "device_ops": trace.top(traced.kernel_seconds),
            "idle_gaps": trace.top(traced.idle_gaps),
        }
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    checks["answers_compared"] = {"value": numbers["answers_compared"],
                                  "limit": "> 0"}
    checks["failed_queries"] = {"value": window.failed, "limit": 0}
    result["check"] = checks
    return result


def emit(result: dict) -> None:
    """The check's lines last on standard error, the result's line last on
    standard output."""
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = run(args, t0, torch.device("cuda", 0))
    except ImportError as err:
        print(f"no result: {err}", file=sys.stderr)
        return 4
    emit(result)
    return 0
