"""Time kernels 1 and 4 (the bin scans: `ops/cuda/scan_v3.scan_v3`,
`ops/cuda/scan_v2.scan_v2`) at a set of shapes in this checkout and in
others, such as a `git archive` of the parent commit, in turns on the card.

Each round starts one process per checkout, in one order, then in the
reverse order in the next round, and so on (tools/sweep_runner.py, the
runner of tools/ablation_sweep.py and tools/fused_k_sweep.py).  The
process imports that checkout's package (which builds its library into the
checkout's own `_build/`), makes `chip_smoke.py` phase 6's inputs (1M x 12
uniform rows, seed 0, the certified layout at each case's W, catalog-row
queries through the query prologue), and times each case with CUDA events
(`core/timing.sync_ms`) over the 1,000,000 real columns (`ncols`).  In its
first round each checkout's answers are also held to its own plain version
(bitwise).  A case a checkout refuses (a W or depth past its kernels) is
left out for it.  Each case has three times: `ms`, CUDA events around one
call (the host's work before the launch included, as a caller sees it),
`device_ms`, the kernels' own time a call (`torch.profiler`), and
`host_us`, the host's microseconds a call with calls enqueued back to
back.  Prints one JSON line per (case, checkout), the medians over the
rounds beside each round's `ms` and the route taken; then the card's name
and power limit; --out writes them as one JSON file.

    python3 tools/scan_sweep.py [--parent DIR] [--checkout NAME=DIR]
        [--cases v3/w128/d2/c32/b1024,...] [--rounds 4] [--reps 10]
        [--out FILE]

A case is `v3` or `v2`, then `w<W>`, `d<depth>`, `c<topc>`, `b<B>`; the
default cases are phases 6 and 10's shapes of `chip_smoke.py` and the wide
route's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import sweep_runner

ROOT = Path(__file__).resolve().parents[1]
N = 1_000_000
CASES = (
    # phase 6 and phase 10's shapes (the flat instances)
    "v3/w128/d2/c32/b1024", "v3/w128/d3/c32/b32", "v3/w128/d2/c32/b1",
    "v3/w512/d2/c32/b1024", "v2/w512/d3/c32/b1024", "v2/w512/d3/c32/b1",
    # the wide route's shapes
    "v3/w2048/d2/c32/b1024", "v3/w128/d5/c32/b1024", "v3/w128/d6/c32/b32",
    "v3/w256/d8/c32/b1024", "v3/w128/d9/c32/b1024",
)


def parse(case: str):
    kind, *fields = case.split("/")
    w, depth, topc, b = (int(x[1:]) for x in fields)
    return kind, w, depth, topc, b


def device_ms(fn, reps: int) -> float:
    """The device time of one call of `fn` under `torch.profiler`, over
    `reps` calls: each kernel's mean time, summed over the kernels (a mean
    is not moved by an event the profiler loses)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            t = (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0))
            us += t / e.count
    return us / 1e3


def host_us(fn, calls: int) -> float:
    """Host microseconds a call of `fn`, `calls` calls enqueued back to
    back (a call's host work, not the device's)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def worker(root: Path, cases: list, reps: int, check: bool) -> None:
    """Time (and with `check`, hold to plain) each case in the checkout at
    `root`; one JSON line each."""
    sweep_runner.import_checkout(root, "scan_sweep")
    import numpy as np
    import torch

    from spotify_recommender_tpu_torch.core.config import RetrievalConfig
    from spotify_recommender_tpu_torch.core.timing import sync_ms
    from spotify_recommender_tpu_torch.ops import similarity
    from spotify_recommender_tpu_torch.ops.cuda import scan_v3 as s3
    from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import (
        scan_v2,
        scan_v2_plain,
    )
    from spotify_recommender_tpu_torch.ops.cuda.split import query_prologue
    from spotify_recommender_tpu_torch.ops.fused_topk import (
        build_certified_layout,
        layout_to_device,
    )

    similarity.disable_tf32()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    feats = rng.random((N, 12), dtype=np.float32)
    rows = rng.integers(0, N, 1024)
    q = torch.from_numpy(feats[rows]).to(dev)
    qn = similarity.row_norms(q)
    q2 = query_prologue(q, qn)
    excl = torch.from_numpy(rows).to(dev)
    layouts = {}
    for case in cases:
        kind, w, depth, topc, b = parse(case)
        key = (kind, w)
        if key not in layouts:
            cfg = (RetrievalConfig(scan="v2") if kind == "v2"
                   else RetrievalConfig(scan_bins=w))
            layouts[key] = layout_to_device(
                build_certified_layout(feats, None, cfg), dev)
        dl = layouts[key]
        qq = q2[:b].contiguous()
        if kind == "v2":
            args = (qq, qn[:b].contiguous(), dl.ft, dl.nrm_row,
                    excl[:b].contiguous(), N)
            call = lambda: scan_v2(*args, w=w, eps=1e-8, topc=topc)  # noqa
            plain = lambda: scan_v2_plain(*args, w=w, eps=1e-8,  # noqa
                                          topc=topc)
        else:
            call = lambda: s3.scan_v3(qq, dl.ft, w=w, depth=depth,  # noqa
                                      topc=topc, ncols=N)
            plain = lambda: s3.scan_v3_plain(qq, dl.ft, w=w,  # noqa
                                             depth=depth, topc=topc, ncols=N)
        row = dict(case=case)
        try:
            call()
        except (ValueError, RuntimeError) as e:   # past its kernels
            print(json.dumps(dict(row, refused=str(e)[:200])), flush=True)
            continue
        if hasattr(s3, "scan_route"):
            row["route"] = s3.scan_route(12, w, depth, topc)
        if check:
            out, ref = call(), plain()
            torch.cuda.synchronize()
            row["bitwise_plain"] = all(torch.equal(o, p)
                                       for o, p in zip(out, ref))
        row["ms"] = sync_ms(call, reps, dev)
        row["device_ms"] = device_ms(call, reps)
        row["host_us"] = host_us(call, 20 * reps if b <= 32 else reps)
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--checkout", action="append", default=[],
                    help="name=DIR: another checkout")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    cases = a.cases.split(",")
    if a.worker:
        worker(a.worker, cases, a.reps, a.check)
        return
    builds = {"change": ROOT}
    if a.parent:
        builds = {"parent": a.parent.resolve(), **builds}
    for spec in a.checkout:
        name, _, path = spec.partition("=")
        builds[name] = Path(path).resolve()
    sweep_runner.run(__file__, builds,
                     ["--cases", a.cases, "--reps", str(a.reps)],
                     a.rounds, a.out, n=N)


if __name__ == "__main__":
    main()
