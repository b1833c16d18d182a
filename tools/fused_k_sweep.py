"""Time kernel 3 (`ops/cuda/fused.fused_topk`, `csrc/fused_topk.cu`) across
k, B, storage instances and both of its paths (the warp lists up to the
checkout's SMALL_K_MAX, the large-k buffers at any k), in this checkout
and in others, such as a `git archive` of the parent commit, in turns on
the card.

Each round starts one process per checkout, in one order, then in the
reverse order in the next round, and so on (tools/sweep_runner.py, the
runner ablation_sweep.py uses too).  The process imports that checkout's
package (which builds its library into the checkout's own `_build/`),
makes phase 7's inputs of `chip_smoke.py` (1M x 12 uniform rows, seed 0,
B catalog-row queries with self-exclusion), and times each case with
CUDA events (`core/timing.sync_ms`).  A case is (instance, path, k, B):
the path is "route" (`fused_topk` as a caller gets it), "lists" (the
warp lists, k <= SMALL_K_MAX only) or "large" (`fused_topk_large`).  In
its first round each checkout's answers are also held to its own plain
version (bitwise).  Prints one JSON line per (case, checkout): its
median over the rounds beside each round's time and the path and plan
that ran; then the card's name and power limit; --out writes them as one
JSON file.  To try other constants of `ops/cuda/fused.py` or another
`tile()`, edit them in a copy of the checkout and pass it with
--checkout.

    python3 tools/fused_k_sweep.py [--parent DIR] [--checkout NAME=DIR]
        [--ks 10,128,129,1000,4096] [--bs 1024,1] [--instance exact|...|all]
        [--paths route|lists|large|lists,large] [--floors] [--profile]
        [--rounds 2] [--reps 5] [--n 1000000] [--out FILE]

`--paths lists,large` gives both paths' times at each (k, B), for moving
the route (`fused_route`).  `--profile` adds each case's device time
a call (`device_ms`, all its kernels, from `torch.profiler`) and each
kernel's share (`device_kernels`, from the first round): what the call's
CUDA-event time `ms` spends on the card, and so what the host adds.
`--floors` adds to each case of a checkout whose
`chip_smoke.py` has `kernel3_issue_floor` its `bound_ms` / `bound_by`
(chip_smoke's `bound`: bytes once over 3.35 TB/s or products over the H100
SXM's fp32 / bf16 peak), its `issue_floor_ms` from the SASS of the
instance the case launches, and `library_ms`: `torch.topk(torch.mm(q,
ft), k)` on the same operands (fp32, or bf16 for bf16 storage; bf16x2's
planes repeated to Fq rows, in fp32).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import sweep_runner

ROOT = Path(__file__).resolve().parents[1]
INSTANCES = ("exact", "prenormalized", "bfloat16", "bfloat16x2")


def operands(instance: str, q, qn, f, norms):
    """(queries, features_t) of a storage instance for raw rows f and
    queries q: "exact" and "prenormalized" fp32, "bfloat16", "bfloat16x2"
    ([qh, ql, ql, qh] against [hi; lo])."""
    import torch

    from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2

    if instance == "exact":
        return q, f.t().contiguous()
    qq = q / qn.clamp_min(1e-30)[:, None]
    ft = (f / norms.clamp_min(1e-30)[:, None]).t().contiguous()
    if instance == "bfloat16":
        return qq.to(torch.bfloat16), ft.to(torch.bfloat16)
    if instance == "bfloat16x2":
        qh, ql = split_bf16x2(qq)
        return (torch.cat([qh, ql, ql, qh], dim=1),
                torch.cat(split_bf16x2(ft), dim=0))
    return qq, ft


def floors_of(smoke, sass, args, ft, k, exact, ran, out) -> dict:
    """A case's bound, issue floor and library time (see --floors)."""
    import torch

    from spotify_recommender_tpu_torch.core.timing import sync_ms

    q = args[0]
    bf16 = ft.dtype == torch.bfloat16
    row = smoke.bound(smoke.dot_flops(q, ft, q.shape[1]),
                      "bf16" if bf16 else "fp32", *args[:5], *out)
    floor = smoke.kernel3_issue_floor(sass, q, ft, k, exact, path=ran)
    row.update(issue_floor_ms=floor["issue_floor_ms"],
               instance=floor["instance"])
    if bf16 and q.shape[1] == ft.shape[0]:
        lq, lf = q, ft
    else:
        lq = q.float()
        lf = ft.float().repeat(q.shape[1] // ft.shape[0], 1)
    row["library_ms"] = sync_ms(lambda: torch.topk(torch.mm(lq, lf), k), 5,
                                q.device)
    return row


def device_times(call, calls: int = 3) -> dict:
    """`device_ms`, the device time of one `call` (every kernel it
    launches), and `device_kernels`, each kernel's ms a call, from
    `torch.profiler` over `calls` calls (see --profile)."""
    import re

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"\w+_kernel\b(<[^()]*>)?", e.key)
            name = m.group(0) if m else e.key[:60]
            per[name] = per.get(name, 0.0) + us / calls / 1e3
    return dict(device_ms=sum(per.values()), device_kernels=per)


def worker(root: Path, n: int, ks: list, bs: list, reps: int,
           instances: list, paths: list, check: bool,
           floors: bool = False, profile: bool = False) -> None:
    """Time (and with `check`, hold to plain) each (instance, path, k, B)
    in the checkout at `root`; one JSON line each."""
    sweep_runner.import_checkout(root, "fused_k_sweep")
    import inspect

    import numpy as np
    import torch

    from spotify_recommender_tpu_torch.core.timing import sync_ms
    from spotify_recommender_tpu_torch.ops import similarity
    from spotify_recommender_tpu_torch.ops.cuda import fused

    similarity.disable_tf32()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    feats = rng.random((n, 12), dtype=np.float32)
    rows = torch.from_numpy(rng.integers(0, n, max(bs))).to(dev)
    f = torch.from_numpy(feats).to(dev)
    norms = similarity.row_norms(f)
    q = f[rows].contiguous()
    qn = similarity.row_norms(q)
    route = getattr(fused, "fused_route", None)      # the parent has none
    smoke = sass = None
    if floors:
        import chip_smoke as smoke    # the checkout's own

        from spotify_recommender_tpu_torch.ops.cuda import _build
        if hasattr(smoke, "kernel3_issue_floor"):
            sass = smoke.sass_functions(_build.build(_build.SERVING),
                                        "partial_kernel")
    takes_fc = "fc" in inspect.signature(fused._splits).parameters

    def lists_only(*args, k, exact):
        # the warp lists whatever the route says (a checkout without a
        # route sends k <= 128 to them anyway)
        if not hasattr(fused, "_lists"):
            return fused.fused_topk(*args, k=k, exact=exact)
        return fused._lists(dev, *args, k, exact, fused.COSINE_EPS)

    for instance in instances:
        qq, ft = operands(instance, q, qn, f, norms)
        exact = instance == "exact"
        bf16 = ft.dtype == torch.bfloat16
        for b in bs:
            args = (qq[:b].contiguous(), qn[:b].contiguous(), ft, norms,
                    rows[:b].contiguous(), n)
            for path in paths:
                for k in ks:
                    if path == "lists" and k > fused.SMALL_K_MAX:
                        continue
                    topk = {"route": fused.fused_topk, "lists": lists_only,
                            "large": fused.fused_topk_large}[path]
                    ran = ("large" if path == "large"
                           or k > fused.SMALL_K_MAX
                           or (path == "route" and route is not None
                               and route(k, b) == "large") else "lists")
                    row = dict(case=f"{instance} {path} k={k} B={b}",
                               ran=ran)
                    extra = {"fc": ft.shape[0]} if takes_fc else {}
                    plan = (fused._large_plan if ran == "large"
                            else fused._splits)
                    row["plan"] = list(plan(b, n, dev, fq=qq.shape[1], k=k,
                                            exact=exact, bf16=bf16, **extra))
                    if check:
                        kv, ki = topk(*args, k=k, exact=exact)
                        pv, pi = fused.fused_topk_plain(*args, k=k,
                                                        exact=exact)
                        torch.cuda.synchronize()
                        row["bitwise_plain"] = bool(torch.equal(kv, pv)
                                                    and torch.equal(ki, pi))
                        del kv, ki, pv, pi
                    if sass is not None:
                        row.update(floors_of(smoke, sass, args, ft, k, exact,
                                             ran, topk(*args, k=k,
                                                       exact=exact)))
                    if profile:
                        row.update(device_times(
                            lambda: topk(*args, k=k, exact=exact)))
                    row["ms"] = sync_ms(lambda: topk(*args, k=k, exact=exact),
                                        reps, dev)
                    print(json.dumps(row), flush=True)
        del qq, ft
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--checkout", action="append", default=[],
                    help="name=DIR: another checkout")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--ks", default="10,100,128,129,256,1000,4096")
    ap.add_argument("--bs", default="1024,1")
    ap.add_argument("--instance", choices=(*INSTANCES, "all"),
                    default="exact")
    ap.add_argument("--paths", default="route",
                    help="comma-separated: route, lists, large")
    ap.add_argument("--floors", action="store_true",
                    help="each case's bound, issue floor and library time")
    ap.add_argument("--profile", action="store_true",
                    help="each case's device time (torch.profiler)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    ks = [int(k) for k in a.ks.split(",")]
    bs = [int(b) for b in a.bs.split(",")]
    instances = list(INSTANCES) if a.instance == "all" else [a.instance]
    paths = a.paths.split(",")
    if a.worker:
        worker(a.worker, a.n, ks, bs, a.reps, instances, paths, a.check,
               a.floors, a.profile)
        return
    builds = {"change": ROOT}
    if a.parent:
        builds = {"parent": a.parent.resolve(), **builds}
    for spec in a.checkout:
        name, _, path = spec.partition("=")
        builds[name] = Path(path).resolve()
    sweep_runner.run(__file__, builds,
                     ["--n", str(a.n), "--ks", a.ks, "--bs", a.bs,
                      "--instance", a.instance, "--paths", ",".join(paths),
                      "--reps", str(a.reps),
                      *(["--floors"] if a.floors else []),
                      *(["--profile"] if a.profile else [])],
                     a.rounds, a.out, instance=a.instance, paths=paths)


if __name__ == "__main__":
    main()
