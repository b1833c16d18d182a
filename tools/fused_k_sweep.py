"""Time kernel 3 (`ops/cuda/fused.fused_topk`, `csrc/fused_topk.cu`) across
k, both of its paths (the warp lists up to k = 128, the large-k buffers
above), in this checkout and in others, such as a `git archive` of the
parent commit, in turns on the card.

Each round starts one process per checkout, in one order, then in the
reverse order in the next round, and so on (tools/sweep_runner.py, the
runner ablation_sweep.py uses too).  The process imports that checkout's
package (which builds its library into the checkout's own `_build/`),
makes phase 7's inputs of `chip_smoke.py` (1M x 12 uniform rows, seed 0,
B catalog-row queries with self-exclusion), and times `fused_topk` with
CUDA events (`core/timing.sync_ms`) at each (k, B).  In its first round
each checkout's answers are also held to its own plain version
(bitwise).  Prints one JSON line per (case, checkout): its median over the
rounds beside each round's time and its plan (`_splits`'s, or
`_large_plan`'s above k = 128 and with --large); then the card's name and
power limit; --out writes them as one JSON file.  To try other constants
of `ops/cuda/fused.py`, edit them in a copy of the checkout and pass it
with --checkout.

    python3 tools/fused_k_sweep.py [--parent DIR] [--checkout NAME=DIR]
        [--ks 10,128,129,1000,4096] [--bs 1024,1] [--instance exact]
        [--large] [--rounds 2] [--reps 5] [--n 1000000] [--out FILE]

`--large` times the large-k path at every k (`fused_topk_large`), k <=
128 too, where `fused_topk` takes the warp lists: both paths' times at
one k, for moving the crossover.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import sweep_runner

ROOT = Path(__file__).resolve().parents[1]
INSTANCES = ("exact", "prenormalized", "bfloat16", "bfloat16x2")


def worker(root: Path, n: int, ks: list, bs: list, reps: int,
           instance: str, large: bool, check: bool) -> None:
    """Time (and with `check`, hold to plain) each (k, B) in the checkout
    at `root`, through `fused_topk` or, with `large`, the large-k path at
    any k (`fused_topk_large`); one JSON line each."""
    sweep_runner.import_checkout(root, "fused_k_sweep")
    import numpy as np
    import torch

    from spotify_recommender_tpu_torch.core.timing import sync_ms
    from spotify_recommender_tpu_torch.ops import similarity
    from spotify_recommender_tpu_torch.ops.cuda import fused
    from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2

    similarity.disable_tf32()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    feats = rng.random((n, 12), dtype=np.float32)
    rows = torch.from_numpy(rng.integers(0, n, max(bs))).to(dev)
    f = torch.from_numpy(feats).to(dev)
    norms = similarity.row_norms(f)
    q = f[rows].contiguous()
    qn = similarity.row_norms(q)
    if instance == "exact":
        qq, ft = q, f.t().contiguous()
    else:
        qq = q / qn.clamp_min(1e-30)[:, None]
        ft = (f / norms.clamp_min(1e-30)[:, None]).t().contiguous()
        if instance == "bfloat16":
            qq, ft = qq.to(torch.bfloat16), ft.to(torch.bfloat16)
        elif instance == "bfloat16x2":
            qh, ql = split_bf16x2(qq)
            qq = torch.cat([qh, ql, ql, qh], dim=1)
            ft = torch.cat(split_bf16x2(ft), dim=0)
    exact = instance == "exact"
    topk = fused.fused_topk_large if large else fused.fused_topk
    for b in bs:
        args = (qq[:b].contiguous(), qn[:b].contiguous(), ft, norms,
                rows[:b].contiguous(), n)
        for k in ks:
            row = dict(case=f"k={k} B={b}")
            try:
                topk(*args, k=k, exact=exact)
            except ValueError as e:        # a k this checkout does not take
                print(json.dumps(dict(row, refused=str(e))), flush=True)
                continue
            plan = (fused._large_plan if large or k > fused.SMALL_K_MAX
                    else fused._splits)
            row["plan"] = list(plan(b, n, dev, fq=qq.shape[1], k=k,
                                    exact=exact,
                                    bf16=ft.dtype == torch.bfloat16))
            if check:
                kv, ki = topk(*args, k=k, exact=exact)
                pv, pi = fused.fused_topk_plain(*args, k=k, exact=exact)
                torch.cuda.synchronize()
                row["bitwise_plain"] = bool(torch.equal(kv, pv)
                                            and torch.equal(ki, pi))
            row["ms"] = sync_ms(lambda: topk(*args, k=k, exact=exact),
                                reps, dev)
            print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--checkout", action="append", default=[],
                    help="name=DIR: another checkout")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--ks", default="10,100,128,129,256,1000,4096")
    ap.add_argument("--bs", default="1024,1")
    ap.add_argument("--instance", choices=INSTANCES, default="exact")
    ap.add_argument("--large", action="store_true",
                    help="the large-k path at every k (fused_topk_large)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    ks = [int(k) for k in a.ks.split(",")]
    bs = [int(b) for b in a.bs.split(",")]
    if a.worker:
        worker(a.worker, a.n, ks, bs, a.reps, a.instance, a.large, a.check)
        return
    builds = {"change": ROOT}
    if a.parent:
        builds = {"parent": a.parent.resolve(), **builds}
    for spec in a.checkout:
        name, _, path = spec.partition("=")
        builds[name] = Path(path).resolve()
    sweep_runner.run(__file__, builds,
                     ["--n", str(a.n), "--ks", a.ks, "--bs", a.bs,
                      "--instance", a.instance, "--reps", str(a.reps),
                      *(["--large"] if a.large else [])],
                     a.rounds, a.out, instance=a.instance)


if __name__ == "__main__":
    main()
