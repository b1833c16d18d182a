"""Time the ablation kernel (TPU kernels 5-8, `csrc/ablation_r2.cu`) of
this checkout against another checkout's, such as a `git archive` of the
parent commit, in turns on the card.

Each round starts one process per checkout, in the order parent, change,
then change, parent in the next round, and so on.  The process imports
that checkout's package (which builds its libraries into the checkout's
own `_build/`), runs every case of the four round-2 ablation paths
(`experiments.kernel_ablation_r2{,b,c,d}.cases`, at the mains' 1024 x 1M
by default) through its entry, and times it with CUDA events
(`core/timing.sync_ms`), as `chip_smoke.py` phase 13 does.  In its first
round each checkout's outputs and per-tile digests are also held to its
own plain version (NaN-aware).  Prints one JSON line per (case,
checkout), its median over the rounds beside each round's time, and the
card's name and power limit; --out writes them as one JSON file (the
runner, tools/sweep_runner.py, is fused_k_sweep.py's too).

    python3 tools/ablation_sweep.py --parent DIR [--rounds 2] [--reps 10]
        [--n 1000000] [--b 1024] [--cases r2c.fastguard,...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import sweep_runner

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("r2", "r2b", "r2c", "r2d")


def worker(root: Path, n: int, b: int, reps: int, wanted: set,
           check: bool) -> None:
    """Time (and with `check`, hold to plain) every case of the checkout
    at `root`; one JSON line per case."""
    sweep_runner.import_checkout(root, "ablation_sweep")
    import importlib

    import torch

    from spotify_recommender_tpu_torch.core.timing import sync_ms
    from spotify_recommender_tpu_torch.ops import similarity
    from spotify_recommender_tpu_torch.ops.cuda import ablation

    similarity.disable_tf32()
    dev = torch.device("cuda:0")
    for key in PATHS:
        mod = importlib.import_module(
            f"spotify_recommender_tpu_torch.experiments.kernel_ablation_{key}")
        for name, call in mod.cases(n=n, b=b, device=dev):
            case = f"{key}.{name}"
            if wanted and case not in wanted:
                continue
            row = dict(case=case)
            if check and name != "full_r1":
                out = call(digest=True)
                plain = call(digest=True, plain=True)
                torch.cuda.synchronize()
                row["bitwise_plain"] = all(
                    ablation.nan_equal(o, p) for o, p in
                    zip([*out[:-1], *out[-1]], [*plain[:-1], *plain[-1]]))
            row["ms"] = sync_ms(call, reps, dev)
            print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default="", help="path.case,... (all: empty)")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    wanted = set(filter(None, a.cases.split(",")))
    if a.worker:
        worker(a.worker, a.n, a.b, a.reps, wanted, a.check)
        return
    if a.parent is None:
        ap.error("--parent is required")
    sweep_runner.run(__file__, {"parent": a.parent.resolve(), "change": ROOT},
                     ["--n", str(a.n), "--b", str(a.b), "--reps", str(a.reps),
                      "--cases", a.cases], a.rounds, a.out)


if __name__ == "__main__":
    main()
