"""The TPU prototypes of the JAX repo's `experiments/` (TPU kernels 5-12)
and the paths that run them:

    kernel_r3             `mxu_only`, `scan_d1` (and its catalog split),
                          `main`: where a bin scan's time goes at 10M x 1024
    kernel_ablation_r2e   `rerank`, `run_scan3`, `main`: rerank cost against
                          the candidate count, and the depth-3 W = 256 scan
    certified_proto       `scan_call`, `certified`, `main`: the prototype
                          certified pipeline and its oracle check
    kernel_ablation_r2    `run_variant`, `main`: kernel 3's stages alone
                          (dot, exact epilogue, max, vertical top-2, whole)
    kernel_ablation_r2b   `run_variant`, `main`: its epilogue variants and
                          the bf16 dot
    kernel_ablation_r2c   `run_case`, `main`: tile sizes, the bf16x2 dot,
                          a staged epilogue
    kernel_ablation_r2d   `run_case`, `main`: the feature axis padded to
                          16 / 32 rows

Each function keeps the JAX prototype's positional arrays and layouts, so
the tests feed both packages the same arrays.  The bin scans (kernels
9-12) drop the TPU tile shapes `tq` and `tc`: their CUDA kernels take W
only.  The ablation bodies (kernels 5-8) keep `tc`, because they return
the result of the LAST catalog tile of `tc` columns, as the TPU bodies do;
their `tq` is a label.  There are no weights to convert: the inputs are
the layouts themselves, made from a seed.  Each `main` runs on the card
unless asked for the CPU:

    python -m spotify_recommender_tpu_torch.experiments.<module> --device cuda|cpu
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.timing import sync_ms


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def time_cases(cases: Callable, n: int, b: int, device,
               reps: int) -> Dict[str, float]:
    """Median ms of each (name, call) that `cases(n, b, device)` yields,
    one printed line each (the ablation mains)."""
    dev = resolve_device(device)
    out: Dict[str, float] = {}
    for name, call in cases(n, b, dev):
        t = sync_ms(call, reps, dev)
        out[name] = t
        print(f"{name:22s} {t:9.3f} ms  ({b / t * 1e3:,.0f} q/s)", flush=True)
    return out


def cli(main: Callable, doc: str, n: int, b: int) -> None:
    """`python -m ... [N] [B] [--device cuda|cpu]` for a main."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=n)
    ap.add_argument("b", nargs="?", type=int, default=b)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.b, args.device)
