"""The bin-scan prototypes of the JAX repo's `experiments/` (TPU kernels
9-12) and the three paths that run them:

    kernel_r3             `mxu_only`, `scan_d1` (and its catalog split),
                          `main`: where a bin scan's time goes at 10M x 1024
    kernel_ablation_r2e   `rerank`, `run_scan3`, `main`: rerank cost against
                          the candidate count, and the depth-3 W = 256 scan
    certified_proto       `scan_call`, `certified`, `main`: the prototype
                          certified pipeline and its oracle check

Each function keeps the JAX prototype's positional arrays and layouts, so
the tests feed both packages the same arrays, and drops the TPU tile
shapes `tq` and `tc`: the CUDA kernels take W only.  There are no weights
to convert: the inputs are the layouts themselves, made from a seed.  Each
`main` runs on the card unless asked for the CPU:

    python -m spotify_recommender_tpu_torch.experiments.<module> --device cuda|cpu
"""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
