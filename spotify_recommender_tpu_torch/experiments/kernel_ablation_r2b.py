"""Kernel 3's exact epilogue, decomposed, and the bf16 dot: the port of
the JAX repo's `experiments/kernel_ablation_r2b.py` (TPU kernel 6).

Variants (the bodies in ops/cuda/ablation.py; each the max over the LAST
catalog tile of `tc` columns, broadcast to k = 16 columns, except the dot):

    dotonly_f32, _bf16   the tile's first k raw dots
    e_div                clip(dot / (qn*cn)); the zero-norm pad columns
                         give 0 / 0, so the max is NaN, as on the TPU
    e_recip              clip(dot * (qn*cn)) on the raw norms the main
                         passes (the JAX docstring says pre-inverted
                         norms; its main passes raw ones)
    e_guard              guard, safe divide, clip, masks (kernel 3's exact)
    e_fast_f32, _bf16    clip and masks
    e_fastguard_bf16     guard, clip, masks

`main` feeds kernel_ablation_r2's inputs (1M x 12 from seed 0, tc = 8192,
B = 1024, no exclusion), rounded to bf16 for the bf16 variants, and
prints ms and q/s per variant.

    python -m spotify_recommender_tpu_torch.experiments.kernel_ablation_r2b \\
        [N] [B] [--device cuda|cpu]
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from spotify_recommender_tpu_torch.experiments import (
    cli,
    kernel_ablation_r2,
    time_cases,
)
from spotify_recommender_tpu_torch.ops.cuda import ablation

B, N, K, TC = 1024, 1_000_000, 16, 8192
_BODY = ablation.BODIES["r2b"]
KERNELS = {   # name -> (body, storage)
    "dotonly_f32": (_BODY["dotonly"], torch.float32),
    "dotonly_bf16": (_BODY["dotonly"], torch.bfloat16),
    "e_div": (_BODY["e_div"], torch.float32),
    "e_recip": (_BODY["e_recip"], torch.float32),
    "e_guard": (_BODY["e_guard"], torch.float32),
    "e_fast_f32": (_BODY["e_fast"], torch.float32),
    "e_fast_bf16": (_BODY["e_fast"], torch.bfloat16),
    "e_fastguard_bf16": (_BODY["e_fast_guard"], torch.bfloat16),
}


def run_variant(queries_p, q_norms_p, features_t, norms_p, excl_p, valid, *,
                name: str, k: int, tc: int, digest: bool = False,
                plain: bool = False):
    """(Bp, F) queries and (F, Np) catalog of the variant's storage, (Bp, 1)
    and (1, Np) raw f32 norms, (Bp, 1) int32 exclusions, valid -> (Bp, k)
    f32 and (Bp, k) int32 zeros (`kernel_ablation_r2b.py:126`); with
    `digest`, the per-tile digest too.  `plain` runs the plain version."""
    body = KERNELS[name][0]
    fn = body.plain if plain else body
    return fn(queries_p, q_norms_p, features_t, norms_p, excl_p, valid,
              tc=tc, width=k, index=True, digest=digest)


def cases(n: int = N, b: int = B, device="cuda", k: int = K, tc: int = TC):
    """(name, call) for each variant on the main's inputs; call(digest=,
    plain=) runs it."""
    q, qn, ft, nrm, excl, valid = kernel_ablation_r2.inputs(n, b, device, tc)
    stored = {torch.float32: (q, ft),
              torch.bfloat16: (q.to(torch.bfloat16), ft.to(torch.bfloat16))}
    for name, (_, dtype) in KERNELS.items():
        qq, ff = stored[dtype]
        yield name, functools.partial(run_variant, qq, qn, ff, nrm, excl,
                                      valid, name=name, k=k, tc=tc)


def main(n: int = N, b: int = B, device="cuda",
         reps: int = 20) -> Dict[str, float]:
    return time_cases(cases, n, b, device, reps)


if __name__ == "__main__":
    cli(main, __doc__, N, B)
