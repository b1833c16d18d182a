"""The feature axis padded to 16 (fp32) and 32 (bf16x2) rows, and a
tiling sweep of the bf16x2 front end: the port of the JAX repo's
`experiments/kernel_ablation_r2d.py` (TPU kernel 8).

Cases (the bodies in ops/cuda/ablation.py over the LAST catalog tile of
the case's `tc` columns; (B, 128) f32 out), with kernel_ablation_r2c's
data and layouts, F stored 16 (rows 12-15 zero) or 32 (rows 24-31 zero):

    dot_*     the tile's first 128 raw dots
    fg2_*     guard, clip; the per-lane vertical top-2, then the max
              (column 0 adds max(g1 + g2) * 0, as the TPU body)

tq in a name is a label: `fg2_bf16x2p32_512x8k` and `_1024x8k` run the
same card instance on the same inputs.  The padded rows are summed like
the others (their products are 0), as the TPU contraction does.

    python -m spotify_recommender_tpu_torch.experiments.kernel_ablation_r2d \\
        [N] [B] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Dict

from spotify_recommender_tpu_torch.experiments import cli, time_cases
from spotify_recommender_tpu_torch.experiments.kernel_ablation_r2c import (
    B,
    BF16,
    F32,
    N,
    case_calls,
    run_case as _run_case,
)
from spotify_recommender_tpu_torch.ops.cuda import ablation

_DOT, _FG2 = ablation.BODIES["r2d"]["dotonly"], ablation.BODIES["r2d"]["fg2"]
# name -> (body, storage, tq, tc, F stored)
CASES = {
    "dot_f32p16_256x32k": (_DOT, F32, 256, 32768, 16),
    "dot_f32p16_512x8k": (_DOT, F32, 512, 8192, 16),
    "dot_bf16x2p32_256x32k": (_DOT, BF16, 256, 32768, 32),
    "dot_bf16x2p32_512x8k": (_DOT, BF16, 512, 8192, 32),
    "dot_bf16x2p32_512x16k": (_DOT, BF16, 512, 16384, 32),
    "fg2_bf16x2p32_512x8k": (_FG2, BF16, 512, 8192, 32),
    "fg2_bf16x2p32_256x32k": (_FG2, BF16, 256, 32768, 32),
    "fg2_bf16x2p32_512x16k": (_FG2, BF16, 512, 16384, 32),
    "fg2_bf16x2p32_1024x8k": (_FG2, BF16, 1024, 8192, 32),
    "fg2_f32p16_256x32k": (_FG2, F32, 256, 32768, 16),
}


def run_case(queries_p, q_norms_p, features_t, norms_p, *, name: str,
             digest: bool = False, plain: bool = False):
    """As kernel_ablation_r2c.run_case, over this file's cases
    (`kernel_ablation_r2d.py:69`)."""
    return _run_case(queries_p, q_norms_p, features_t, norms_p, name=name,
                     cases=CASES, digest=digest, plain=plain)


def cases(n: int = N, b: int = B, device="cuda"):
    return case_calls(CASES, n, b, device)


def main(n: int = N, b: int = B, device="cuda",
         reps: int = 20) -> Dict[str, float]:
    return time_cases(cases, n, b, device, reps)


if __name__ == "__main__":
    cli(main, __doc__, N, B)
