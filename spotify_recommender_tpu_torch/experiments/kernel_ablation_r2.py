"""Kernel 3's stages in isolation: dot, exact epilogue, wide or vertical
max, vertical top-2, and the whole kernel; the port of the JAX repo's
`experiments/kernel_ablation_r2.py` (TPU kernel 5).

Variants (the bodies in ops/cuda/ablation.py, over the LAST catalog tile
of `tc` columns, as the TPU bodies return; k = 16 output columns):

    dotonly    the tile's first k raw dots
    widemax    guard, safe divide, clip, masks (`_score_tile`), the max
    vertmax    the same max: on the card a max is a per-lane running max
               then a cross-lane max, so widemax and vertmax are one
               kernel instance
    verttop2   the per-lane vertical top-2 over the tile's tc / 128 groups;
               out_s the max, out_i max over lanes of g1 + g2
    full_r1    kernel 3 (ops/cuda/fused.fused_topk, exact, eps 1e-8): the
               whole catalog's top-k, sorted

`main` (1M x 12 uniform rows from seed 0, zero-padded to a multiple of
tc = 8192, B = 1024 catalog-row queries, no exclusion, k = 16) prints ms
and q/s per variant (CUDA events on the card).

    python -m spotify_recommender_tpu_torch.experiments.kernel_ablation_r2 \\
        [N] [B] [--device cuda|cpu]
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from spotify_recommender_tpu_torch.experiments import cli, round_up, time_cases
from spotify_recommender_tpu_torch.ops.cuda import ablation
from spotify_recommender_tpu_torch.ops.cuda.fused import (
    fused_topk,
    fused_topk_plain,
)

B, N, F, K, TC = 1024, 1_000_000, 12, 16, 8192


def full_r1(queries_p, q_norms_p, features_t, norms_p, excl_p, valid, *,
            k: int, plain: bool = False):
    """`k_full_r1` (`kernel_ablation_r2.py:136`): the production body,
    kernel 3 with the exact epilogue -> (B, k) f32, (B, k) int32."""
    fn = fused_topk_plain if plain else fused_topk
    s, i = fn(queries_p, q_norms_p.reshape(-1), features_t,
              norms_p.reshape(-1), excl_p.reshape(-1).long(),
              ablation.as_int(valid), k=k, exact=True, eps=ablation.EPS)
    return s, i.int()


KERNELS = {**ablation.BODIES["r2"], "full_r1": full_r1}


def run_variant(queries_p, q_norms_p, features_t, norms_p, excl_p, valid, *,
                name: str, k: int, tc: int, digest: bool = False,
                plain: bool = False):
    """(Bp, F) f32 queries, (Bp, 1) raw norms, (F, Np) f32 catalog, (1, Np)
    raw norms, (Bp, 1) int32 exclusions, valid -> (Bp, k) f32 and (Bp, k)
    int32 (`kernel_ablation_r2.py:155`); with `digest`, the per-tile digest
    too (not for full_r1, whose output covers every tile).  `plain` runs
    the plain version on any device."""
    args = (queries_p, q_norms_p, features_t, norms_p, excl_p, valid)
    if name == "full_r1":
        if digest:
            raise ValueError("full_r1 has no per-tile digest")
        return full_r1(*args, k=k, plain=plain)
    body = KERNELS[name]
    fn = body.plain if plain else body
    return fn(*args, tc=tc, width=k, index=True, digest=digest)


def inputs(n: int, b: int, device, tc: int = TC):
    """The JAX main's arrays on `device`: n x F uniform [0, 1) rows from
    seed 0, transposed and zero-padded to a multiple of tc, raw norms (0 on
    the pad), b catalog-row queries and their norms, no exclusion, and
    valid = n."""
    rng = np.random.default_rng(0)
    feats = rng.random((n, F), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    np_ = round_up(n, tc)
    ft = np.zeros((F, np_), np.float32)
    ft[:, :n] = feats.T
    nrm = np.zeros((1, np_), np.float32)
    nrm[0, :n] = norms
    q = feats[rng.integers(0, n, b)]
    qn = np.linalg.norm(q, axis=1, keepdims=True).astype(np.float32)
    excl = np.full((b, 1), -1, np.int32)
    dev = [torch.from_numpy(a).to(device) for a in (q, qn, ft, nrm, excl)]
    return (*dev, n)


def cases(n: int = N, b: int = B, device="cuda", k: int = K, tc: int = TC):
    """(name, call) for each variant on the main's inputs; call(digest=,
    plain=) runs it."""
    args = inputs(n, b, device, tc)
    for name in KERNELS:
        yield name, functools.partial(run_variant, *args, name=name, k=k,
                                      tc=tc)


def main(n: int = N, b: int = B, device="cuda",
         reps: int = 20) -> Dict[str, float]:
    return time_cases(cases, n, b, device, reps)


if __name__ == "__main__":
    cli(main, __doc__, N, B)
