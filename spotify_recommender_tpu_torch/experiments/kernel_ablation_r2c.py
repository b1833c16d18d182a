"""Tile sizes, the bf16x2 split-catalog dot and a staged epilogue: the port
of the JAX repo's `experiments/kernel_ablation_r2c.py` (TPU kernel 7).

Cases (the bodies in ops/cuda/ablation.py over the LAST catalog tile of
the case's `tc` columns, as the TPU bodies return; (B, 128) f32 out):

    dot_*            the tile's first 128 raw dots
    fg_*             guard, clip; the max, broadcast
    fg2_*            guard, clip; the per-lane vertical top-2, then the max
                     (column 0 adds max(g1 + g2) * 0, as the TPU body)
    staged_f32_*     guard, divide, clip; the max

A name's `<tq>x<tc>` keeps the TPU tile shapes: tc decides which columns
the output describes; tq is a label (the card's query tile is its own), so
`dot_f32_par`, which differed in the TPU's grid semantics only, is
`dot_f32_512x8k` on the card.  The bf16x2 cases contract [qh, ql] with
[hi; lo] (F stored 24): qh*hi + ql*lo, without the cross terms ql*hi +
qh*lo, as the TPU cases do (ROADMAP section 3).

`main` (1M x 12 uniform rows from seed 0, B = 1024 catalog-row queries;
f32 cases the raw rows, bf16x2 cases the split unit rows; each catalog
zero-padded to a multiple of its tc) prints ms and q/s per case.

    python -m spotify_recommender_tpu_torch.experiments.kernel_ablation_r2c \\
        [N] [B] [--device cuda|cpu]
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from spotify_recommender_tpu_torch.experiments import cli, round_up, time_cases
from spotify_recommender_tpu_torch.ops.cuda import ablation
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2_plain

B, N, F = 1024, 1_000_000, 12
F32, BF16 = torch.float32, torch.bfloat16
_BODY = ablation.BODIES["r2c"]
_DOT, _FG, _FG2 = _BODY["dotonly"], _BODY["fastguard"], _BODY["fastguard_top2"]
# name -> (body, storage, tq, tc, F stored, parallel_q, staged)
CASES = {
    "dot_f32_512x8k": (_DOT, F32, 512, 8192, 12, False, False),
    "dot_f32_256x32k": (_DOT, F32, 256, 32768, 12, False, False),
    "dot_f32_128x64k": (_DOT, F32, 128, 65536, 12, False, False),
    "dot_f32_par": (_DOT, F32, 512, 8192, 12, True, False),
    "dot_bf16x2_512x8k": (_DOT, BF16, 512, 8192, 24, False, False),
    "dot_bf16x2_256x32k": (_DOT, BF16, 256, 32768, 24, False, False),
    "fg_bf16x2_256x32k": (_FG, BF16, 256, 32768, 24, False, False),
    "fg_bf16x2_512x8k": (_FG, BF16, 512, 8192, 24, False, False),
    "fg2_bf16x2_256x32k": (_FG2, BF16, 256, 32768, 24, False, False),
    "fg2_bf16x2_512x8k": (_FG2, BF16, 512, 8192, 24, False, False),
    "staged_f32_512x8k": (_BODY["staged_f32"], F32, 512, 8192, 12, False,
                          True),
    "fg_f32_256x32k": (_FG, F32, 256, 32768, 12, False, False),
}


def run_case(queries_p, q_norms_p, features_t, norms_p, *, name: str,
             cases=CASES, digest: bool = False, plain: bool = False):
    """(Bp, Fs) queries and (Fs, Np) catalog of the case's storage, (Bp, 1)
    and (1, Np) raw f32 norms -> ((Bp, 128) f32,)
    (`kernel_ablation_r2c.py:118`); with `digest`, the per-tile digest
    too.  `plain` runs the plain version."""
    body, tc = cases[name][0], cases[name][3]
    fn = body.plain if plain else body
    return fn(queries_p, q_norms_p, features_t, norms_p, tc=tc,
              width=ablation.LANES, index=False, digest=digest)


def main_data(n: int, b: int, device):
    """The JAX main's arrays on `device`: n x 12 uniform [0, 1) rows from
    seed 0, their norms and unit rows, b catalog-row queries, their (b, 1)
    norms and unit rows."""
    rng = np.random.default_rng(0)
    feats = rng.random((n, F), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    unit = feats / norms[:, None]
    q = feats[rng.integers(0, n, b)]
    qn = np.linalg.norm(q, axis=1, keepdims=True).astype(np.float32)
    qunit = (q / qn).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (feats, norms, unit, q, qn, qunit)]


def case_arrays(data, dtype: torch.dtype, tc: int, fs: int):
    """One case's (Bp, fs) queries, (Bp, 1) norms, (fs, Np) catalog and
    (1, Np) norms, Np the rows rounded up to tc: f32 the raw rows; bf16
    [qh, ql] against [hi; lo] of the unit rows; zero rows and columns
    beyond the data."""
    feats, norms, unit, q, qn, qunit = data
    n, b, dev = feats.shape[0], q.shape[0], feats.device
    np_ = round_up(n, tc)
    nrm = torch.zeros((1, np_), device=dev)
    nrm[0, :n] = norms
    ft = torch.zeros((fs, np_), dtype=dtype, device=dev)
    qp = torch.zeros((b, fs), dtype=dtype, device=dev)
    if dtype == BF16:
        for r0, (rows, qpart) in enumerate(zip(split_bf16x2_plain(unit),
                                               split_bf16x2_plain(qunit))):
            ft[r0 * F:(r0 + 1) * F, :n] = rows.t()
            qp[:, r0 * F:(r0 + 1) * F] = qpart
    else:
        ft[:F, :n] = feats.t()
        qp[:, :F] = q
    return qp, qn, ft, nrm


def case_calls(cases: dict, n: int, b: int, device):
    """(name, call) for each case on the main's inputs; call(digest=,
    plain=) runs it."""
    data = main_data(n, b, device)
    built = {}
    for name, (_, dtype, _, tc, fs, *_) in cases.items():
        if (dtype, tc, fs) not in built:
            built[dtype, tc, fs] = case_arrays(data, dtype, tc, fs)
        yield name, functools.partial(run_case, *built[dtype, tc, fs],
                                      name=name, cases=cases)


def cases(n: int = N, b: int = B, device="cuda"):
    return case_calls(CASES, n, b, device)


def main(n: int = N, b: int = B, device="cuda",
         reps: int = 20) -> Dict[str, float]:
    return time_cases(cases, n, b, device, reps)


if __name__ == "__main__":
    cli(main, __doc__, N, B)
