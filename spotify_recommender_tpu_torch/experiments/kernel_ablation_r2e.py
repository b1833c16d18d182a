"""The exact rerank's cost against the candidate count, a top-k over
candidate lists, and the depth-3 W = 256 scan front end: the port of the
JAX repo's `experiments/kernel_ablation_r2e.py`.

`main` (1M x 12 uniform rows from seed 0, B = 1024 catalog-row queries):

    rerank C = 32, 64, 256, 768   gather, fp32 product, guard, top-10
    top-k 768 -> 64               over (B, 768) random values
    scan3                         TPU kernel 9 (ops/cuda/proto_scans.scan3)
                                  over the [hi; lo] planes, W = 256

The JAX main tries three TPU tile shapes for the scan; the card runs one
scan.  The scan contracts the (B, 24) query [qh, ql] with the (24, Np)
planes [hi; lo] as the prototype does, so its values miss the two cross
terms ql*hi + qh*lo (ROADMAP section 3).

    python -m spotify_recommender_tpu_torch.experiments.kernel_ablation_r2e \\
        [N] [B] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.timing import sync_ms
from spotify_recommender_tpu_torch.experiments import round_up
from spotify_recommender_tpu_torch.ops.cuda import proto_scans
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2_plain
from spotify_recommender_tpu_torch.ops.similarity import disable_tf32
from spotify_recommender_tpu_torch.ops.topk import topk_stable

B, N, F = 1024, 1_000_000, 12
CANDIDATES = (32, 64, 256, 768)
PAD = 8192    # catalog padding of the JAX main's first scan case (its tc)


def rerank(queries: torch.Tensor, cand_idx: torch.Tensor,
           features: torch.Tensor, norms: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine of each query against its (B, C) candidate rows, top-k
    with ties to the earlier candidate (`kernel_ablation_r2e.py:13`).  fp32
    products: the caller keeps TF32 off (similarity.disable_tf32)."""
    cand = features[cand_idx]
    cand_n = norms[cand_idx]
    qn = torch.linalg.vector_norm(queries, dim=1)
    dots = torch.einsum("bf,bcf->bc", queries, cand)
    denom = qn[:, None] * cand_n
    guard = denom > 1e-8
    scores = torch.where(
        guard, torch.clamp(dots / torch.where(guard, denom, 1.0), -1.0, 1.0),
        0.0)
    top_s, pos = topk_stable(scores, k)
    return top_s, torch.gather(cand_idx, 1, pos)


def run_scan3(queries_p: torch.Tensor, q_norms_p: torch.Tensor,
              features_t: torch.Tensor, norms_p: torch.Tensor):
    """(Bp, 24) bf16 [qh, ql], (Bp, 1) f32 raw norms, (24, Np) bf16
    [hi; lo], (1, Np) f32 raw norms -> seven (Bp, 256) arrays v1 i1 v2 i2
    v3 i3 v4 (`kernel_ablation_r2e.py:74`)."""
    return proto_scans.scan3(queries_p, q_norms_p, features_t, norms_p)


def main(n: int = N, b: int = B, device="cuda",
         reps: int = 20) -> Dict[str, float]:
    dev = resolve_device(device)
    disable_tf32()
    rng = np.random.default_rng(0)
    feats = rng.random((n, F), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    q = feats[rng.integers(0, n, b)]
    dfe = torch.from_numpy(feats).to(dev)
    dno = torch.from_numpy(norms).to(dev)
    dq32 = torch.from_numpy(q).to(dev)
    out: Dict[str, float] = {}

    for c in CANDIDATES:
        cand = torch.from_numpy(rng.integers(0, n, size=(b, c))).to(dev)
        t = sync_ms(lambda: rerank(dq32, cand, dfe, dno, 10), reps, dev)
        out[f"rerank_c{c}"] = t
        print(f"rerank C={c:4d}   {t:9.3f} ms", flush=True)

    vals = torch.from_numpy(rng.random((b, 768), dtype=np.float32)).to(dev)
    t = sync_ms(lambda: topk_stable(vals, 64), reps, dev)
    out["topk_768_64"] = t
    print(f"top-k 768->64    {t:9.3f} ms", flush=True)

    # the scan over the [hi; lo] planes of the unit rows, W = 256
    unit = dfe / dno.clamp_min(1e-30)[:, None]
    hi, lo = split_bf16x2_plain(unit)
    ft = torch.zeros((2 * F, round_up(n, PAD)), dtype=torch.bfloat16,
                     device=dev)
    ft[:F, :n] = hi.t()
    ft[F:, :n] = lo.t()
    nrm = torch.zeros((1, ft.shape[1]), device=dev)
    nrm[0, :n] = dno
    qn = torch.linalg.vector_norm(dq32, dim=1, keepdim=True)
    qh, ql = split_bf16x2_plain(dq32 / qn)
    qp = torch.cat([qh, ql], dim=1)
    t = sync_ms(lambda: run_scan3(qp, qn, ft, nrm), reps, dev)
    out["scan3"] = t
    print(f"scan3 W=256      {t:9.3f} ms  ({b} x {ft.shape[1]})", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=N)
    ap.add_argument("b", nargs="?", type=int, default=B)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.b, args.device)
