"""The prototype certified-exact pipeline: the port of the JAX repo's
`experiments/certified_proto.py`.

    scan (TPU kernel 12, ops/cuda/proto_scans.proto_scan: depth-3 bins of
    width W plus the 4th-value bound, guard, clip, masks)
    -> top-C of the 3W candidates -> sort by index -> exact fp32 rerank
    -> top-k -> certificate: max(C-th scan value, max bound) + CEPS < k-th
       exact score, or every valid column fit in the bins

`main` runs W = 512 and 256 at 1M x 12 (uniform rows from seed 0),
B = 1024 catalog-row queries, k = 10, C = 32: per-batch time, the time per
batch over 20 batches enqueued back to back, and how many certificates
hold; then the check against the oracle at 40,000 x 256 with
self-exclusions.  The JAX cases (tq, W) collapse to W: tq is a TPU tile.

A fault of the prototype, kept here: it contracts the (B, 24) query
[qh, ql] with the (24, Np) planes [hi; lo], which gives qh*hi + ql*lo and
drops the cross terms ql*hi + qh*lo.  Its scan values miss the cosine by
up to ~4e-3, far above CEPS = 2e-5, so the certificate does not prove what
it claims; `main` prints the queries whose answer differs from the oracle
while the certificate holds (ROADMAP section 3).

    python -m spotify_recommender_tpu_torch.experiments.certified_proto \\
        [W ...] [--n N] [--b B] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.timing import sync_ms
from spotify_recommender_tpu_torch.experiments import round_up
from spotify_recommender_tpu_torch.ops.cuda import proto_scans
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2_plain
from spotify_recommender_tpu_torch.ops.similarity import disable_tf32
from spotify_recommender_tpu_torch.ops.topk import topk_stable

CEPS = 2e-5
COS_EPS = 1e-8
F, K, C = 12, 10, 32
PAD = 8192    # catalog padding of the JAX main (its tc)
BATCHES = 20


def scan_call(queries_p, q_norms_p, features_t, norms_p, excl_p, valid, *,
              w: int) -> Tuple[torch.Tensor, ...]:
    """(Bp, 24) bf16 [qh, ql], (Bp, 1) f32 raw norms, (24, Np) bf16
    [hi; lo], (1, Np) f32 raw norms, (Bp, 1) excluded column (-1 = none),
    valid -> (Bp, 3W) f32 [v1|v2|v3], (Bp, 3W) int32, (Bp, W) f32 v4
    (`certified_proto.py:86`)."""
    return proto_scans.proto_scan(queries_p, q_norms_p, features_t, norms_p,
                                  excl_p, valid, w=w)


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def certified(queries, features_t2, norms_row, features32, norms1d, excl,
              valid, *, k: int, c: int,
              w: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, F) raw queries against the (2F, Np) bf16 planes [hi; lo] and
    their (1, Np) raw norms, the (N, F) fp32 rows and (N,) norms, (B,)
    exclusions, `valid` -> top-k scores (B, k), rows (B, k), certificate
    (B,) bool (`certified_proto.py:126`).  Arrays go to the catalog's
    device; ties go to the lowest row (topk_stable)."""
    dev = features_t2.device
    q = _tensor(queries, dev).float()
    feats = _tensor(features32, dev)
    nrm1 = _tensor(norms1d, dev)
    excl = _tensor(excl, dev).reshape(-1, 1)
    qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    qh, ql = split_bf16x2_plain(q / qn.clamp_min(1e-30))
    cv, ci, cb = scan_call(torch.cat([qh, ql], dim=1), qn, features_t2,
                           _tensor(norms_row, dev), excl, valid, w=w)
    # approx top-C of the 3W candidates, then sorted by row: the rerank's
    # earlier-position tie rule then picks the lowest row
    a_s, pos = topk_stable(cv, c)
    cand = torch.gather(ci, 1, pos).long()
    key = torch.where(cand < 0, 2 ** 30, cand)
    cand = torch.gather(cand, 1, torch.argsort(key, dim=1, stable=True))
    safe = cand.clamp(0, feats.shape[0] - 1)
    dots = torch.einsum("bf,bcf->bc", q, feats[safe])
    den = qn * nrm1[safe]
    guard = den > COS_EPS
    ex = torch.where(
        guard, torch.clamp(dots / torch.where(guard, den, 1.0), -1.0, 1.0),
        0.0)
    ex = ex.masked_fill(cand < 0, float("-inf"))
    top_s, p2 = topk_stable(ex, k)
    top_i = torch.gather(cand, 1, p2)
    bound = torch.maximum(a_s[:, c - 1], cb.amax(dim=1))
    everything = (ci >= 0).sum(dim=1) < 3 * w     # the catalog fit the bins
    ceps = torch.tensor(CEPS, dtype=torch.float32, device=dev)
    ok = (bound + ceps < top_s[:, k - 1]) | everything
    return top_s, top_i, ok


def layout(feats: np.ndarray, norms: np.ndarray,
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prototype's (2F, Np) bf16 planes [hi; lo] of the unit rows and
    (1, Np) raw norms, Np = N rounded up to PAD (pad columns zero)."""
    n = feats.shape[0]
    np_ = round_up(n, PAD)
    unit = torch.from_numpy(feats / norms[:, None]).to(device)
    hi, lo = split_bf16x2_plain(unit)
    ft = torch.zeros((2 * F, np_), dtype=torch.bfloat16, device=device)
    ft[:F, :n] = hi.t()
    ft[F:, :n] = lo.t()
    nrm = torch.zeros((1, np_), device=device)
    nrm[0, :n] = torch.from_numpy(norms).to(device)
    return ft, nrm


def oracle_rows(q: torch.Tensor, feats: torch.Tensor, norms: torch.Tensor,
                excl: torch.Tensor, k: int) -> torch.Tensor:
    """The exact fp32 cosine top-k rows, the excluded row masked, ties to
    the lowest row (the JAX main's numpy oracle)."""
    dots = q @ feats.T
    den = torch.linalg.vector_norm(q, dim=1)[:, None] * norms[None, :]
    guard = den > COS_EPS
    sc = torch.where(
        guard, torch.clamp(dots / torch.where(guard, den, 1.0), -1.0, 1.0),
        0.0)
    sc[torch.arange(q.shape[0], device=q.device), excl] = float("-inf")
    return topk_stable(sc, k)[1]


def main(n: int = 1_000_000, b: int = 1024, widths: Sequence[int] = (512, 256),
         n_check: int = 40_000, b_check: int = 256, device="cuda",
         reps: int = 5) -> Dict[str, object]:
    dev = resolve_device(device)
    disable_tf32()
    rng = np.random.default_rng(0)
    feats = rng.random((n, F), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    dq = torch.from_numpy(feats[rng.integers(0, n, b)]).to(dev)
    dexcl = torch.full((b,), -1, dtype=torch.int32, device=dev)
    dfe = torch.from_numpy(feats).to(dev)
    dno = torch.from_numpy(norms).to(dev)
    ft, nrm = layout(feats, norms, dev)
    out: Dict[str, object] = {}
    for w in widths:
        def run():
            return certified(dq, ft, nrm, dfe, dno, dexcl, n, k=K, c=C, w=w)

        _, _, ok = run()
        nok = int(ok.sum())
        t = sync_ms(run, reps, dev)
        t_enq = sync_ms(run, max(1, reps // 2), dev, calls=BATCHES)
        out[f"w{w}"] = {"ms": t, "enqueued_ms": t_enq, "cert_ok": nok}
        print(f"W={w}: per batch {t:8.3f} ms ({b / t * 1e3:,.0f} q/s); "
              f"{BATCHES} batches enqueued {t_enq:8.3f} ms per batch "
              f"({b / t_enq * 1e3:,.0f} q/s); cert_ok {nok}/{b}", flush=True)

    # the check against the oracle, self-exclusions, at the first width
    w = widths[0]
    feats_s = rng.random((n_check, F), dtype=np.float32)
    norms_s = np.linalg.norm(feats_s, axis=1).astype(np.float32)
    q_s = torch.from_numpy(feats_s[rng.integers(0, n_check, b_check)]).to(dev)
    excl_s = torch.from_numpy(rng.integers(0, n_check, b_check)).to(dev)
    ft_s, nrm_s = layout(feats_s, norms_s, dev)
    f_s = torch.from_numpy(feats_s).to(dev)
    n_s = torch.from_numpy(norms_s).to(dev)
    _, i, ok = certified(q_s, ft_s, nrm_s, f_s, n_s, excl_s.int(), n_check,
                         k=K, c=C, w=w)
    match = (i == oracle_rows(q_s, f_s, n_s, excl_s, K)).all(dim=1)
    bad = int((~match & ok).sum())
    out["check"] = {"w": w, "exact_match": int(match.sum()),
                    "cert_ok": int(ok.sum()), "mismatch_cert_ok": bad,
                    "b": b_check}
    print(f"correctness (W={w}, {n_check} x {b_check}): {int(match.sum())}/"
          f"{b_check} exact-match, cert_ok {int(ok.sum())}/{b_check}, "
          f"mismatches-with-cert-ok: {bad}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("widths", nargs="*", type=int, default=[512, 256])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.b, args.widths, device=args.device)
