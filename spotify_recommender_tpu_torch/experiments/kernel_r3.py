"""Where a bin scan's time goes at 10M x 1024, and what a leaner structure
and a catalog split buy: the port of the JAX repo's
`experiments/kernel_r3.py`.

Variants, all at W = 512 over a bf16 split-plane catalog (N = 10M, F = 12):

    mxu_only        dots plus one max per lane: the floor probe (TPU
                    kernel 10, ops/cuda/proto_scans.mxu_only)
    scan_d3_topc    kernel 4, depth 3, in-kernel top-32 (ops/cuda/scan_v2)
    scan_d1         depth-1 bins plus the 2nd-best bound, one catalog walk
                    per query tile (TPU kernel 11)
    scan_d1_split   the same with the catalog split across blocks and the
                    bins merged: the card's form of the prototype's
                    catalog-outer grid (`invert=True`); bitwise scan_d1's

`main` prints ms, q/s and GB/s of catalog bytes for each, then B = 1 for
the two `scan_d1` schedules, and checks that they agree bitwise.

The data is a real split layout, made on the device from a seeded
generator: uniform [0, 1) rows, normalized, split into bf16 hi / lo; the
queries (B, 48) are [qh, ql, ql, qh] of catalog rows, the catalog (48, Np)
is [hi; lo; hi; lo].  Every variant then scores the same 48 products per
column (the JAX main feeds independent standard-normal planes, on which
kernel 4, which reads two of the four planes, computes something else).

    python -m spotify_recommender_tpu_torch.experiments.kernel_r3 [N] [B] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.timing import sync_ms
from spotify_recommender_tpu_torch.experiments import round_up
from spotify_recommender_tpu_torch.ops.cuda import proto_scans
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import scan_v2
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2_plain
from spotify_recommender_tpu_torch.ops.similarity import row_norms

F = 12
W = 512
TOPC = 32
PAD = 65536   # catalog padding of the JAX main (max(tc, 65536))


def mxu_only(q: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """(Bp, qw) bf16 queries against (qw, Np) bf16 planes -> (Bp, 128) f32,
    the max dot per lane `col mod 128` (`kernel_r3.py:78`)."""
    return proto_scans.mxu_only(q, ft)


def scan_d1(q: torch.Tensor, ft: torch.Tensor, *, w: int,
            invert: bool = False) -> Tuple[torch.Tensor, ...]:
    """Depth-1 bins over `col mod w` plus the 2nd-best bound on the raw
    dots -> (Bp, w) f32, (Bp, w) int32, (Bp, w) f32 (`kernel_r3.py:137`).
    `invert=True` splits the catalog across blocks; same outputs."""
    return proto_scans.scan_d1(q, ft, w=w, invert=invert)


def split_layout(n: int, b: int, device: torch.device,
                 seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 4F) bf16 queries [qh, ql, ql, qh] of B catalog rows and the
    (4F, Np) bf16 catalog [hi; lo; hi; lo], Np = n rounded up to PAD (the
    padding columns are zero)."""
    g = torch.Generator(device=device).manual_seed(seed)
    feats = torch.rand((n, F), generator=g, device=device)
    rows = torch.randint(0, n, (b,), generator=g, device=device)
    unit = feats / row_norms(feats).clamp_min(1e-30)[:, None]
    del feats
    hi, lo = split_bf16x2_plain(unit)
    ft = torch.zeros((4 * F, round_up(n, PAD)), dtype=torch.bfloat16,
                     device=device)
    for p, plane in enumerate((hi, lo, hi, lo)):
        ft[p * F:(p + 1) * F, :n] = plane.t()
    qh, ql = hi[rows], lo[rows]
    return torch.cat([qh, ql, ql, qh], dim=1), ft


def main(n: int = 10_000_000, b: int = 1024, device="cuda",
         reps: int = 10) -> Dict[str, object]:
    dev = resolve_device(device)
    q, ft = split_layout(n, b, dev)
    np_ = ft.shape[1]
    ones_q = torch.ones(b, device=dev)
    ones_c = torch.ones(np_, device=dev)
    none = torch.full((b,), -1, dtype=torch.int64, device=dev)

    def d3(qq):
        m = qq.shape[0]
        return scan_v2(qq, ones_q[:m], ft, ones_c, none[:m], n, w=W, eps=1e-8,
                       topc=TOPC)

    variants = {
        "mxu_only": lambda qq: mxu_only(qq, ft),
        "scan_d3_topc": d3,
        "scan_d1": lambda qq: scan_d1(qq, ft, w=W),
        "scan_d1_split": lambda qq: scan_d1(qq, ft, w=W, invert=True),
    }
    bytes_cat = np_ * 4 * F * 2
    out: Dict[str, object] = {"n": n, "b": b, "np": np_,
                              "catalog_bytes": bytes_cat}
    for name, fn in variants.items():
        t = sync_ms(lambda: fn(q), reps, dev)
        out[name] = t
        print(f"{name:16s} {t:9.3f} ms  {b / t * 1e3:12.0f} q/s  "
              f"{bytes_cat / t / 1e6:8.1f} GB/s (catalog bytes)", flush=True)
    q1 = q[:1]
    for name in ("scan_d1", "scan_d1_split"):
        t = sync_ms(lambda: variants[name](q1), reps, dev)
        out[name + "_b1"] = t
        print(f"{name + ' B=1':16s} {t:9.3f} ms", flush=True)
    equal = []
    for qq in (q, q1):
        single = scan_d1(qq, ft, w=W)
        split = scan_d1(qq, ft, w=W, invert=True)
        equal.append(all(torch.equal(a, c) for a, c in zip(single, split)))
    out["split_equal"] = equal
    print(f"scan_d1_split bitwise equal to scan_d1 at B={b} and B=1: "
          f"{equal}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=10_000_000)
    ap.add_argument("b", nargs="?", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.b, args.device)
