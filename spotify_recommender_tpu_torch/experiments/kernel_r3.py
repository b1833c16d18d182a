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
the two `scan_d1` schedules, and checks that they agree bitwise.  The
command line then runs `accumulation_study`: how far `mxu_only`'s
tensor-core sums lie from the exact dots, against the round-to-nearest
model that BF16X2_EPS assumes (48 additions, each rounding once to
nearest), and prints it with `format_study`.

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
QW = 4 * F    # the dot's width: [qh, ql, ql, qh] against [hi; lo; hi; lo]
STUDY_SETS = ("split", "normal", "cancel")
ULP1 = 2.0**-23   # fp32's spacing above 1
NO_EXP = -(1 << 20)   # `step_model`'s exponent of 0
KEEP_BITS = 2   # bits `step_model` keeps below the last bit of a k step's top


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


def unit_planes(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 hi / lo planes of the rows of `feats` scaled to unit norm."""
    return split_bf16x2_plain(feats / row_norms(feats).clamp_min(1e-30)[:, None])


def split_layout(n: int, b: int, device: torch.device,
                 seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 4F) bf16 queries [qh, ql, ql, qh] of B catalog rows and the
    (4F, Np) bf16 catalog [hi; lo; hi; lo], Np = n rounded up to PAD (the
    padding columns are zero)."""
    g = torch.Generator(device=device).manual_seed(seed)
    feats = torch.rand((n, F), generator=g, device=device)
    rows = torch.randint(0, n, (b,), generator=g, device=device)
    hi, lo = unit_planes(feats)
    del feats
    ft = torch.zeros((4 * F, round_up(n, PAD)), dtype=torch.bfloat16,
                     device=device)
    for p, plane in enumerate((hi, lo, hi, lo)):
        ft[p * F:(p + 1) * F, :n] = plane.t()
    qh, ql = hi[rows], lo[rows]
    return torch.cat([qh, ql, ql, qh], dim=1), ft


def study_inputs(kind: str, b: int, g: torch.Generator,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 48) bf16 queries and a (48, 128) bf16 catalog, so that each of
    `mxu_only`'s outputs is one dot:

        split   the real split operand: [qh, ql, ql, qh] of uniform unit
                rows against [hi; lo; hi; lo] of 128 others
        normal  standard-normal planes (the JAX main's data)
        cancel  cancellation-heavy: rows 16-31 repeat the query's rows 0-15
                against the negated catalog rows 0-15, so 16 pairs of large
                opposite products cancel exactly, beside 16 products of
                rows 32-47 scaled by 2^-12"""
    if kind == "split":
        qh, ql = unit_planes(torch.rand((b, F), generator=g, device=device))
        hi, lo = unit_planes(torch.rand((128, F), generator=g, device=device))
        return (torch.cat([qh, ql, ql, qh], 1),
                torch.cat([hi, lo, hi, lo], 1).t().contiguous())
    q = torch.randn((b, QW), generator=g, device=device).bfloat16()
    ft = torch.randn((QW, 128), generator=g, device=device).bfloat16()
    if kind == "cancel":
        q[:, 16:32] = q[:, :16]
        ft[16:32] = -ft[:16]
        ft[32:] = (ft[32:].float() * 2.0**-12).bfloat16()   # exact
    return q, ft


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) per entry, NO_EXP where x is 0."""
    _, e = torch.frexp(x)
    return torch.where(x != 0, e - 1, torch.full_like(e, NO_EXP))


def step_model(q: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """(B, Np) fp32: the dots of q (B, qw) with ft rows [0, qw) summed as
    `wgmma`'s fp32 accumulation sums them on an H100, as far as it was
    measured (PERF.md section 6: every one of the study's dots and of
    `rounding_probe`'s): per k step of 16 rows, take
    the largest exponent E among the accumulator's and the products'
    (a product's is ea + eb, its operands' exponents, with the product's
    significand in [1, 4)), truncate each term toward zero to a multiple of
    2^(E - 23 - KEEP_BITS), sum (exactly: 17 integers below 2^27 in that
    unit), and truncate the sum toward zero to fp32.  In fp64, (B, 17, Np)
    terms at a time."""
    qw = q.shape[1]
    qd, fd = q.double(), ft[:qw].double()
    eq, ef = _exponent(qd), _exponent(fd)
    acc = torch.zeros((q.shape[0], ft.shape[1]), dtype=torch.float64,
                      device=q.device)
    for k0 in range(0, qw, 16):
        prods = qd[:, k0:k0 + 16, None] * fd[None, k0:k0 + 16]
        pe = eq[:, k0:k0 + 16, None] + ef[None, k0:k0 + 16]
        pe = torch.where(prods != 0, pe, torch.full_like(pe, NO_EXP))
        top = torch.maximum(pe.amax(dim=1, keepdim=True),
                            _exponent(acc)[:, None])
        top = torch.where(top > NO_EXP, top, torch.zeros_like(top))  # all 0
        res = torch.ldexp(torch.ones_like(acc[:, None]), top - 23 - KEEP_BITS)
        terms = torch.cat([acc[:, None], prods], 1)
        total = (torch.trunc(terms / res) * res).sum(dim=1)
        x = total.float()
        past = x.double().abs() > total.abs()
        acc = torch.where(past, torch.nextafter(x, torch.zeros_like(x)),
                          x).double()
    return acc.float()


def rounding_probe(device: torch.device) -> Dict[str, Tuple[float, ...]]:
    """Directed dots of 48 products (the query all ones) whose exact value
    sits between fp32 neighbours, as (kernel, plain, exact), each minus its
    leading +-1 and in units of 2^-23 (fp32's spacing above 1), then the
    kernel's and the plain version's |sum - exact| / (qw 2^-24 S), then
    `step_model`'s value in the same units:

        up_0.75    1 + 0.75: round-to-nearest gives 1, toward zero 0
        down_0.75  -(1 + 0.75): -1 to nearest, 0 toward zero
        tie_0.5    1 + 0.5: 0 to nearest even, 1 away from zero
        small_after  1, then 47 x 0.125: exact 5.875; a sequential
                   round-to-nearest sum drops each (0), one rounding of the
                   exact sum gives 6, a rounding per 16 products 6, a
                   truncation per 16 products 5; a sum that keeps each
                   term to 2 bits below the last bit of its k step's
                   largest term drops them (0)
        small_first  46 x 0.125 (rows 0-45), then 1 (row 47): exact 5.75;
                   6 to nearest, 5 toward zero; 4 where the last step
                   drops its 0.125s beside the 1
        sub_ulp_after  1, then 47 x (1 - 2^-8): exact 46.82; sequential
                   round-to-nearest rounds each up (47); with no bit kept
                   below the largest term's last one all drop (0, 1.95 of
                   the budget qw 2^-24 S); with 2 bits kept each counts
                   0.75 and each k step truncates (35, 0.49)"""
    ft = torch.zeros((QW, 128), dtype=torch.float64)
    cases = ("up_0.75", "down_0.75", "tie_0.5", "small_after", "small_first",
             "sub_ulp_after")
    ft[0, 0], ft[1, 0] = 1.0, 0.75 * ULP1
    ft[0, 1], ft[1, 1] = -1.0, -0.75 * ULP1
    ft[0, 2], ft[1, 2] = 1.0, 0.5 * ULP1
    ft[0, 3], ft[1:, 3] = 1.0, 0.125 * ULP1
    ft[:46, 4], ft[47, 4] = 0.125 * ULP1, 1.0
    ft[0, 5], ft[1:, 5] = 1.0, (1 - 2.0**-8) * ULP1
    ft = ft.to(torch.bfloat16).to(device)      # every value is exact in bf16
    q = torch.ones((1, QW), dtype=torch.bfloat16, device=device)
    n = len(cases)
    got = proto_scans.mxu_only(q, ft)[0, :n].double().cpu()
    plain = proto_scans.mxu_only_plain(q, ft)[0, :n].double().cpu()
    exact = (q.double() @ ft.double())[0, :n].cpu()
    unit = QW * 2.0**-24 * (q.double() @ ft.double().abs())[0, :n].cpu()
    lead = torch.tensor([1.0, -1.0, 1.0, 1.0, 1.0, 1.0], dtype=torch.float64)
    model = step_model(q, ft)[0, :n].double().cpu()
    units = [((x - lead) / ULP1).tolist() for x in (got, plain, exact, model)]
    ratios = [((x - exact).abs() / unit).tolist() for x in (got, plain)]
    return {c: (units[0][i], units[1][i], units[2][i], ratios[0][i],
                ratios[1][i], units[3][i]) for i, c in enumerate(cases)}


def accumulation_study(device, b: int = 65536, calls: int = 4,
                       seed: int = 0) -> Dict[str, object]:
    """`mxu_only` at Np = 128 (each output one dot) on `calls` batches of B
    queries of each data set (`study_inputs`; 3 x 4 x 65,536 x 128 = 1.0e8
    dots by default), against the exact dot (the bf16 operands in fp64).
    Per set: `kernel_ratio` and `plain_ratio`, the max over the dots of
    |sum - exact| / (qw * 2^-24 * S), S = sum_r |q[r] * ft[r, c]|: the
    round-to-nearest model's bound is 1 (the plain version's sum meets it
    by construction); `kernel_exact` and `plain_exact`, the share of dots
    equal to the exact value rounded once to fp32; `kernel_model`, the
    share bitwise equal to `step_model` (1 on the card so far); `within`,
    whether every kernel
    output lies within `mxu_only_tolerance` of the plain version's.  Then
    `rounding`: `rounding_probe`."""
    dev = resolve_device(device)
    out: Dict[str, object] = {"b": b, "calls": calls}
    for si, kind in enumerate(STUDY_SETS):
        g = torch.Generator(device=dev).manual_seed(seed + 1000 * si)
        acc = {"dots": 0, "kernel_ratio": 0.0, "plain_ratio": 0.0,
               "kernel_exact": 0, "plain_exact": 0, "kernel_model": 0,
               "within": True}
        for _ in range(calls):
            q, ft = study_inputs(kind, b, g, dev)
            got = proto_scans.mxu_only(q, ft)
            plain = proto_scans.mxu_only_plain(q, ft)
            tol = proto_scans.mxu_only_tolerance(q, ft)
            exact = q.double() @ ft.double()
            unit = QW * 2.0**-24 * (q.double().abs() @ ft.double().abs())
            rounded = exact.float()
            for name, x in (("kernel", got), ("plain", plain)):
                err = (x.double() - exact).abs()
                ratio = torch.where(err > 0, err / unit, torch.zeros_like(err))
                acc[f"{name}_ratio"] = max(acc[f"{name}_ratio"],
                                           ratio.max().item())
                acc[f"{name}_exact"] += int((x == rounded).sum().item())
            acc["kernel_model"] += int((got == step_model(q, ft)).sum().item())
            acc["within"] &= bool(((got - plain).abs() <= tol).all().item())
            acc["dots"] += got.numel()
        for name in ("kernel_exact", "plain_exact", "kernel_model"):
            acc[name] /= acc["dots"]
        out[kind] = acc
    out["rounding"] = rounding_probe(dev)
    return out


def format_study(study: Dict[str, object]) -> str:
    """One line of `accumulation_study`'s result: per set the dots, max
    |sum - exact| / (qw 2^-24 S) of kernel / plain, their shares equal to
    the exact dot rounded once, the kernel's share bitwise `step_model`'s;
    then the rounding probe."""
    sets = ", ".join(
        f"{k} {study[k]['dots']} dots {study[k]['kernel_ratio']:.4g} / "
        f"{study[k]['plain_ratio']:.4g}, {study[k]['kernel_exact']:.4f} / "
        f"{study[k]['plain_exact']:.4f}, {study[k]['kernel_model']:.6f}"
        for k in STUDY_SETS)
    probe = ", ".join(f"{c} ({k:g}, {p:g}, {e:g}; {rk:.3g}, {rp:.3g}; "
                      f"model {m:g})"
                      for c, (k, p, e, rk, rp, m) in study["rounding"].items())
    return ("mxu_only accumulation study (Np=128, each output one dot; max "
            "|sum - exact| / (qw 2^-24 S), kernel / plain; share equal to "
            "the exact dot rounded once, kernel / plain; share of kernel "
            "outputs bitwise kernel_r3.step_model's): " + sets
            + "; rounding probe (kernel, plain, exact in units of 2^-23; "
            "kernel and plain |sum - exact| / (qw 2^-24 S); "
            "kernel_r3.step_model): " + probe)


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
    print(format_study(accumulation_study(args.device)), flush=True)
