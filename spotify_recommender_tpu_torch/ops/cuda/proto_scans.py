"""TPU kernels 9-12: the bin-scan prototypes of the JAX repo's
`experiments/`, as wrappers over `csrc/proto_scans.cu` and, for
`mxu_only`, `csrc/mxu_wgmma.cu`.

    mxu_only(q, ft)                       (B, 128) f32: per query and lane
                                          (column mod 128) the max dot
    mxu_only_tolerance(q, ft)             (B, 128) f32: its card check's bound
    scan_d1(q, ft, w=, invert=)           3 x (B, w): per bin the best value,
                                          its column (int32), the 2nd best
    scan_d1_split(q, ft, w=)              the same over a catalog split
    scan3(q, qn, ft, cn, eps=)            7 x (B, 256): v1 i1 v2 i2 v3 i3 v4
    proto_scan(q, qn, ft, cn, excl, valid, w=, eps=)
                                          (B, 3w) f32 [v1|v2|v3], (B, 3w)
                                          int32 [i1|i2|i3], (B, w) f32 v4

Inputs, in the prototypes' own layouts: q (B, qw) bf16; ft (>= qw rows,
Np) bf16, Np a multiple of w (of 128 for `mxu_only`); qn (B,) or (B, 1)
f32 raw query norms; cn (Np,) or (1, Np) f32 raw catalog norms; excl (B,)
or (B, 1) column to mask, -1 = none; valid: columns >= valid are padding.

dot(q, col) = sum_r q[r] * ft[r, col] over r < qw: the prototypes' one
`dot_general` of the query with catalog rows [0, qw).  Their callers feed
qw = 24 ([qh, ql] against [hi; lo], which drops the cross terms ql*hi +
qh*lo) or qw = 48 (kernel_r3.py).  Scores: raw dots (`mxu_only`,
`scan_d1`); `qn*cn > eps ? clamp(dot, -1, 1) : 0` (`scan3`), then -inf on
columns >= valid and on the excluded column (`proto_scan`).  Bin of column
c: c mod w; each bin keeps its top-D (value, column) with strict `>` (the
lowest column wins ties) and its (D+1)-th best value.

On CUDA tensors each wrapper launches its kernel (w a multiple of 128 up
to FLAT_MAX_BINS: the flat instances of csrc/bin_scan.cuh) and counts the
launch in `<wrapper>.launches`; on CPU
tensors it runs the plain version, which sums the same exact bf16 products
in the bin scans' order (ascending rows, one fp32 rounding each), so on the
card those agree bitwise.  `mxu_only`'s kernel sums on the tensor cores
(`wgmma`, csrc/mxu_wgmma.cu; qw <= MXU_MAX_QW), in their own order, so it
is held to its plain version within `mxu_only_tolerance`, a bound derived
for any fp32 accumulation that rounds each addition once.
`scan_d1_split_plain` repeats the kernel's per-slice walk and merge
(ops/cuda/scan_v3.merge_bins at depth 1), which equal the single walk
bitwise.  The kernels live in the experiment library
(ops/cuda/_build.EXPERIMENTS), built at the first launch of one of them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (
    FLAT_MAX_BINS,
    H100_SMS,
    bin_structures,
    check_kernel_layout,
    device_sms,
    merge_bins,
    queries_per_block,
    split_slice,
)

LANES = 128          # mxu_only's lanes
MXU_QUERIES = 128    # queries per mxu_only block (csrc/mxu_wgmma.cu)
MXU_MAX_QW = 64      # the widest query its kernel takes: 4 wgmma k steps
SCAN3_BINS = 256     # k_scan3's fixed W
DEPTH3 = 3           # scan3 / proto_scan bin depth
EPS = 1e-8           # the prototypes' guard
LIB = _build.EXPERIMENTS
# catalog-split grids: blocks per SM they aim for
MXU_BLOCKS_PER_SM = 2     # two waves of its one resident block per SM
MXU_TOL_CHUNK = 1 << 27   # elements of one fp64 chunk of mxu_only_tolerance
D1_BLOCKS_PER_SM = 2

Outs = Tuple[torch.Tensor, ...]


def plain_dots(q: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """(B, Np) fp32 dots of q (B, qw) with ft rows [0, qw), summed in the
    bin scans' order (kernels 9, 11 and 12: ascending rows): each bf16
    product is exact in fp32, so every step rounds once, as those kernels'
    FMA does.  `mxu_only`'s kernel sums on the tensor cores in their own
    order and is held to this sum within `mxu_only_tolerance`."""
    qw = q.shape[1]
    qf, ff = q.float(), ft[:qw].float()
    dots = torch.zeros((q.shape[0], ft.shape[1]), dtype=torch.float32,
                       device=q.device)
    for r in range(qw):
        dots.addcmul_(qf[:, r:r + 1], ff[r:r + 1])
    return dots


def guard_clip(dots: torch.Tensor, qn: torch.Tensor, cn: torch.Tensor,
               eps: float) -> torch.Tensor:
    den = qn[:, None] * cn[None, :]
    return torch.where(den > eps, torch.clamp(dots, -1.0, 1.0), 0.0)


def _scalar(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.reshape(-1)[0].item())
    return int(np.asarray(x).reshape(-1)[0])


def _check(q: torch.Tensor, ft: torch.Tensor, mult: int, what: str) -> int:
    """Types and shapes every version needs; returns qw."""
    if q.dtype != torch.bfloat16 or ft.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bfloat16, got {q.dtype}, {ft.dtype}")
    if q.dim() != 2 or ft.dim() != 2 or ft.shape[0] < q.shape[1]:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs ft {tuple(ft.shape)}")
    if ft.shape[1] % mult:
        raise ValueError(f"{what}: Np={ft.shape[1]} is not a multiple of {mult}")
    return q.shape[1]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_kernel(q: torch.Tensor, ft: torch.Tensor, w: int, what: str,
                  *others: torch.Tensor) -> None:
    """What the kernels need beyond the plain versions (scan_v3's layout
    rules), and the norms and exclusions on the same device, contiguous."""
    check_kernel_layout(q, ft, w, what)
    if w > FLAT_MAX_BINS:
        raise ValueError(f"{what}: W={w}: the prototype scans run the flat "
                         f"instances, W up to {FLAT_MAX_BINS}")
    if any(t.device != q.device or not t.is_contiguous() for t in others):
        raise ValueError(f"{what}: norms and exclusions must be contiguous "
                         f"on {q.device}, got {[t.device for t in others]}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


# ---------------------------------------------------------------- mxu_only

def mxu_only_plain(q: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    dots = plain_dots(q, ft)
    return dots.view(q.shape[0], -1, LANES).amax(dim=1)


def mxu_only_tolerance(q: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """(B, 128) f32: how far `mxu_only`'s kernel may lie from its plain
    version, qw * 2^-22 * S, S per (query, lane) the max over the lane's
    columns c of sum_r |q[r] * ft[r, c]|.

    The qw products are exact in fp32.  Any fp32 accumulation of them that
    rounds each addition once, to nearest or toward zero, lies within
    qw * 2^-23 * S of the exact sum (each rounding moves the partial sum by
    at most 2^-23 of it, and every partial sum is at most S); the plain
    version, sequential round-to-nearest, within qw * 2^-24 * S; a max over
    columns moves no more than its worst term.  So the two lie within
    qw * (2^-23 + 2^-24) * S, under qw * 2^-22 * S.  The tensor cores' sum
    is of another kind: on an H100 it is, bitwise on every dot measured, a
    model that per k step of 16 truncates each term 2 bits below the last
    bit of the step's largest exponent and the step's sum once (PERF.md
    section 6; experiments/kernel_r3.step_model), which errs by
    less than 5.25 * 2^-23 * S per step, inside the same bound for
    qw >= 16.  S is summed in fp64
    (exact products, no rounding that matters) over column chunks of at
    most MXU_TOL_CHUNK / B columns."""
    qw, b, np_ = q.shape[1], q.shape[0], ft.shape[1]
    qa = q.double().abs()
    chunk = max(LANES, MXU_TOL_CHUNK // max(b, 1) // LANES * LANES)
    s = torch.zeros((b, LANES), dtype=torch.float64, device=q.device)
    for c0 in range(0, np_, chunk):
        fa = ft[:qw, c0:c0 + chunk].double().abs()
        s = torch.maximum(s, (qa @ fa).view(b, -1, LANES).amax(dim=1))
    return (qw * 2.0**-22 * s).float()


def mxu_only(q: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """TPU kernel 10 (`experiments/kernel_r3.py:53`)."""
    qw = _check(q, ft, LANES, "mxu_only")
    if _on_cpu(q, ft):
        return mxu_only_plain(q, ft)
    _check_kernel(q, ft, LANES, "mxu_only")
    if qw > MXU_MAX_QW:
        raise ValueError(f"mxu_only: the kernel takes qw <= {MXU_MAX_QW}, "
                         f"got {qw}")
    b, np_ = q.shape[0], ft.shape[1]
    slice_ = split_slice(b, np_, LANES, MXU_QUERIES, device_sms(q.device),
                         MXU_BLOCKS_PER_SM)
    slices = max(1, -(-np_ // slice_))
    out = _empty((b, LANES), torch.float32, q)
    part = _empty((slices, b, LANES), torch.float32, q) if slices > 1 else out
    with torch.cuda.device(q.device):
        err = _build.library(LIB).srt_mxu_only(
            q.data_ptr(), b, qw, ft.data_ptr(), ft.stride(0), np_, slice_,
            part.data_ptr(), out.data_ptr(), _stream())
    _build.check(err, f"mxu_only (qw={qw})", LIB)
    mxu_only.launches += 1
    return out


mxu_only.launches = 0   # kernel launches (CUDA tensors only)


# ----------------------------------------------------------------- scan_d1

def scan_d1_plain(q: torch.Tensor, ft: torch.Tensor, *, w: int) -> Outs:
    return bin_structures(plain_dots(q, ft), w, 1)


def scan_d1_split_plain(q: torch.Tensor, ft: torch.Tensor, *, w: int,
                        slice_: Optional[int] = None) -> Outs:
    """The kernel's per-slice walk and merge; `slice_` columns per slice
    (a multiple of w), by default the card's schedule.  Only one slice's
    dots are held at a time, so a large catalog runs in slices of a
    size that fits."""
    np_ = ft.shape[1]
    if slice_ is None:
        slice_ = split_slice(q.shape[0], np_, w, queries_per_block(w),
                             H100_SMS, D1_BLOCKS_PER_SM)
    parts = []
    for c0 in range(0, np_, slice_):
        dots = plain_dots(q, ft[:, c0:c0 + slice_])
        v, i, bnd = bin_structures(dots, w, 1)
        parts.append((v, torch.where(i >= 0, i + c0, i), bnd))
        del dots
    return merge_bins(parts, 1)


def scan_d1(q: torch.Tensor, ft: torch.Tensor, *, w: int,
            invert: bool = False) -> Outs:
    """TPU kernel 11 (`experiments/kernel_r3.py:151`); `invert=True`, the
    prototype's catalog-outer grid, is `scan_d1_split` here."""
    if invert:
        return scan_d1_split(q, ft, w=w)
    qw = _check(q, ft, w, "scan_d1")
    if _on_cpu(q, ft):
        return scan_d1_plain(q, ft, w=w)
    _check_kernel(q, ft, w, "scan_d1")
    b, np_ = q.shape[0], ft.shape[1]
    ov = _empty((b, w), torch.float32, q)
    oi = _empty((b, w), torch.int32, q)
    ob = _empty((b, w), torch.float32, q)
    with torch.cuda.device(q.device):
        err = _build.library(LIB).srt_scan_d1(
            q.data_ptr(), b, qw, ft.data_ptr(), ft.stride(0), np_, w,
            ov.data_ptr(), oi.data_ptr(), ob.data_ptr(), _stream())
    _build.check(err, f"scan_d1 (w={w}, qw={qw})", LIB)
    scan_d1.launches += 1
    return ov, oi, ob


scan_d1.launches = 0


def scan_d1_split(q: torch.Tensor, ft: torch.Tensor, *, w: int) -> Outs:
    """`scan_d1` with the catalog split across blocks (slices of W-column
    groups, enough to fill the card twice) and a per-bin merge: bitwise the
    single walk's result."""
    qw = _check(q, ft, w, "scan_d1_split")
    if _on_cpu(q, ft):
        return scan_d1_split_plain(q, ft, w=w)
    _check_kernel(q, ft, w, "scan_d1_split")
    b, np_ = q.shape[0], ft.shape[1]
    slice_ = split_slice(b, np_, w, queries_per_block(w), device_sms(q.device),
                         D1_BLOCKS_PER_SM)
    slices = max(1, -(-np_ // slice_))
    wv = _empty((slices, b, w), torch.float32, q)
    wi = _empty((slices, b, w), torch.int32, q)
    wb = _empty((slices, b, w), torch.float32, q)
    ov = _empty((b, w), torch.float32, q)
    oi = _empty((b, w), torch.int32, q)
    ob = _empty((b, w), torch.float32, q)
    with torch.cuda.device(q.device):
        err = _build.library(LIB).srt_scan_d1_split(
            q.data_ptr(), b, qw, ft.data_ptr(), ft.stride(0), np_, w, slice_,
            wv.data_ptr(), wi.data_ptr(), wb.data_ptr(), ov.data_ptr(),
            oi.data_ptr(), ob.data_ptr(), _stream())
    _build.check(err, f"scan_d1_split (w={w}, qw={qw}, slice={slice_})", LIB)
    scan_d1_split.launches += 1
    return ov, oi, ob


scan_d1_split.launches = 0


# ------------------------------------------------------ scan3, proto_scan

def _norms(qn, cn, b: int, np_: int, what: str):
    qn, cn = qn.reshape(-1), cn.reshape(-1)
    if qn.dtype != torch.float32 or cn.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 norms, got {qn.dtype}, {cn.dtype}")
    if qn.shape != (b,) or cn.shape != (np_,):
        raise ValueError(f"{what}: {qn.numel()} query and {cn.numel()} "
                         f"catalog norms for B={b}, Np={np_}")
    return qn.contiguous(), cn.contiguous()


def _levels(sv: torch.Tensor, si: torch.Tensor, bound: torch.Tensor,
            w: int) -> Outs:
    """(B, 3w) structures as k_scan3's seven (B, w) outputs."""
    out = []
    for lv in range(DEPTH3):
        out += [sv[:, lv * w:(lv + 1) * w], si[:, lv * w:(lv + 1) * w]]
    return (*out, bound)


def scan3_plain(q, qn, ft, cn, *, eps: float = EPS) -> Outs:
    qn, cn = qn.reshape(-1), cn.reshape(-1)
    scores = guard_clip(plain_dots(q, ft), qn, cn, eps)
    return _levels(*bin_structures(scores, SCAN3_BINS, DEPTH3), SCAN3_BINS)


def _launch_proto(q, qn, ft, cn, excl, valid: int, w: int, eps: float,
                  what: str) -> Outs:
    """The depth-3 scan of `srt_proto_scan` on CUDA tensors."""
    _check_kernel(q, ft, w, what, qn, cn, excl)
    b, qw, np_ = q.shape[0], q.shape[1], ft.shape[1]
    ov = _empty((b, DEPTH3 * w), torch.float32, q)
    oi = _empty((b, DEPTH3 * w), torch.int32, q)
    ob = _empty((b, w), torch.float32, q)
    with torch.cuda.device(q.device):
        err = _build.library(LIB).srt_proto_scan(
            q.data_ptr(), qn.data_ptr(), b, qw, ft.data_ptr(), ft.stride(0),
            cn.data_ptr(), np_, excl.data_ptr(), valid, ctypes.c_float(eps),
            w, ov.data_ptr(), oi.data_ptr(), ob.data_ptr(), _stream())
    _build.check(err, f"{what} (w={w}, qw={qw})", LIB)
    return ov, oi, ob


def scan3(q, qn, ft, cn, *, eps: float = EPS) -> Outs:
    """TPU kernel 9 (`experiments/kernel_ablation_r2e.py:26`): W = 256,
    `proto_scan`'s kernel with no exclusion and every column valid."""
    _check(q, ft, SCAN3_BINS, "scan3")
    b, np_ = q.shape[0], ft.shape[1]
    qn, cn = _norms(qn, cn, b, np_, "scan3")
    if _on_cpu(q, ft, qn, cn):
        return scan3_plain(q, qn, ft, cn, eps=eps)
    none = torch.full((b,), -1, dtype=torch.int64, device=q.device)
    out = _launch_proto(q, qn, ft, cn, none, np_, SCAN3_BINS, eps, "scan3")
    scan3.launches += 1
    return _levels(*out, SCAN3_BINS)


scan3.launches = 0


def proto_scan_plain(q, qn, ft, cn, excl, valid, *, w: int,
                     eps: float = EPS) -> Outs:
    qn, cn = qn.reshape(-1), cn.reshape(-1)
    excl = torch.as_tensor(excl, device=q.device).reshape(-1)
    scores = guard_clip(plain_dots(q, ft), qn, cn, eps)
    cols = torch.arange(ft.shape[1], device=q.device)[None, :]
    bad = (cols >= _scalar(valid)) | (cols == excl[:, None])
    return bin_structures(scores.masked_fill(bad, float("-inf")), w, DEPTH3)


def proto_scan(q, qn, ft, cn, excl, valid, *, w: int,
               eps: float = EPS) -> Outs:
    """TPU kernel 12 (`experiments/certified_proto.py:18`)."""
    _check(q, ft, w, "proto_scan")
    b, np_ = q.shape[0], ft.shape[1]
    qn, cn = _norms(qn, cn, b, np_, "proto_scan")
    excl = torch.as_tensor(excl, device=q.device).reshape(-1)
    if excl.shape != (b,) or excl.dtype.is_floating_point:
        raise ValueError(f"proto_scan: exclusions {tuple(excl.shape)} "
                         f"{excl.dtype} for B={b}")
    if _on_cpu(q, ft, qn, cn):
        return proto_scan_plain(q, qn, ft, cn, excl, valid, w=w, eps=eps)
    out = _launch_proto(q, qn, ft, cn, excl.to(torch.int64).contiguous(),
                        _scalar(valid), w, eps, "proto_scan")
    proto_scan.launches += 1
    return out


proto_scan.launches = 0
