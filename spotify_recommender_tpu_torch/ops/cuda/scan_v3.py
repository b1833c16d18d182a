"""Kernel 1 of the certified path: the epilogue-free v3 bin scan.

`scan_v3(q2, ft, w=, depth=, topc=)` scans split-plane unit queries
against the split-plane prenormalized catalog and returns, per query, the
top-`topc` candidates of its bin structure and the coverage bound:

    q2   (B, 4F) bf16   [qh, ql, ql, qh]
    ft   (P*F, Np) bf16 catalog planes [hi; lo] (P = 2) or
                        [hi; lo; hi; lo] (P = 4); Np a multiple of w
    out  (B, topc) f32 approx scores, (B, topc) int32 columns,
         (B, 1) f32 bound

Bin of column c: c mod w.  Each bin keeps its top-`depth` (value, column)
with strict `>` (lowest column wins ties) and its (depth+1)-th best value;
the output is the top-`topc` of the depth*w slots (slot = level*w + bin) by
value descending, slot ascending, with empty slots as (-inf, -1).  This is
what the TPU kernel `_scan_kernel_v3`
(spotify_recommender_tpu/ops/pallas/fused_topk.py:1069) computes.

On a CUDA tensor `scan_v3` launches the hand-written kernel
(`csrc/scan_v3.cu` over `csrc/bin_scan.cuh`: w a multiple of 128 up to
KERNEL_MAX_BINS, depth 1-4); on a CPU tensor it runs `scan_v3_plain`,
which sums the same 4F products in the kernel's order: on the card the two
agree bitwise.  Both read only the [hi; lo] rows of `ft` and the [qh, ql]
columns of `q2`.  The helpers below are shared with kernel 4's plain
version (ops/cuda/scan_v2.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.topk import topk_stable

KERNEL_MAX_BINS = 1024    # one bin per thread of a block
KERNEL_MAX_DEPTH = 4


def check_kernel_bins(w: int) -> None:
    """Raise unless the CUDA bin scans take `w` bins."""
    if w % 128 or not 128 <= w <= KERNEL_MAX_BINS:
        raise ValueError(
            f"scan_bins W={w}: the CUDA bin scans take W a multiple of 128 "
            f"up to {KERNEL_MAX_BINS} (one bin per thread of a block)"
        )


def split_plane_dots(q2: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """(B, Np) fp32 dots of [qh, ql] against [hi; lo], summed as the
    kernels sum them.  Each product of two bf16 values is exact in fp32,
    so every step rounds once, as the kernels' FMA does, and the dots are
    bitwise the kernels'."""
    f = q2.shape[1] // 4
    qf, ff = q2[:, :2 * f].float(), ft[:2 * f].float()
    qh, ql, hi, lo = qf[:, :f], qf[:, f:], ff[:f], ff[f:]
    dots = torch.zeros((q2.shape[0], ft.shape[1]), dtype=torch.float32,
                       device=q2.device)
    for j in range(f):
        for a, c in ((qh, hi), (ql, lo), (ql, hi), (qh, lo)):
            dots.addcmul_(a[:, j:j + 1], c[j:j + 1])
    return dots


def bin_structures(
    scores: torch.Tensor, w: int, depth: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bin top-`depth` of (B, Np) scores, bin of column c = c mod w:
    values (B, depth*w) and int32 columns (slot = level*w + bin), empty
    slots (-inf, -1), and each bin's (depth+1)-th best value (B, w)."""
    b, np_ = scores.shape
    nl = np_ // w                                    # columns per bin
    per_bin = scores.view(b, nl, w).transpose(1, 2)  # (B, w, nl), ascending
    vals, pos = torch.sort(per_bin, dim=2, descending=True, stable=True)
    keep = min(depth, nl)
    bins = torch.arange(w, device=scores.device)
    sv = torch.full((b, depth, w), float("-inf"), device=scores.device)
    si = torch.full((b, depth, w), -1, dtype=torch.int32, device=scores.device)
    sv[:, :keep] = vals[:, :, :keep].transpose(1, 2)
    si[:, :keep] = (pos[:, :, :keep] * w + bins[:, None]).transpose(1, 2).int()
    # a -inf (masked) score never enters a bin, as the kernels' strict `>`
    si[:, :keep].masked_fill_(sv[:, :keep] == float("-inf"), -1)
    if nl > depth:
        bound = vals[:, :, depth].clone()   # not a view holding `vals`
    else:
        bound = torch.full((b, w), float("-inf"), device=scores.device)
    return sv.view(b, depth * w), si.view(b, depth * w), bound


def top_slots(
    sv: torch.Tensor, si: torch.Tensor, bound: torch.Tensor, topc: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compact output: top-`topc` slots by value descending, slot
    ascending, and the max bound over the bins (B, 1)."""
    top_v, slot = topk_stable(sv, topc)
    return (top_v, torch.gather(si, 1, slot),
            bound.amax(dim=1, keepdim=True))


def scan_v3_plain(
    q2: torch.Tensor, ft: torch.Tensor, *, w: int, depth: int, topc: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    sv, si, bound = bin_structures(split_plane_dots(q2, ft), w, depth)
    return top_slots(sv, si, bound, topc)


def check_scan_inputs(q2: torch.Tensor, ft: torch.Tensor, w: int,
                      what: str) -> int:
    """Types, shapes and, for the kernels, layout; returns F."""
    if q2.dtype != torch.bfloat16 or ft.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bfloat16, got {q2.dtype}, {ft.dtype}")
    qw = q2.shape[1]
    rows, np_ = ft.shape
    f = qw // 4
    if qw != 4 * f or rows not in (2 * f, 4 * f):
        raise ValueError(f"{what}: q2 {tuple(q2.shape)} vs ft {tuple(ft.shape)}")
    if np_ % w:
        raise ValueError(f"{what}: Np={np_} is not a multiple of w={w}")
    return f


def check_kernel_layout(q2: torch.Tensor, ft: torch.Tensor, w: int,
                        what: str) -> None:
    """What the CUDA bin scans need beyond the plain versions: one CUDA
    device, a W they build, rows they can stage with 16-byte copies."""
    if q2.device.type != "cuda" or q2.device != ft.device:
        raise ValueError(f"{what}: devices {q2.device}, {ft.device}")
    check_kernel_bins(w)
    if (not q2.is_contiguous() or ft.stride(1) != 1 or ft.stride(0) % 8
            or ft.data_ptr() % 16):
        raise ValueError(f"{what}: q2 must be contiguous, ft rows 16-byte aligned")


def scan_v3(
    q2: torch.Tensor, ft: torch.Tensor, *, w: int, depth: int, topc: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    f = check_scan_inputs(q2, ft, w, "scan_v3")
    if not 1 <= topc <= depth * w:
        raise ValueError(f"scan_v3: topc={topc} outside 1..depth*w={depth * w}")
    if q2.device.type == "cpu" and ft.device.type == "cpu":
        return scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc)
    check_kernel_layout(q2, ft, w, "scan_v3")
    if not 1 <= depth <= KERNEL_MAX_DEPTH:
        raise ValueError(
            f"the CUDA scan supports depth 1-{KERNEL_MAX_DEPTH}, got {depth}")
    b = q2.shape[0]
    ov = torch.empty((b, topc), dtype=torch.float32, device=q2.device)
    oi = torch.empty((b, topc), dtype=torch.int32, device=q2.device)
    ob = torch.empty((b, 1), dtype=torch.float32, device=q2.device)
    with torch.cuda.device(q2.device):
        err = _build.library().srt_scan_v3(
            q2.data_ptr(), b, f, ft.data_ptr(), ft.stride(0), ft.shape[1], w,
            depth, topc, ov.data_ptr(), oi.data_ptr(), ob.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, f"scan_v3 (w={w}, depth={depth}, F={f})")
    scan_v3.launches += 1
    return ov, oi, ob


scan_v3.launches = 0   # kernel launches (CUDA tensors only)
