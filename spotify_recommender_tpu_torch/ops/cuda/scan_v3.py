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
(`csrc/scan_v3.cu`, w = 128 and depth 1-4 only); on a CPU tensor it runs
`scan_v3_plain`, which sums the same 4F products in the kernel's order:
on the card the two agree bitwise.  Both read only the [hi; lo] rows of
`ft` and the [qh, ql] columns of `q2`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.topk import topk_stable

KERNEL_BINS = 128
KERNEL_MAX_DEPTH = 4


def scan_v3_plain(
    q2: torch.Tensor, ft: torch.Tensor, *, w: int, depth: int, topc: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b = q2.shape[0]
    np_ = ft.shape[1]
    f = q2.shape[1] // 4
    qf, ff = q2[:, :2 * f].float(), ft[:2 * f].float()
    qh, ql, hi, lo = qf[:, :f], qf[:, f:], ff[:f], ff[f:]
    # the kernel's 4F products in the kernel's order; each product of two
    # bf16 values is exact in fp32, so every step rounds once, as the
    # kernel's FMA does, and the dots are bitwise the kernel's
    dots = torch.zeros((b, np_), dtype=torch.float32, device=q2.device)
    for j in range(f):
        for a, c in ((qh, hi), (ql, lo), (ql, hi), (qh, lo)):
            dots.addcmul_(a[:, j:j + 1], c[j:j + 1])
    nl = np_ // w                                   # columns per bin
    per_bin = dots.view(b, nl, w).transpose(1, 2)   # (B, w, nl), ascending
    vals, pos = torch.sort(per_bin, dim=2, descending=True, stable=True)
    keep = min(depth, nl)
    bins = torch.arange(w, device=q2.device)
    sv = torch.full((b, depth, w), float("-inf"), device=q2.device)
    si = torch.full((b, depth, w), -1, dtype=torch.int32, device=q2.device)
    sv[:, :keep] = vals[:, :, :keep].transpose(1, 2)
    si[:, :keep] = (pos[:, :, :keep] * w + bins[:, None]).transpose(1, 2).int()
    if nl > depth:
        bound = vals[:, :, depth].amax(dim=1, keepdim=True)
    else:
        bound = torch.full((b, 1), float("-inf"), device=q2.device)
    top_v, slot = topk_stable(sv.reshape(b, depth * w), topc)
    return top_v, torch.gather(si.reshape(b, depth * w), 1, slot), bound


def scan_v3(
    q2: torch.Tensor, ft: torch.Tensor, *, w: int, depth: int, topc: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q2.dtype != torch.bfloat16 or ft.dtype != torch.bfloat16:
        raise TypeError(f"scan_v3 takes bfloat16, got {q2.dtype}, {ft.dtype}")
    b, qw = q2.shape
    rows, np_ = ft.shape
    f = qw // 4
    if qw != 4 * f or rows not in (2 * f, 4 * f):
        raise ValueError(f"scan_v3: q2 {tuple(q2.shape)} vs ft {tuple(ft.shape)}")
    if np_ % w or not 1 <= topc <= depth * w:
        raise ValueError(f"scan_v3: Np={np_}, w={w}, depth={depth}, topc={topc}")
    if q2.device.type == "cpu" and ft.device.type == "cpu":
        return scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc)
    if q2.device.type != "cuda" or q2.device != ft.device:
        raise ValueError(f"scan_v3: devices {q2.device}, {ft.device}")
    if w != KERNEL_BINS or not 1 <= depth <= KERNEL_MAX_DEPTH:
        raise ValueError(
            f"the CUDA scan supports w={KERNEL_BINS} and depth 1-"
            f"{KERNEL_MAX_DEPTH}, got w={w}, depth={depth}"
        )
    # the kernel stages catalog tiles with 16-byte copies
    if (not q2.is_contiguous() or ft.stride(1) != 1 or ft.stride(0) % 8
            or ft.data_ptr() % 16):
        raise ValueError("scan_v3: q2 must be contiguous, ft rows 16-byte aligned")
    ov = torch.empty((b, topc), dtype=torch.float32, device=q2.device)
    oi = torch.empty((b, topc), dtype=torch.int32, device=q2.device)
    ob = torch.empty((b, 1), dtype=torch.float32, device=q2.device)
    with torch.cuda.device(q2.device):
        err = _build.library().srt_scan_v3(
            q2.data_ptr(), b, f, ft.data_ptr(), ft.stride(0), np_, depth,
            topc, ov.data_ptr(), oi.data_ptr(), ob.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "scan_v3")
    scan_v3.launches += 1
    return ov, oi, ob


scan_v3.launches = 0   # kernel launches (CUDA tensors only)
