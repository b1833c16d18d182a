"""Kernel 4 of the certified path: the v2 bin scan, with the cosine
epilogue and the masks inside.

`scan_v2(q2, qn, ft, norms, excl, valid, w=, eps=, topc=)` scans
split-plane unit queries against the split-plane prenormalized catalog:

    q2     (B, 4F) bf16  [qh, ql, ql, qh]
    qn     (B,) f32      RAW query norms (similarity.row_norms)
    ft     (P*F, Np) bf16 catalog planes [hi; lo] or [hi; lo; hi; lo];
                         Np a multiple of w
    norms  (Np,) f32     RAW catalog norms, zero on pad columns
    excl   (B,) int64    column to mask per query, -1 = none
    valid                columns >= valid are padding

score = `qn*cn > eps ? clamp(dot, -1, 1) : 0`, then -inf on columns >=
valid and on the query's excluded column.  Bin of column c: c mod w; each
bin keeps its top-3 (value, column) with strict `>` (lowest column wins
ties; a -inf score never enters) and its 4th-best value.  Output:

    topc > 0   (B, topc) f32 values, (B, topc) int32 columns: the top-topc
               of the 3w slots (slot = level*w + bin) by value descending,
               slot ascending; (B, 1) f32 bound, the max 4th-best
    topc = 0   the full structures: (B, 3w) values, (B, 3w) columns,
               (B, w) per-bin bounds

This is what the TPU kernel `_scan_kernel` (spotify_recommender_tpu/ops/
pallas/fused_topk.py:834) computes.  On a CUDA tensor `scan_v2` launches
hand-written kernels on kernel 1's two routes (ops/cuda/scan_v3.py
`scan_route`), with the epilogue inside the scan: "flat" (`csrc/scan_v2.cu`
over `csrc/bin_scan.cuh`: w up to 1024, rows that fit its tile, the
merge's argmax rounds) or "wide" (`csrc/scan_wide.cu`: any w, row chunks
for any F, the full structures or `srt_bin_select`'s exact top-topc), each
kernel 1's catalog-split scan and merge, any w a multiple of 128.  On a
CPU tensor it runs `scan_v2_plain`, which sums the same 4F products in the
kernel's order: on the card the two agree bitwise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (
    bin_structures,
    check_kernel_layout,
    check_scan_inputs,
    row_ptrs,
    scan_plan,
    scan_scratch,
    split_plane_dots,
    top_slots,
)

DEPTH = 3     # the v2 scan's fixed bin depth


def scan_v2_plain(
    q2: torch.Tensor,
    qn: torch.Tensor,
    ft: torch.Tensor,
    norms: torch.Tensor,
    excl: torch.Tensor,
    valid: int,
    *,
    w: int,
    eps: float,
    topc: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dots = split_plane_dots(q2, ft)
    den = qn[:, None] * norms[None, :]
    scores = torch.where(den > eps, torch.clamp(dots, -1.0, 1.0), 0.0)
    cols = torch.arange(ft.shape[1], device=q2.device)[None, :]
    bad = (cols >= valid) | (cols == excl[:, None])
    sv, si, bound = bin_structures(scores.masked_fill(bad, float("-inf")),
                                   w, DEPTH)
    if topc == 0:
        return sv, si, bound
    return top_slots(sv, si, bound, topc)


def scan_v2(
    q2: torch.Tensor,
    qn: torch.Tensor,
    ft: torch.Tensor,
    norms: torch.Tensor,
    excl: torch.Tensor,
    valid: int,
    *,
    w: int,
    eps: float,
    topc: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    f = check_scan_inputs(q2, ft, w, "scan_v2")
    b, np_ = q2.shape[0], ft.shape[1]
    if (qn.dtype != torch.float32 or norms.dtype != torch.float32
            or excl.dtype != torch.int64):
        raise TypeError(
            f"scan_v2 takes float32 norms and int64 excl, got {qn.dtype}, "
            f"{norms.dtype}, {excl.dtype}"
        )
    if qn.shape != (b,) or excl.shape != (b,) or norms.shape != (np_,):
        raise ValueError(
            f"scan_v2: qn {tuple(qn.shape)}, excl {tuple(excl.shape)}, norms "
            f"{tuple(norms.shape)} for B={b}, Np={np_}"
        )
    if not 0 <= topc <= DEPTH * w:
        raise ValueError(f"scan_v2: topc={topc} outside 0..3w={DEPTH * w}")
    tensors = (q2, qn, ft, norms, excl)
    if all(t.device.type == "cpu" for t in tensors):
        return scan_v2_plain(q2, qn, ft, norms, excl, valid, w=w, eps=eps,
                             topc=topc)
    check_kernel_layout(q2, ft, w, "scan_v2")
    if any(t.device != q2.device for t in tensors):
        raise ValueError(f"scan_v2: devices {[t.device for t in tensors]}")
    if not (qn.is_contiguous() and norms.is_contiguous()
            and excl.is_contiguous()):
        raise ValueError("scan_v2: qn, norms and excl must be contiguous")
    width = topc if topc else DEPTH * w
    ov = torch.empty((b, width), dtype=torch.float32, device=q2.device)
    oi = torch.empty((b, width), dtype=torch.int32, device=q2.device)
    ob = torch.empty((b, 1 if topc else w), dtype=torch.float32,
                     device=q2.device)
    route, chunks = scan_plan(b, np_, f, w, DEPTH, topc, q2.device)
    lib = _build.library()
    with torch.cuda.device(q2.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0, m, slice_, slices in chunks:
            ptrs = row_ptrs(c0, q2, qn, excl, ov, oi, ob)
            wv, wi, wb = scan_scratch(slices, m, w, DEPTH, q2.device)
            if route == "flat":
                err = lib.srt_scan_v2(
                    ptrs[0], ptrs[1], m, f, ft.data_ptr(), ft.stride(0),
                    norms.data_ptr(), np_, ptrs[2], int(valid),
                    ctypes.c_float(eps), w, topc, slice_, wv.data_ptr(),
                    wi.data_ptr(), wb.data_ptr(), *ptrs[3:], stream)
            else:
                # the merged full structures: the outputs (topc = 0) or the
                # scratch's slice 0, then the exact top-topc
                full = (ptrs[3:] if topc == 0 else
                        [wv.data_ptr(), wi.data_ptr(), wb.data_ptr()])
                err = lib.srt_scan_wide(
                    ptrs[0], ptrs[1], m, f, ft.data_ptr(), ft.stride(0),
                    norms.data_ptr(), np_, np_, ptrs[2], int(valid),
                    ctypes.c_float(eps), 1, w, DEPTH, slice_, wv.data_ptr(),
                    wi.data_ptr(), wb.data_ptr(), *full, stream)
                if topc and not err:
                    err = lib.srt_bin_select(
                        wv.data_ptr(), wi.data_ptr(), wb.data_ptr(), m, w,
                        DEPTH, topc, *ptrs[3:], stream)
            if err:
                _build.check(err, f"scan_v2 {route} (w={w}, F={f}, "
                                  f"topc={topc}, slice={slice_})")
            scan_v2.launches += 1
    return ov, oi, ob


scan_v2.launches = 0   # launches, one per batch chunk (CUDA tensors only)
