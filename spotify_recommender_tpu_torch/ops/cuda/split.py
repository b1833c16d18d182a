"""Kernel 2: the serving paths' query prologue and the bf16x2 split.

`query_prologue(queries, qn)` turns raw fp32 queries (B, F) and their norms
(B,) into the bin scans' operand q2 (B, 4F) bf16 in one launch:

    u = queries / max(qn, 1e-30)          (IEEE division; a NaN norm stays)
    hi = bf16(u), lo = bf16(u - hi)       (round to nearest even)
    q2 = [hi, lo, lo, hi]                 against the catalog's [hi; lo]

It replaces the TPU kernel `_split_bf16x2`
(spotify_recommender_tpu/ops/pallas/fused_topk.py:244) with the
normalization and concatenation around its query calls (:450, :704,
:1451).  `split_bf16x2(x)` is the split alone (hi, lo), which the sharded
catalog's device layout build runs on its unit rows.

On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/split_bf16x2.cu`) or raises; on a CPU tensor it runs its plain
version, the same arithmetic in torch ops.  Kernel and plain version are
bitwise equal.  `launches` counts kernel launches (CUDA tensors only).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from spotify_recommender_tpu_torch.ops.cuda import _build


def split_bf16x2_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def split_bf16x2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, d) fp32 -> two (m, d) bf16 tensors on x's device."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x2 takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return split_bf16x2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"split_bf16x2: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("split_bf16x2 takes a contiguous tensor")
    hi = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lo = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().srt_split_bf16x2(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "split_bf16x2")
    split_bf16x2.launches += 1
    return hi, lo


split_bf16x2.launches = 0   # kernel launches (CUDA tensors only)


def query_prologue_plain(queries: torch.Tensor, qn: torch.Tensor) -> torch.Tensor:
    """The prologue in torch ops: unit queries, their split, [hi, lo, lo, hi]."""
    qh, ql = split_bf16x2_plain(queries / qn.clamp_min(1e-30)[:, None])
    return torch.cat([qh, ql, ql, qh], dim=1)


@functools.lru_cache(maxsize=None)
def _prologue_entry():
    """The loaded C entry point (the library is built on first call)."""
    return _build.library().srt_query_prologue


def query_prologue(queries: torch.Tensor, qn: torch.Tensor) -> torch.Tensor:
    """(B, F) fp32 raw queries and their (B,) fp32 norms -> (B, 4F) bf16
    [hi, lo, lo, hi] of the unit queries, on the queries' device."""
    if queries.dtype != torch.float32 or qn.dtype != torch.float32:
        raise TypeError(f"query_prologue takes float32, got {queries.dtype} "
                        f"queries and {qn.dtype} norms")
    if queries.dim() != 2 or qn.shape != queries.shape[:1]:
        raise ValueError(f"query_prologue takes (B, F) queries and (B,) "
                         f"norms, got {tuple(queries.shape)} and "
                         f"{tuple(qn.shape)}")
    dev = queries.device
    if qn.device != dev:
        raise ValueError(f"query_prologue: queries on {dev}, norms on "
                         f"{qn.device}")
    if dev.type == "cpu":
        return query_prologue_plain(queries, qn)
    if dev.type != "cuda":
        raise ValueError(f"query_prologue: unsupported device {dev}")
    if not (queries.is_contiguous() and qn.is_contiguous()):
        raise ValueError("query_prologue takes contiguous tensors")
    b, f = queries.shape
    q2 = torch.empty((b, 4 * f), dtype=torch.bfloat16, device=dev)
    # no device context and no Stream object per call: the raw stream of
    # the tensors' device, and a device switch only where the caller's
    # current device is another
    args = (queries.data_ptr(), qn.data_ptr(), q2.data_ptr(), b, f,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = _prologue_entry()(*args)
    else:
        with torch.cuda.device(dev):
            err = _prologue_entry()(*args)
    _build.check(err, "query_prologue")
    query_prologue.launches += 1
    return q2


query_prologue.launches = 0   # kernel launches (CUDA tensors only)
