"""Kernel 3: fused exact cosine score + top-k over an fp32 catalog.

`fused_topk(queries, q_norms, features_t, norms, excl, valid, k=, exact=)`
scores a query batch against the transposed catalog and returns each
query's top-k:

    queries     (B, F) f32 contiguous (unit rows when exact=False)
    q_norms     (B,) f32, the RAW query norms (similarity.row_norms)
    features_t  (F, Np) f32, any strides (a `.t()` view of row-major
                rows works in place)
    norms       (Np,) f32, zero on pad columns
    excl        (B,) int64 column to skip per query, -1 = none
    valid       columns >= valid are padding
    out         (B, k) f32 descending, lowest column first on equal values,
                and (B, k) int64 columns; unfilled slots are (-inf, -1)

Score: `guard = qn*cn > eps`; exact `guard ? clamp(dot / (qn*cn), -1, 1)
: 0`, prenormalized `guard ? clamp(dot, -1, 1) : 0`, with `dot` summed
over ascending d, one rounding per multiply and per add.  This is what the
TPU kernel `_fused_kernel` (spotify_recommender_tpu/ops/pallas/
fused_topk.py:52) computes.

On a CUDA tensor `fused_topk` launches the hand-written kernel
(`csrc/fused_topk.cu`); on a CPU tensor it runs `fused_topk_plain`, the
same arithmetic in torch ops, chunked over the catalog.  On the card the
two agree bitwise.  k is at most KERNEL_MAX_K on every device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from spotify_recommender_tpu_torch.core.config import COSINE_EPS
from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.topk import merge_topk, topk_stable

KERNEL_MAX_K = 128        # 4 list slots per lane of a warp (csrc/fused_topk.cu)
_TQ = 16                  # queries per block
_TC = 128                 # columns per tile
_MAX_SPLITS = 128
_MIN_SPLIT_COLS = 1024    # a split below this costs more in its merge
_BLOCKS_PER_SM = 4        # resident blocks of 128 threads the grid aims at
PLAIN_CHUNK_ELEMS = 1 << 26   # (B x columns) per chunk of the plain version


def _check_args(queries, q_norms, features_t, norms, excl, k) -> None:
    tensors = (queries, q_norms, features_t, norms)
    if any(t.dtype != torch.float32 for t in tensors) or excl.dtype != torch.int64:
        raise TypeError(
            "fused_topk takes float32 queries, norms and catalog and int64 "
            f"excl, got {[t.dtype for t in tensors]}, {excl.dtype}"
        )
    b, f = queries.shape
    if (q_norms.shape != (b,) or excl.shape != (b,) or features_t.dim() != 2
            or features_t.shape[0] != f
            or norms.shape != (features_t.shape[1],)):
        raise ValueError(
            f"fused_topk: queries {tuple(queries.shape)}, q_norms "
            f"{tuple(q_norms.shape)}, features_t {tuple(features_t.shape)}, "
            f"norms {tuple(norms.shape)}, excl {tuple(excl.shape)}"
        )
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(
            f"fused_topk supports 1 <= k <= {KERNEL_MAX_K}, got k={k}"
        )


def fused_topk_plain(
    queries: torch.Tensor,
    q_norms: torch.Tensor,
    features_t: torch.Tensor,
    norms: torch.Tensor,
    excl: torch.Tensor,
    valid: int,
    *,
    k: int,
    exact: bool,
    eps: float = COSINE_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, f = queries.shape
    np_ = features_t.shape[1]
    dev = queries.device
    best_s = torch.full((b, k), float("-inf"), device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    step = max(1, PLAIN_CHUNK_ELEMS // max(b, 1))
    for off in range(0, np_, step):
        end = min(off + step, np_)
        ft = features_t[:, off:end]
        # the kernel's chain: one rounding per multiply and per add
        dots = queries[:, 0:1] * ft[0:1]
        for d in range(1, f):
            dots = dots + queries[:, d:d + 1] * ft[d:d + 1]
        den = q_norms[:, None] * norms[None, off:end]
        guard = den > eps
        x = dots / torch.where(guard, den, 1.0) if exact else dots
        scores = torch.where(guard, torch.clamp(x, -1.0, 1.0), 0.0)
        cols = torch.arange(off, end, device=dev)[None, :]
        bad = (cols >= valid) | (cols == excl[:, None])
        scores = scores.masked_fill(bad, float("-inf"))
        ch_s, ch_pos = topk_stable(scores, min(k, end - off))
        # ascending chunks + merge_topk favouring the earlier list keep the
        # lowest column first on equal values
        best_s, best_i = merge_topk(best_s, best_i, ch_s, ch_pos + off, k)
    return best_s, best_i.masked_fill(best_s == float("-inf"), -1)


def _splits(b: int, np_: int, device: torch.device) -> Tuple[int, int]:
    """(number of catalog splits, columns per split): enough blocks to fill
    the card at any B, each split at least _MIN_SPLIT_COLS wide."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-b // _TQ)
    want = -(-_BLOCKS_PER_SM * sms // tiles)
    nsplit = max(1, min(want, _MAX_SPLITS, -(-np_ // _MIN_SPLIT_COLS)))
    cols = -(-max(np_, 1) // nsplit)
    cols = -(-cols // _TC) * _TC
    return -(-max(np_, 1) // cols), cols


def fused_topk(
    queries: torch.Tensor,
    q_norms: torch.Tensor,
    features_t: torch.Tensor,
    norms: torch.Tensor,
    excl: torch.Tensor,
    valid: int,
    *,
    k: int,
    exact: bool,
    eps: float = COSINE_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_args(queries, q_norms, features_t, norms, excl, k)
    tensors = (queries, q_norms, features_t, norms, excl)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_topk_plain(queries, q_norms, features_t, norms, excl,
                                valid, k=k, exact=exact, eps=eps)
    dev = queries.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_topk: devices {[t.device for t in tensors]}")
    if not (queries.is_contiguous() and q_norms.is_contiguous()
            and norms.is_contiguous() and excl.is_contiguous()):
        raise ValueError("fused_topk: queries, norms and excl must be contiguous")
    b, f = queries.shape
    np_ = features_t.shape[1]
    if np_ >= 2**31 - 1:
        raise ValueError(f"fused_topk: {np_} columns exceed int32 indices")
    ov = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return ov, oi
    nsplit, split_cols = _splits(b, np_, dev)
    pv = torch.empty((b, nsplit, k), dtype=torch.float32, device=dev)
    pc = torch.empty((b, nsplit, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().srt_fused_topk(
            queries.data_ptr(), q_norms.data_ptr(), features_t.data_ptr(),
            features_t.stride(0), features_t.stride(1), norms.data_ptr(),
            excl.data_ptr(), b, f, np_, int(valid), k, int(bool(exact)),
            ctypes.c_float(eps), nsplit, split_cols, pv.data_ptr(),
            pc.data_ptr(), ov.data_ptr(), oi.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fused_topk")
    fused_topk.launches += 1
    return ov, oi


fused_topk.launches = 0   # kernel launches (CUDA tensors only)
