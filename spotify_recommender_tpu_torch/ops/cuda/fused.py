"""Kernel 3: fused cosine score + top-k over an fp32, bf16 or bf16x2
catalog.

`fused_topk(queries, q_norms, features_t, norms, excl, valid, k=, exact=)`
scores a query batch against the transposed catalog and returns each
query's top-k:

    queries     (B, Fq) contiguous, of features_t's dtype (unit rows when
                exact=False)
    q_norms     (B,) f32, the RAW query norms (similarity.row_norms)
    features_t  (Fc, Np) f32 or bf16, any strides (a `.t()` view of
                row-major rows works in place)
    norms       (Np,) f32, zero on pad columns
    excl        (B,) int64 column to skip per query, -1 = none
    valid       columns >= valid are padding
    out         (B, k) f32 descending, lowest column first on equal values,
                and (B, k) int64 columns; unfilled slots are (-inf, -1)

Storage: fp32 (Fq = Fc), bf16 (Fq = Fc, prenormalized only), or bf16x2:
queries [qh, ql, ql, qh] (Fq = 4F) against planes [hi; lo] (Fc = 2F) or
[hi; lo; hi; lo] (Fc = 4F), catalog row d mod Fc for query column d.
Score: `guard = qn*cn > eps`; exact `guard ? clamp(dot / (qn*cn), -1, 1)
: 0`, prenormalized `guard ? clamp(dot, -1, 1) : 0`, with `dot` summed
over ascending d in fp32, one rounding per multiply and per add (a
product of two bf16 values is exact, as on the TPU's MXU).  This is what
the TPU kernel `_fused_kernel` (spotify_recommender_tpu/ops/pallas/
fused_topk.py:52) computes.

On a CUDA tensor `fused_topk` launches the hand-written kernel
(`csrc/fused_topk.cu`); on a CPU tensor it runs `fused_topk_plain`, the
same arithmetic in torch ops, chunked over the catalog.  On the card the
two agree bitwise.  k is at most KERNEL_MAX_K on every device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from spotify_recommender_tpu_torch.core.config import COSINE_EPS
from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import device_sms
from spotify_recommender_tpu_torch.ops.topk import merge_topk, topk_stable

KERNEL_MAX_K = 128        # 4 list slots per lane of a warp (csrc/fused_topk.cu)
_TQ = 16                  # queries per block
_TC = 128                 # columns per tile
_MAX_SPLITS = 128
_MIN_SPLIT_COLS = 1024    # a split below this costs more in its merge
_CPU_BLOCKS_PER_SM = 4    # resident blocks per SM assumed without a card
_TINY_T = 2.0**-60        # below it the filter lets every column through
_MARGIN = 2.0**-22        # the exact filter's relative margin
PLAIN_CHUNK_ELEMS = 1 << 26   # (B x columns) per chunk of the plain version


def _check_args(queries, q_norms, features_t, norms, excl, k, exact) -> None:
    bf16 = features_t.dtype == torch.bfloat16
    if (features_t.dtype not in (torch.float32, torch.bfloat16)
            or queries.dtype != features_t.dtype
            or q_norms.dtype != torch.float32 or norms.dtype != torch.float32
            or excl.dtype != torch.int64):
        raise TypeError(
            "fused_topk takes float32 or bfloat16 queries and catalog of one "
            "dtype, float32 norms and int64 excl, got "
            f"{[t.dtype for t in (queries, q_norms, features_t, norms, excl)]}"
        )
    if bf16 and exact:
        raise ValueError("fused_topk: bfloat16 storage takes prenormalized "
                         "rows (exact=False)")
    b, fq = queries.shape
    if (q_norms.shape != (b,) or excl.shape != (b,) or features_t.dim() != 2
            or fq not in ((features_t.shape[0], 2 * features_t.shape[0])
                          if bf16 else (features_t.shape[0],))
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
    b, fq = queries.shape
    fc, np_ = features_t.shape
    dev = queries.device
    queries = queries.float()      # bf16 values are exact in fp32
    best_s = torch.full((b, k), float("-inf"), device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    step = max(1, PLAIN_CHUNK_ELEMS // max(b, 1))
    for off in range(0, np_, step):
        end = min(off + step, np_)
        ft = features_t[:, off:end].float()
        # the kernel's chain: one rounding per multiply and per add; query
        # column d meets catalog row d mod Fc
        dots = queries[:, 0:1] * ft[0:1]
        for d in range(1, fq):
            dots = dots + queries[:, d:d + 1] * ft[d % fc:d % fc + 1]
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


def filter_pass(dot: torch.Tensor, qn: torch.Tensor, cn: torch.Tensor,
                t: torch.Tensor, exact: bool = True,
                floor: torch.Tensor = None) -> torch.Tensor:
    """The kernel's filter (`filter_bound` and the compare in
    csrc/fused_topk.cu), elementwise over fp32 tensors: False only where
    the score (the guard, the clamp and, exact, rn(dot / rn(qn * cn))) of a
    scored column cannot be both above the warp's k-th best t and at or
    above the block's floor (-inf if None).  Only where it is True does the
    kernel compute that score (exact: divide).  With u = max(t, floor), the
    bound is exact rd(rd(u * qn) * (1 - 2^-22)), prenormalized u, or +-inf
    as the kernel's notes say; the column passes if `dot >= rn(bound *
    cn)`, a zero norm counted as FLT_MIN, or prenormalized `dot >= bound`."""
    u = t if floor is None else torch.maximum(t, floor)
    bound = _mul_rd(_mul_rd(u, qn.double()), 1.0 - _MARGIN) if exact else u
    inf = torch.full_like(t, float("inf"))
    bound = torch.where((t >= 1.0) | ((qn == 0) & (t >= 0)), inf,
                        torch.where(~(u >= _TINY_T), -inf, bound))
    if not exact:
        return dot >= bound
    return dot >= bound * torch.where(cn > 0, cn, torch.finfo(torch.float32).tiny)


def _mul_rd(a: torch.Tensor, b) -> torch.Tensor:
    """fp32 a * b rounded toward -inf (CUDA's __fmul_rd): the product is
    exact in float64, then rounded down to fp32."""
    v = a.double() * b
    r = v.float()
    return torch.where(r.double() > v,
                       torch.nextafter(r, torch.tensor(float("-inf"))), r)


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, fq: int, k: int, exact: bool, bf16: bool) -> int:
    """Blocks of the kernel instance for these arguments that one SM of
    CUDA device `index` holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().srt_fused_blocks_per_sm(
            fq, k, int(exact), int(bf16), ctypes.addressof(out))
    _build.check(err, "fused_topk occupancy")
    return out.value


def _splits(b: int, np_: int, device: torch.device, *, fq: int = 12,
            k: int = 10, exact: bool = True,
            bf16: bool = False) -> Tuple[int, int]:
    """(number of catalog splits, columns per split): as many splits as let
    the (query tiles x splits) blocks run in one wave of the card's
    resident blocks (the H100's 132 SMs for a CPU device), each split at
    least _MIN_SPLIT_COLS wide."""
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        per_sm = _occupancy(index, fq, k, bool(exact), bool(bf16))
    else:
        per_sm = _CPU_BLOCKS_PER_SM
    slots = device_sms(device) * per_sm
    tiles = -(-b // _TQ)
    nsplit = max(1, min(slots // tiles, _MAX_SPLITS,
                        -(-np_ // _MIN_SPLIT_COLS)))
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
    _check_args(queries, q_norms, features_t, norms, excl, k, exact)
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
    b, fq = queries.shape
    fc, np_ = features_t.shape
    if np_ >= 2**31 - 1:
        raise ValueError(f"fused_topk: {np_} columns exceed int32 indices")
    ov = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return ov, oi
    bf16 = features_t.dtype == torch.bfloat16
    nsplit, split_cols = _splits(b, np_, dev, fq=fq, k=k, exact=exact,
                                 bf16=bf16)
    pv = torch.empty((b, nsplit, k), dtype=torch.float32, device=dev)
    pc = torch.empty((b, nsplit, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().srt_fused_topk(
            queries.data_ptr(), q_norms.data_ptr(), features_t.data_ptr(),
            features_t.stride(0), features_t.stride(1), norms.data_ptr(),
            excl.data_ptr(), b, fq, fc, np_, int(valid), k, int(bool(exact)),
            int(bf16), ctypes.c_float(eps),
            nsplit, split_cols, pv.data_ptr(),
            pc.data_ptr(), ov.data_ptr(), oi.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fused_topk")
    fused_topk.launches += 1
    return ov, oi


fused_topk.launches = 0   # kernel launches (CUDA tensors only)
