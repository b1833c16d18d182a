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

On a CUDA tensor `fused_topk` launches the hand-written kernels
(`csrc/fused_topk.cu`): by `fused_route(k, B)` the warp-list kernel (k up
to a limit of B, at most SMALL_K_MAX) or `fused_topk_large`'s candidate
buffers and radix select (any k >= 1; `emulate_large_k` is its selection
in torch), each with the
merge both share.  The plans (`query_tile`, `tile`, `_splits`,
`_large_plan`, `walk_chunks`) are plain Python, so the CPU tests reach
them.  On a CPU tensor it runs `fused_topk_plain`, the same arithmetic in
torch ops, chunked over the catalog.  On the card the kernels and the
plain version agree bitwise.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import COSINE_EPS
from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (
    SCRATCH_CAP,
    device_sms,
    row_ptrs,
)
from spotify_recommender_tpu_torch.ops.topk import merge_topk, topk_stable

SMALL_K_MAX = 64          # the warp lists' largest k: 2 slots per lane
_TC = 128                 # columns per group: one per thread of a block
_MIN_SPLIT_COLS = 1024    # a split below this costs more in its merge
_CPU_BLOCKS_PER_SM = 4    # resident blocks per SM assumed without a card
# a batch of at most SMALL_BATCH queries takes the 4-query tile on both
# paths (csrc/fused_topk.cu): fewer registers, four blocks an SM and no
# slots past B.  Measured with tools/fused_k_sweep.py (exact fp32, 1M x
# 12, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, kernel 3), 16 | 4 queries
# a tile, ms, lists at k = 10 and 64, large at k = 1000:
#   B = 8     0.1948 | 0.1688 (route, k = 10)
#   B = 32    0.3336 | 0.2664, 0.7963 | 0.4386; 2.0403 | 0.9865
#   B = 128   0.6078 | 0.6913, 1.2888 | 0.9647; 2.9150 | 1.9545
#   B = 256   0.9250 | 1.2584, 1.7410 | 1.5972; 4.2322 | 2.9693
#   B = 1024  2.4837 | 4.5289, 3.8184 | 6.8459; 9.2338 | 7.5191
# The rule gives up the lists at B = 128, k = 10 and the large-k path
# from B = 256 (a tile by path and k; ROADMAP 2b)
SMALL_BATCH = 128
# the route (`fused_route`): the warp lists at k up to the limit of the
# largest B of this table at or below the batch, else the large-k path;
# both return the same bits, so the route changes speed only.  Measured
# with tools/fused_k_sweep.py --paths lists,large (exact fp32, 1M x 12,
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md, kernel 3), lists | large ms:
#   B = 1     k = 48 0.1506 | 0.1580, 64 0.1659 | 0.1939
#   B = 4     k = 24 0.1668 | 0.1690, 32 0.1936 | 0.1790
#   B = 12    k = 32 0.2212 | 0.2503, 40 0.2733 | 0.2598
#   B = 32    k = 48 0.3949 | 0.3991, 64 0.4386 | 0.4054
#   B = 256   k = 48 1.5288 | 1.5974, 64 1.7450 | 1.7563
#   B = 1024  k = 64 3.8184 | 4.0877; 100 4.923 | 4.539
# Of the measured points it gives up B = 2, k = 64 (0.2057 | 0.2150) and
# B = 16, k = 40 (0.2864 | 0.2954), and ten within 1.6 %.  Above k = 64
# the large-k path won at every B, so the lists stop there
LISTS_MAX_K = ((1, 64), (2, 24), (8, 32), (17, 48), (256, 64))
# the large-k path (csrc/fused_topk.cu, "the large k"): its scratch, chunk x
# nsplit x cap keys of 8 bytes, takes at most SCRATCH_CAP, or the buffers
# of _LARGE_MIN_BLOCKS_PER_SM blocks on every SM where they need more, and
# never more than LARGE_SCRATCH_CEILING (one block's buffers, TQ queries x
# cap keys, where they alone need more: k above two million); a split
# spans at least _LARGE_SPLIT_PER_K x k columns, so that the merge's input
# (nsplit x k keys a query) stays near a split's width.  The blocks per SM
# and the split width were chosen on the card with tools/fused_k_sweep.py
# (PERF.md, kernel 3): 2 blocks an SM left B = 1024 at k = 1000
# latency-bound (13.0 ms against 9.6 at 4, 8.9 at 6); at B = 1 splits of
# 8k columns beat 4k and 16k at k = 1000.  The ceiling keeps four blocks
# an SM up to k = 4096 (512 MiB there) and bounds the scratch above it
LARGE_SCRATCH_CEILING = 512 << 20
_LARGE_MIN_BLOCKS_PER_SM = 4
_LARGE_SPLIT_PER_K = 8
_MAX_GRID_Y = 65535
_TINY_T = 2.0**-60        # below it the filter lets every column through
_MARGIN = 2.0**-22        # the exact filter's relative margin
PLAIN_CHUNK_ELEMS = 1 << 26   # (B x columns) per chunk of the plain version


def query_tile(b: int) -> int:
    """Queries per block of either partial kernel for a batch of b: 4 up to
    SMALL_BATCH, else 16."""
    return 4 if b <= SMALL_BATCH else 16


def tile(large: bool, k: int, tq: int) -> int:
    """U, the 128-column groups a thread scores per chunk, of the partial
    kernel instance for (path, k, query tile): csrc/fused_topk.cu's
    `tile()`, which `srt_fused_tiling` reads back on the card."""
    return 2 if large and tq == 16 else 4


def fused_route(k: int, b: int) -> str:
    """"lists" (the warp-list kernel, `fused_topk`'s own) or "large" (the
    large-k path, `fused_topk_large`) for k and a batch of b queries, by
    LISTS_MAX_K."""
    top = next(lim for least, lim in reversed(LISTS_MAX_K)
               if least <= max(b, 1))
    return "lists" if k <= top else "large"


def walk_chunks(np_: int, split_cols: int, u: int, split: int):
    """The chunks a partial kernel's block walks in split `split`: (first
    column, end column, groups) of each, in order; U x 128 columns each,
    the last cut at the split's end (a split of columns [split *
    split_cols, min(np, (split + 1) * split_cols)))."""
    begin = split * split_cols
    end = min(np_, begin + split_cols)
    out = []
    for c0 in range(begin, end, u * _TC):
        c1 = min(end, c0 + u * _TC)
        out.append((c0, c1, -(-(c1 - c0) // _TC)))
    return out


def copy_width(features_t: torch.Tensor) -> int:
    """Bytes of each copy that stages the catalog in shared memory: 16, 8
    or 4 where its columns are contiguous and its base address and row
    stride are multiples of it; else 0, one value a copy (a row-major
    window read through `.t()`, a bf16 slice at an odd column)."""
    fc, np_ = features_t.shape
    if features_t.stride(1) != 1 and np_ > 1:
        return 0
    es = features_t.element_size()
    align = features_t.data_ptr()
    if fc > 1:
        align |= features_t.stride(0) * es
    for w in (16, 8, 4):
        if align % w == 0:
            return w
    return 0


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
    if k < 1:
        raise ValueError(f"fused_topk takes k >= 1, got k={k}")


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
    best_s = torch.full((b, k), float("-inf"), device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    step = max(1, PLAIN_CHUNK_ELEMS // max(b, 1))
    for off in range(0, np_, step):
        end = min(off + step, np_)
        dots = kernel_dots(queries, features_t[:, off:end])
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


def fma_step(acc: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """fp32 acc + a * b rounded once, as the card's __fmaf_rn, for bf16 a
    and b (broadcasting): the product of two bf16 values (8 significant
    bits each) is exact in fp64, and the fp64 sum of two operands of at
    most 24 significant bits, rounded again to fp32, is the sum rounded
    once (53 >= 2 * 24 + 2).  One fp64 temporary of acc's shape."""
    return acc.double().addcmul_(a.double(), b.double()).float()


def kernel_dots(queries: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """(B, cols) fp32 dots of queries (B, Fq) with catalog columns ft (Fc,
    cols) in the kernel's chain, query column d meeting catalog row d mod
    Fc: the rounded first product, then per d one rounded multiply and one
    rounded add (fp32), or one fused multiply-add (bf16, summed in fp64 and
    rounded to fp32: the card's __fmaf_rn bit for bit, `fma_step`; one
    fp64 temporary of the output's shape)."""
    fq, fc = queries.shape[1], ft.shape[0]
    q, f = queries.float(), ft.float()        # bf16 values are exact in fp32
    dots = q[:, 0:1] * f[0:1]
    if queries.dtype != torch.bfloat16:
        for d in range(1, fq):
            dots = dots + q[:, d:d + 1] * f[d % fc:d % fc + 1]
        return dots
    for d in range(1, fq):
        dots = fma_step(dots, q[:, d:d + 1], f[d % fc:d % fc + 1])
    return dots


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


# ---- the large-k path's selection, in numpy (csrc/fused_topk.cu, "k > 128")

def score_keys(x, cols) -> np.ndarray:
    """The kernel's 64-bit keys (`score_key`) of fp32 scores `x` at columns
    `cols`, as uint64: the order-preserving bits of the score (-0.0 made
    +0.0) above the inverted column shifted up by one, bit 0 set where the
    score was -0.0.  Their order is the plain version's: value descending,
    lowest column first."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    neg_zero = bits == 0x80000000
    bits = np.where(neg_zero, 0, bits)
    ord_ = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    low = ((0x7FFFFFFF - np.asarray(cols, np.uint64)) << 1) | neg_zero
    return (ord_ << 32) | low


def key_values(keys) -> np.ndarray:
    """fp32 scores of `score_keys` keys (nonzero)."""
    keys = np.asarray(keys, np.uint64)
    ord_ = keys >> 32
    bits = np.where(ord_ & 0x80000000, ord_ ^ 0x80000000, ~ord_ & 0xFFFFFFFF)
    x = bits.astype(np.uint32).view(np.float32)
    return np.where(keys & 1, np.float32(-0.0), x)


def key_columns(keys) -> np.ndarray:
    """int64 columns of `score_keys` keys (nonzero)."""
    low = np.asarray(keys, np.uint64) & 0xFFFFFFFF
    return (0x7FFFFFFF - (low >> 1)).astype(np.int64)


def radix_threshold(keys, need: int) -> int:
    """The kernel's `select_threshold`: the least key t such that exactly
    `need` of the nonzero `keys` are >= t, found by 8-bit digits from the
    top, each pass counting only the keys that share the digits found so
    far; 1 where they number `need` or fewer."""
    keys = np.asarray(keys, np.uint64)
    keys = keys[keys != 0]
    if len(keys) <= need:
        return 1
    prefix = mask = 0
    for shift in range(56, -1, -8):
        match = keys[(keys & np.uint64(mask)) == np.uint64(prefix)]
        hist = np.bincount(((match >> np.uint64(shift)) & np.uint64(255))
                           .astype(np.int64), minlength=256)
        above = np.cumsum(hist[::-1])[::-1] - hist     # keys in higher digits
        d = int(np.nonzero((above < need) & (above + hist >= need))[0][0])
        need -= int(above[d])
        prefix |= d << shift
        mask |= 0xFF << shift
        if hist[d] == need:
            return prefix
    return prefix


def emulate_large_k(queries, q_norms, features_t, norms, excl, valid, *, k,
                    exact, eps=COSINE_EPS, nsplit=None, split_cols=None,
                    cap=None):
    """The large-k kernels' selection, step by step: ((B, k) values, (B, k)
    columns, {"cuts", "entries", "divisions"}).  The catalog splits as
    `_large_plan` splits it on a CPU device (or as `nsplit` / `split_cols`
    say); per query and split, tile by tile of 128 columns, a column gets
    its exact score only where `filter_pass` (the query's threshold t, no
    floor) lets it through and enters the buffer if it scores above t;
    after a tile, a buffer of more than cap - 128 keys is cut to its k best
    (`radix_threshold`) and t becomes the k-th key's value; at the end of
    the split it keeps its k best.  The merge keeps the k best of the
    splits' keys and sorts them."""
    b, fq = queries.shape
    fc, np_ = features_t.shape
    plan = _large_plan(b, np_, torch.device("cpu"), fq=fq, k=k, exact=exact,
                       bf16=features_t.dtype == torch.bfloat16)
    nsplit = plan[1] if nsplit is None else nsplit
    split_cols = plan[2] if split_cols is None else split_cols
    cap = plan[3] if cap is None else cap
    if cap < k + _TC or split_cols * nsplit < np_:
        raise ValueError(f"cap {cap} < k + {_TC} or splits short of {np_}")
    dots = kernel_dots(queries, features_t)      # the kernel's chain
    den = q_norms[:, None] * norms[None, :]
    guard = den > eps
    x = dots / torch.where(guard, den, 1.0) if exact else dots
    scores = torch.where(guard, torch.clamp(x, -1.0, 1.0), 0.0).numpy()
    dots, den, guard = dots.numpy(), den.numpy(), guard.numpy()
    cols = np.arange(np_)
    stats = {"cuts": 0, "entries": 0, "divisions": 0}
    out_v = np.full((b, k), -np.inf, np.float32)
    out_c = np.full((b, k), -1, np.int64)
    for r in range(b):
        scored = (cols < valid) & (cols != int(excl[r]))
        merged = []
        for sp in range(nsplit):
            t = np.float32(-np.inf)
            buf = np.zeros(0, np.uint64)
            for base in range(sp * split_cols, min((sp + 1) * split_cols, np_),
                              _TC):
                c = cols[base:min(base + _TC, (sp + 1) * split_cols, np_)]
                cand = scored[c] & filter_pass(
                    torch.from_numpy(dots[r, c]), q_norms[r:r + 1],
                    norms[c], torch.full((len(c),), float(t)), exact).numpy()
                if exact:
                    stats["divisions"] += int((cand & guard[r, c]).sum())
                enter = cand & (scores[r, c] > t)
                buf = np.concatenate([buf, score_keys(scores[r, c[enter]],
                                                      c[enter])])
                stats["entries"] += int(enter.sum())
                if len(buf) > cap - _TC:
                    buf = buf[buf >= radix_threshold(buf, k)]
                    t = key_values(buf.min()[None])[0]
                    stats["cuts"] += 1
            if len(buf) > k:
                buf = buf[buf >= radix_threshold(buf, k)]
            merged.append(buf)
        keys = np.concatenate(merged)
        keys = np.sort(keys[keys >= radix_threshold(keys, k)])[::-1]
        out_v[r, :len(keys)] = key_values(keys)
        out_c[r, :len(keys)] = key_columns(keys)
    return torch.from_numpy(out_v), torch.from_numpy(out_c), stats


def _device_index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, fq: int, fc: int, k: int, exact: bool,
               bf16: bool, tq: int) -> int:
    """Blocks of the warp-list partial kernel instance for these arguments
    that one SM of CUDA device `index` holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().srt_fused_blocks_per_sm(
            fq, fc, k, int(exact), int(bf16), tq, ctypes.addressof(out))
    _build.check(err, "fused_topk occupancy")
    return out.value


@functools.lru_cache(maxsize=1024)
def _splits(b: int, np_: int, device: torch.device, *, fq: int = 12,
            k: int = 10, exact: bool = True, bf16: bool = False,
            fc: int = None) -> Tuple[int, int]:
    """(number of catalog splits, columns per split) of the warp lists:
    as many splits as let the (query tiles of `query_tile(b)` x splits)
    blocks run in one wave of the card's resident blocks (the H100's 132
    SMs, _CPU_BLOCKS_PER_SM each, for a CPU device), each split at least
    _MIN_SPLIT_COLS wide.  At B = 1 that is one block per resident slot
    (528 on an H100 at four an SM), where the warp merge that the key merge
    replaced held it to 128.  `fc`: the catalog's rows (fq)."""
    tq = query_tile(b)
    if device.type == "cuda":
        per_sm = _occupancy(_device_index(device), fq, fc or fq, k,
                            bool(exact), bool(bf16), tq)
    else:
        per_sm = _CPU_BLOCKS_PER_SM
    slots = device_sms(device) * per_sm
    tiles = -(-b // tq)
    nsplit = max(1, min(slots // tiles, _MAX_GRID_Y,
                        -(-np_ // _MIN_SPLIT_COLS)))
    return _split_columns(np_, nsplit)


def _split_columns(np_: int, nsplit: int) -> Tuple[int, int]:
    """(splits, columns per split) for at most `nsplit` equal splits of
    whole 128-column groups."""
    cols = -(-max(np_, 1) // nsplit)
    cols = -(-cols // _TC) * _TC
    return -(-max(np_, 1) // cols), cols


def large_capacity(k: int) -> int:
    """Buffer slots per (query, split) of the large-k path: 2k rounded up
    to a group (the same as 2k above k = 128), and at least three groups.
    A buffer is cut once it holds more than cap - 128 keys, back to k, so
    a cut leaves room for about k more, and for a group at k <= 128, where
    cap = k + 128 would cut after every group (on an H100 28.8 ms at k =
    128, B = 1024, against 6.5 at k = 100).  The merge has room for its
    in-place sort of a power of two >= k."""
    return -(-max(2 * k, 3 * _TC) // _TC) * _TC


@functools.lru_cache(maxsize=None)
def _large_occupancy(index: int, fq: int, fc: int, exact: bool, bf16: bool,
                     tq: int) -> int:
    """Blocks of the large-k partial kernel instance for these arguments
    that one SM of CUDA device `index` holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().srt_fused_large_blocks_per_sm(
            fq, fc, int(exact), int(bf16), tq, ctypes.addressof(out))
    _build.check(err, "fused_topk_large occupancy")
    return out.value


@functools.lru_cache(maxsize=1024)
def _large_plan(b: int, np_: int, device: torch.device, *, fq: int, k: int,
                exact: bool, bf16: bool,
                fc: int = None) -> Tuple[int, int, int, int]:
    """(queries per launch, splits, columns per split, cap) of the large-k
    path, on query tiles of `query_tile(b)`.  The grid aims at one wave of
    resident blocks, as `_splits`'s, but the scratch a launch needs, chunk
    x nsplit x cap keys, stays under max(SCRATCH_CAP, the buffers of four
    blocks per SM), and under LARGE_SCRATCH_CEILING (or one block's
    buffers where they alone need more): first by fewer splits, then by
    chunks of the batch.  So while the batch has the query tiles, the grid
    holds four blocks per SM up to k = 4096, and above it as many as the
    ceiling allows.  `fc`: the catalog's rows (fq).  Cached per shape."""
    tq = query_tile(b)
    if device.type == "cuda":
        per_sm = _large_occupancy(_device_index(device), fq, fc or fq,
                                  bool(exact), bool(bf16), tq)
    else:
        per_sm = _CPU_BLOCKS_PER_SM
    cap = large_capacity(k)
    sms = device_sms(device)
    block = tq * cap * 8                      # one block's buffers, bytes
    budget = max(1, min(max(SCRATCH_CAP // block,
                            _LARGE_MIN_BLOCKS_PER_SM * sms),
                        LARGE_SCRATCH_CEILING // block))   # blocks' buffers
    tiles = min(-(-b // tq), budget, 2**31 // tq)
    nsplit = max(1, min(sms * per_sm // tiles, budget // tiles, _MAX_GRID_Y,
                        -(-np_ // max(_MIN_SPLIT_COLS,
                                      _LARGE_SPLIT_PER_K * k))))
    return (min(b, tiles * tq), *_split_columns(np_, nsplit), cap)


def _cuda_device(tensors) -> torch.device:
    """The one CUDA device of fused_topk's inputs; raises otherwise, or if
    an input the kernels read flat is not contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_topk: devices {[t.device for t in tensors]}")
    queries, q_norms, features_t, norms, excl = tensors
    if not (queries.is_contiguous() and q_norms.is_contiguous()
            and norms.is_contiguous() and excl.is_contiguous()):
        raise ValueError("fused_topk: queries, norms and excl must be contiguous")
    if features_t.shape[1] >= 2**31 - 1:
        raise ValueError(f"fused_topk: {features_t.shape[1]} columns exceed "
                         "int32 indices")
    return dev


def _launch_args(queries, q_norms, features_t, norms, excl, valid, k,
                 exact, eps):
    """The C entry points' leading arguments, from q through eps."""
    b, fq = queries.shape
    fc, np_ = features_t.shape
    return (queries.data_ptr(), q_norms.data_ptr(), features_t.data_ptr(),
            features_t.stride(0), features_t.stride(1), norms.data_ptr(),
            excl.data_ptr(), b, fq, fc, np_, int(valid), k, int(bool(exact)),
            int(features_t.dtype == torch.bfloat16), ctypes.c_float(eps))


def _on(dev: torch.device):
    """A context that makes `dev` the current CUDA device, where it is not
    already (the context itself costs host time on every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


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
    dev = _cuda_device(tensors)
    launch = _large if fused_route(k, queries.shape[0]) == "large" else _lists
    return launch(dev, queries, q_norms, features_t, norms, excl, valid, k,
                  exact, eps)


def _lists(dev, queries, q_norms, features_t, norms, excl, valid, k, exact,
           eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """The warp lists' launch (k <= SMALL_K_MAX) on checked CUDA inputs."""
    if k > SMALL_K_MAX:
        raise ValueError(f"the warp lists take k <= {SMALL_K_MAX}, got {k}")
    b, fq = queries.shape
    fc, np_ = features_t.shape
    ov = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return ov, oi
    bf16 = features_t.dtype == torch.bfloat16
    nsplit, split_cols = _splits(b, np_, dev, fq=fq, k=k, exact=exact,
                                 bf16=bf16, fc=fc)
    keys = torch.empty((b, nsplit, k), dtype=torch.int64, device=dev)
    with _on(dev):
        err = _build.library().srt_fused_topk(
            *_launch_args(queries, q_norms, features_t, norms, excl, valid,
                          k, exact, eps),
            nsplit, split_cols, query_tile(b), copy_width(features_t),
            keys.data_ptr(), ov.data_ptr(), oi.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fused_topk")
    fused_topk.launches += 1
    return ov, oi


fused_topk.launches = 0   # warp-list kernel launches (`_lists`; CUDA only)


def fused_topk_large(
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
    """`fused_topk` through the large-k kernels at any k >= 1 (`fused_topk`
    takes them where `fused_route` says "large"): the partial kernel and
    the merge over a (chunk, nsplit, cap) key scratch (`_large_plan`),
    once per chunk of the batch.  CPU tensors run `fused_topk_plain`."""
    _check_args(queries, q_norms, features_t, norms, excl, k, exact)
    tensors = (queries, q_norms, features_t, norms, excl)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_topk_plain(queries, q_norms, features_t, norms, excl,
                                valid, k=k, exact=exact, eps=eps)
    return _large(_cuda_device(tensors), queries, q_norms, features_t, norms,
                  excl, valid, k, exact, eps)


def _large(dev, queries, q_norms, features_t, norms, excl, valid, k, exact,
           eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """The large-k path's launches on checked CUDA inputs."""
    b, fq = queries.shape
    fc, np_ = features_t.shape
    ov = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return ov, oi
    bf16 = features_t.dtype == torch.bfloat16
    chunk, nsplit, split_cols, cap = _large_plan(b, np_, dev, fq=fq, k=k,
                                                 exact=exact, bf16=bf16,
                                                 fc=fc)
    keys = torch.empty((chunk, nsplit, cap), dtype=torch.int64, device=dev)
    tq, vec = query_tile(b), copy_width(features_t)
    args = list(_launch_args(queries, q_norms, features_t, norms, excl,
                             valid, k, exact, eps))
    with _on(dev):
        lib = _build.library()
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, b, chunk):
            # a chunk's rows by address, without views (host time)
            args[0], args[1], args[6] = row_ptrs(lo, queries, q_norms, excl)
            args[7] = min(chunk, b - lo)
            err = lib.srt_fused_topk_large(
                *args, nsplit, split_cols, cap, tq, vec, keys.data_ptr(),
                *row_ptrs(lo, ov, oi), stream,
            )
            _build.check(err, "fused_topk_large")
            fused_topk_large.launches += 1
    return ov, oi


fused_topk_large.launches = 0   # kernel launches, one per chunk (CUDA only)
