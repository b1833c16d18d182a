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
(`csrc/fused_topk.cu`): for k <= SMALL_K_MAX the warp-list kernel, above
it `fused_topk_large`'s candidate buffers and radix select (any k >= 1;
`emulate_large_k` is its selection in torch).  On a CPU tensor it runs
`fused_topk_plain`, the same arithmetic in torch ops, chunked over the
catalog.  On the card the kernels and the plain version agree bitwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import COSINE_EPS
from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import SCRATCH_CAP, device_sms
from spotify_recommender_tpu_torch.ops.topk import merge_topk, topk_stable

SMALL_K_MAX = 128         # the warp lists' largest k: 4 slots per lane
_TQ = 16                  # queries per block
_TC = 128                 # columns per tile
_MAX_SPLITS = 128
_MIN_SPLIT_COLS = 1024    # a split below this costs more in its merge
_CPU_BLOCKS_PER_SM = 4    # resident blocks per SM assumed without a card
# the large-k path (csrc/fused_topk.cu, "k > 128"): its scratch, chunk x
# nsplit x cap keys of 8 bytes, takes at most SCRATCH_CAP, or the buffers
# of _LARGE_MIN_BLOCKS_PER_SM blocks on every SM where they need more, and
# never more than LARGE_SCRATCH_CEILING (one block's buffers, 16 queries x
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
    q, ft = queries.float(), features_t.float()
    dots = q[:, 0:1] * ft[0:1]                   # the kernel's chain
    for d in range(1, fq):
        dots = dots + q[:, d:d + 1] * ft[d % fc:d % fc + 1]
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
    least _MIN_SPLIT_COLS wide.  The warp lists' plan (k <= SMALL_K_MAX);
    the large-k path's is `_large_plan`."""
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
    return _split_columns(np_, nsplit)


def _split_columns(np_: int, nsplit: int) -> Tuple[int, int]:
    """(splits, columns per split) for at most `nsplit` equal splits of
    whole 128-column tiles."""
    cols = -(-max(np_, 1) // nsplit)
    cols = -(-cols // _TC) * _TC
    return -(-max(np_, 1) // cols), cols


def large_capacity(k: int) -> int:
    """Buffer slots per (query, split) of the large-k path: 2k rounded up
    to a tile (the same as 2k above k = 128), and at least three tiles.
    A buffer is cut once it holds more than cap - 128 keys, back to k, so
    a cut leaves room for about k more, and for a tile at k <= 128, where
    cap = k + 128 would cut after every tile (on an H100 28.8 ms at k =
    128, B = 1024, against 6.5 at k = 100).  The merge has room for its
    in-place sort of a power of two >= k."""
    return -(-max(2 * k, 3 * _TC) // _TC) * _TC


@functools.lru_cache(maxsize=None)
def _large_occupancy(index: int, fq: int, exact: bool, bf16: bool) -> int:
    """Blocks of the large-k partial kernel instance for these arguments
    that one SM of CUDA device `index` holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().srt_fused_large_blocks_per_sm(
            fq, int(exact), int(bf16), ctypes.addressof(out))
    _build.check(err, "fused_topk_large occupancy")
    return out.value


def _large_plan(b: int, np_: int, device: torch.device, *, fq: int, k: int,
                exact: bool, bf16: bool) -> Tuple[int, int, int, int]:
    """(queries per launch, splits, columns per split, cap) of the large-k
    path.  The grid aims at one wave of resident blocks, as `_splits`'s,
    but the scratch a launch needs, chunk x nsplit x cap keys, stays under
    max(SCRATCH_CAP, the buffers of four blocks per SM), and under
    LARGE_SCRATCH_CEILING (or one block's buffers where they alone need
    more): first by fewer splits, then by chunks of the batch.  So while
    the batch has the query tiles, the grid holds four blocks per SM up to
    k = 4096, and above it as many as the ceiling allows."""
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        per_sm = _large_occupancy(index, fq, bool(exact), bool(bf16))
    else:
        per_sm = _CPU_BLOCKS_PER_SM
    cap = large_capacity(k)
    sms = device_sms(device)
    block = _TQ * cap * 8                     # one block's buffers, bytes
    budget = max(1, min(max(SCRATCH_CAP // block,
                            _LARGE_MIN_BLOCKS_PER_SM * sms),
                        LARGE_SCRATCH_CEILING // block))   # blocks' buffers
    tiles = min(-(-b // _TQ), budget, 2**31 // _TQ)
    nsplit = max(1, min(sms * per_sm // tiles, budget // tiles, _MAX_GRID_Y,
                        -(-np_ // max(_MIN_SPLIT_COLS,
                                      _LARGE_SPLIT_PER_K * k))))
    return (min(b, tiles * _TQ), *_split_columns(np_, nsplit), cap)


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
    if k > SMALL_K_MAX:
        return fused_topk_large(queries, q_norms, features_t, norms, excl,
                                valid, k=k, exact=exact, eps=eps)
    dev = _cuda_device(tensors)
    b, fq = queries.shape
    fc, np_ = features_t.shape
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
    takes them for k > SMALL_K_MAX): the partial kernel and the merge over
    a (chunk, nsplit, cap) key scratch (`_large_plan`), once per chunk of
    the batch.  CPU tensors run `fused_topk_plain`."""
    _check_args(queries, q_norms, features_t, norms, excl, k, exact)
    tensors = (queries, q_norms, features_t, norms, excl)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_topk_plain(queries, q_norms, features_t, norms, excl,
                                valid, k=k, exact=exact, eps=eps)
    dev = _cuda_device(tensors)
    b, fq = queries.shape
    fc, np_ = features_t.shape
    ov = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return ov, oi
    bf16 = features_t.dtype == torch.bfloat16
    chunk, nsplit, split_cols, cap = _large_plan(b, np_, dev, fq=fq, k=k,
                                                 exact=exact, bf16=bf16)
    keys = torch.empty((chunk, nsplit, cap), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        lib = _build.library()
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, b, chunk):
            hi = min(lo + chunk, b)
            err = lib.srt_fused_topk_large(
                queries[lo:hi].data_ptr(), q_norms[lo:hi].data_ptr(),
                features_t.data_ptr(), features_t.stride(0),
                features_t.stride(1), norms.data_ptr(),
                excl[lo:hi].data_ptr(), hi - lo, fq, fc, np_, int(valid), k,
                int(bool(exact)), int(bf16), ctypes.c_float(eps), nsplit,
                split_cols, cap, keys.data_ptr(), ov[lo:hi].data_ptr(),
                oi[lo:hi].data_ptr(), stream,
            )
            _build.check(err, "fused_topk_large")
            fused_topk_large.launches += 1
    return ov, oi


fused_topk_large.launches = 0   # kernel launches, one per chunk (CUDA only)
