"""TPU kernels 5-8: the round-2 ablation variants of kernel 3, as wrappers
over `csrc/ablation_r2.cu`.

Each `Body` is one kernel body of the JAX repo's `experiments/
kernel_ablation_r2{,b,c,d}.py` (the 17th, `full_r1`, is kernel 3:
`ops/cuda/fused.fused_topk`).  A body is a dot, an epilogue (flags) and a
reduction over one catalog tile of `tc` columns:

    body(q, qn, ft, cn, excl, valid, *, tc, width, index, digest=False)

    q      (B, F) f32 or bf16 queries, contiguous
    qn     (B,) or (B, 1) f32 raw query norms
    ft     (>= F rows, Np) catalog of q's dtype, unit column stride, Np a
           multiple of tc, tc a multiple of 128
    cn     (Np,) or (1, Np) f32 raw catalog norms
    excl   (B,) or (B, 1) integer column to mask, -1 none (MASK bodies)
    valid  columns >= valid are masked (MASK bodies); an int or a tensor

    dot       sum over ascending r of q[r] * ft[r, col]: fp32 storage
              rounds each multiply and each add; bf16 storage rounds the
              first product, then adds each next one with a fused
              multiply-add, one rounding per step (the card's __fmaf_rn;
              `fma_step`)
    epilogue  DIV dot / (qn*cn); MUL dot * (qn*cn); CLIP clamp to [-1, 1]
              (NaN passes, as jnp.clip); GUARD qn*cn > 1e-8 ? s : 0; MASK
              -inf at columns >= valid and at excl
    reduce    FIRST the raw dots of the tile's first `width` columns; MAX
              the tile's max (NaN wins); TOP2 the per-lane (col mod 128)
              vertical top-2 over the tile's groups, v1 from group 0, then
              strict `>`, then max(v1) (NaN wins) and max over lanes of
              g1 + g2

It returns what the TPU returns: the LAST tile's result (the TPU bodies
overwrite their scratch at every grid step), as (B, width) f32 and, with
`index`, (B, width) int32 (zeros, or TOP2's max(g1 + g2)); without
`index`, TOP2 writes column 0 as m0 + max(g1 + g2) * 0 (r2c, r2d).  With
`digest=True` it also returns the per-tile digest, which the card kernel
always writes: (B, Np / tc) tile max (of the raw dots for FIRST), and for
TOP2 (B, Np / tc) int32 max(g1 + g2).  The digest depends on every score
of every tile, so it shows that no tile's work was dropped.

On CUDA tensors a body launches its kernel and counts it in `.launches`;
on CPU tensors it runs `Body.plain`, which repeats the kernel's arithmetic
in torch ops, one chunk of tiles at a time.  On the card the two agree
bitwise (NaN positions included).  `e_div` divides zero pad columns by
zero norms and returns NaN, as the TPU body does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda.fused import fma_step

# epilogue flags and reductions (csrc/ablation_r2.cu has the same values)
GUARD, DIV, MUL, CLIP, MASK = 1, 2, 4, 8, 16
FIRST, MAX, TOP2 = 0, 1, 2
LANES = 128            # TOP2's lanes: column mod 128
EPS = 1e-8             # the bodies' guard
KERNEL_MAX_F = 64      # query width the kernel's shared buffer holds
PLAIN_CHUNK_ELEMS = 1 << 26    # (B x columns) per chunk of the plain version
R2 = "experiments/kernel_ablation_r2.py"
R2B = "experiments/kernel_ablation_r2b.py"
R2C = "experiments/kernel_ablation_r2c.py"
R2D = "experiments/kernel_ablation_r2d.py"

Outs = Tuple[torch.Tensor, ...]


def as_int(x) -> int:
    """`valid` as the JAX launchers pass it ((1, 1) array) or an int."""
    if isinstance(x, torch.Tensor):
        return int(x.reshape(-1)[0].item())
    return int(np.asarray(x).reshape(-1)[0])


def plain_dots(q: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """(B, cols) fp32 dots of q (B, F) with ft rows [0, F) in the kernel's
    chain: the rounded first product, then per row one rounded multiply
    and one rounded add (fp32), or one `fma_step` (bf16, over at most
    PLAIN_CHUNK_ELEMS scores at a time: a 512 MiB fp64 temporary)."""
    qf, ff = q.float(), ft.float()
    dots = qf[:, 0:1] * ff[0:1]
    if q.dtype != torch.bfloat16:
        for r in range(1, q.shape[1]):
            dots = dots + qf[:, r:r + 1] * ff[r:r + 1]
        return dots
    step = max(1, PLAIN_CHUNK_ELEMS // max(1, q.shape[0]))
    for c0 in range(0, dots.shape[1], step):
        d = dots[:, c0:c0 + step]
        for r in range(1, q.shape[1]):
            d = fma_step(d, q[:, r:r + 1], ft[r:r + 1, c0:c0 + step])
        dots[:, c0:c0 + step] = d
    return dots


def top2_lanes(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per tile the max and max over lanes of g1 + g2 of the vertical
    top-2: s (B, tiles, groups, 128) -> two (B, tiles).  The sequential
    walk (v1 from group 0, then strict `>`) keeps (v1, g1) the first best
    and (v2, g2) the next by (value desc, group asc), with g2 = 0 while v2
    is -inf.  A NaN never beats, so it counts as -inf, except in group 0,
    where it starts as v1 and stays; v2 is then the best of the rest."""
    groups = s.shape[2]
    neg = float("-inf")
    gidx = torch.arange(groups, device=s.device)[None, None, :, None]
    nan0 = torch.isnan(s[:, :, :1])
    s = s.masked_fill(torch.isnan(s), neg)
    v1 = s.amax(dim=2, keepdim=True)
    g1 = torch.where(s == v1, gidx, groups).amin(dim=2, keepdim=True)
    rest = s.masked_fill(gidx == g1, neg)
    v2 = rest.amax(dim=2, keepdim=True)
    g2 = torch.where(rest == v2, gidx, groups).amin(dim=2, keepdim=True)
    g2 = torch.where(v2 == neg, 0, g2)
    # a NaN group 0: g1 = 0, and (v2, g2) the best of groups >= 1, which the
    # walk without it found as (v1, g1) (group 0 is -inf there)
    g2 = torch.where(nan0, torch.where(v1 == neg, 0, g1), g2)
    g1 = torch.where(nan0, 0, g1)
    v1 = v1.masked_fill(nan0, float("nan"))
    return v1.amax(dim=3)[:, :, 0], (g1 + g2).amax(dim=3)[:, :, 0].int()


@dataclasses.dataclass
class Body:
    """One body of TPU kernels 5-8; `replaces` names its JAX function."""

    name: str
    replaces: str
    epi: int
    reduce: int
    launches: int = 0     # kernel launches (CUDA tensors only)

    def scores(self, q, qn, ft, cn, excl, valid: int, c0: int) -> torch.Tensor:
        """(B, cols) scores of catalog columns [c0, c0 + cols)."""
        s = plain_dots(q, ft)
        if self.epi & (GUARD | DIV | MUL):
            den = qn[:, None] * cn[None, :]
        if self.epi & DIV:
            s = s / den
        if self.epi & MUL:
            s = s * den
        if self.epi & CLIP:
            s = torch.clamp(s, -1.0, 1.0)
        if self.epi & GUARD:
            s = torch.where(den > EPS, s, 0.0)
        if self.epi & MASK:
            cols = torch.arange(c0, c0 + ft.shape[1], device=q.device)[None, :]
            s = s.masked_fill((cols >= valid) | (cols == excl[:, None]),
                              float("-inf"))
        return s

    def plain(self, q, qn, ft, cn, excl=None, valid=None, *, tc: int,
              width: int, index: bool, digest: bool = False) -> Outs:
        """The body in torch ops, `PLAIN_CHUNK_ELEMS` scores at a time;
        the outputs of `__call__`."""
        out, dig = self._plain(q, qn, ft, cn, excl, valid, tc, width, index)
        return (*out, dig) if digest else out

    def _plain(self, q, qn, ft, cn, excl, valid, tc: int, width: int,
               index: bool) -> Tuple[Outs, Outs]:
        b, f, np_ = q.shape[0], q.shape[1], ft.shape[1]
        qn, cn = qn.reshape(-1), cn.reshape(-1)
        excl = (torch.full((b,), -1, device=q.device) if excl is None
                else torch.as_tensor(excl, device=q.device).reshape(-1))
        valid = np_ if valid is None else as_int(valid)
        nt = np_ // tc
        per = max(1, PLAIN_CHUNK_ELEMS // max(1, b * tc))
        dmax, dg = [], []
        for t0 in range(0, nt, per):
            t1 = min(nt, t0 + per)
            c0, c1 = t0 * tc, t1 * tc
            s = self.scores(q, qn, ft[:f, c0:c1], cn[c0:c1], excl, valid, c0)
            s = s.view(b, t1 - t0, tc)
            if self.reduce == TOP2:
                m, g = top2_lanes(s.view(b, t1 - t0, tc // LANES, LANES))
                dmax.append(m)
                dg.append(g)
            else:
                dmax.append(s.amax(dim=2))
            if t1 == nt:
                last = s[:, -1]
            del s
        digest = (torch.cat(dmax, dim=1),)
        if self.reduce == TOP2:
            digest += (torch.cat(dg, dim=1),)
        zeros = torch.zeros((b, width), dtype=torch.int32, device=q.device)
        if self.reduce == FIRST:
            out = (last[:, :width].contiguous(),)
            return (out + (zeros,) if index else out), digest
        m0 = digest[0][:, -1:]
        out_s = m0.expand(b, width).contiguous()
        if self.reduce != TOP2:
            return ((out_s, zeros) if index else (out_s,)), digest
        gs = digest[1][:, -1:]
        if index:
            return (out_s, gs.expand(b, width).contiguous()), digest
        out_s[:, :1] = m0 + gs.float() * 0
        return (out_s,), digest

    def __call__(self, q, qn, ft, cn, excl=None, valid=None, *, tc: int,
                 width: int, index: bool, digest: bool = False) -> Outs:
        qn, cn = self._check(q, qn, ft, cn, excl, valid, tc, width)
        tensors = (q, qn, ft, cn)
        if all(t.device.type == "cpu" for t in tensors):
            return self.plain(q, qn, ft, cn, excl, valid, tc=tc, width=width,
                              index=index, digest=digest)
        out, dig = self._launch(q, qn, ft, cn, excl, valid, tc, width, index)
        return (*out, dig) if digest else out

    def blocks_per_sm(self, f: int, dtype: torch.dtype) -> int:
        """Blocks of this body's kernel instance for (F, storage dtype) that
        one SM of the current CUDA device holds at once."""
        out = ctypes.c_int(0)
        err = _build.library(_build.EXPERIMENTS).srt_ablation_blocks_per_sm(
            f, int(dtype == torch.bfloat16), self.epi, self.reduce,
            ctypes.addressof(out))
        _build.check(err, f"{self.name} occupancy (F={f}, {dtype})",
                     _build.EXPERIMENTS)
        return out.value

    def tiling(self, f: int, dtype: torch.dtype) -> dict:
        """The card kernel's tiling for (F, storage dtype), from the built
        library: groups per step `u`, queries per block `tq`, `min_blocks`
        an SM must hold, `row_unroll` rows a dot step, `stage_rows`."""
        out = (ctypes.c_int * 5)()
        err = _build.library(_build.EXPERIMENTS).srt_ablation_tiling(
            f, int(dtype == torch.bfloat16), self.epi, self.reduce,
            ctypes.addressof(out))
        _build.check(err, f"{self.name} tiling (F={f}, {dtype})",
                     _build.EXPERIMENTS)
        return dict(zip(("u", "tq", "min_blocks", "row_unroll", "stage_rows"),
                        out))

    def _check(self, q, qn, ft, cn, excl, valid, tc: int, width: int):
        if (q.dtype not in (torch.float32, torch.bfloat16)
                or ft.dtype != q.dtype or qn.dtype != torch.float32
                or cn.dtype != torch.float32):
            raise TypeError(
                f"{self.name} takes float32 or bfloat16 q and ft of one dtype "
                f"and float32 norms, got {q.dtype}, {ft.dtype}, {qn.dtype}, "
                f"{cn.dtype}")
        if q.dim() != 2 or ft.dim() != 2 or ft.shape[0] < q.shape[1]:
            raise ValueError(f"{self.name}: q {tuple(q.shape)} vs ft "
                             f"{tuple(ft.shape)}")
        b, np_ = q.shape[0], ft.shape[1]
        qn, cn = qn.reshape(-1), cn.reshape(-1)
        if qn.shape != (b,) or cn.shape != (np_,):
            raise ValueError(f"{self.name}: {qn.numel()} query and "
                             f"{cn.numel()} catalog norms for B={b}, Np={np_}")
        if tc < LANES or tc % LANES or np_ < tc or np_ % tc:
            raise ValueError(f"{self.name}: Np={np_} is not a multiple of "
                             f"tc={tc}, a multiple of {LANES}")
        if width < 1 or (self.reduce == FIRST and width > LANES):
            raise ValueError(f"{self.name}: output width {width}")
        if self.epi & MASK and (excl is None or valid is None):
            raise ValueError(f"{self.name} masks: it needs excl and valid")
        return qn, cn

    def _launch(self, q, qn, ft, cn, excl, valid, tc: int, width: int,
                index: bool) -> Tuple[Outs, Outs]:
        dev = q.device
        b, f, np_ = q.shape[0], q.shape[1], ft.shape[1]
        if dev.type != "cuda" or any(t.device != dev for t in (qn, ft, cn)):
            raise ValueError(f"{self.name}: devices "
                             f"{[t.device for t in (q, qn, ft, cn)]}")
        if (not (q.is_contiguous() and qn.is_contiguous()
                 and cn.is_contiguous()) or ft.stride(1) != 1
                or f > KERNEL_MAX_F):
            raise ValueError(f"{self.name}: the kernel takes contiguous q and "
                             f"norms, ft with unit column stride, F <= "
                             f"{KERNEL_MAX_F}")
        if ft.data_ptr() % 16 or ft.stride(0) * ft.element_size() % 16:
            # the kernel stages the catalog with 16-byte cp.async copies: a
            # view off that alignment (a column offset, an odd row stride)
            # is read through an aligned copy of its f rows
            ft = ft[:f].clone(memory_format=torch.contiguous_format)
        ex = None
        if excl is not None:
            ex = torch.as_tensor(excl, device=dev).reshape(-1).to(
                torch.int32).contiguous()
        nt = np_ // tc
        out_s = torch.empty((b, width), dtype=torch.float32, device=dev)
        out_i = (torch.empty((b, width), dtype=torch.int32, device=dev)
                 if index else None)
        dmax = torch.empty((b, nt), dtype=torch.float32, device=dev)
        dg = (torch.empty((b, nt), dtype=torch.int32, device=dev)
              if self.reduce == TOP2 else None)
        ptr = (lambda t: None if t is None else t.data_ptr())
        with torch.cuda.device(dev):
            err = _build.library(_build.EXPERIMENTS).srt_ablation(
                q.data_ptr(), qn.data_ptr(), ft.data_ptr(), ft.stride(0),
                cn.data_ptr(), ptr(ex), np_ if valid is None else as_int(valid),
                b, f, np_, tc, int(q.dtype == torch.bfloat16), self.epi,
                self.reduce, width, ctypes.c_float(EPS), out_s.data_ptr(),
                ptr(out_i), dmax.data_ptr(), ptr(dg),
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} (tc={tc}, F={f}, {q.dtype})",
                     _build.EXPERIMENTS)
        self.launches += 1
        out = (out_s, out_i) if index else (out_s,)
        return out, (dmax,) if dg is None else (dmax, dg)


_EXACT = GUARD | DIV | CLIP | MASK       # `_score_tile`, `k_e_guard`
# the bodies, by launcher; each entry a distinct counter
BODIES = {
    "r2": {
        "dotonly": Body("r2.dotonly", f"{R2}:54", 0, FIRST),
        "widemax": Body("r2.widemax", f"{R2}:70", _EXACT, MAX),
        "vertmax": Body("r2.vertmax", f"{R2}:85", _EXACT, MAX),
        "verttop2": Body("r2.verttop2", f"{R2}:106", _EXACT, TOP2),
    },
    "r2b": {
        "e_div": Body("r2b.e_div", f"{R2B}:40", DIV | CLIP, MAX),
        "e_recip": Body("r2b.e_recip", f"{R2B}:49", MUL | CLIP, MAX),
        "e_guard": Body("r2b.e_guard", f"{R2B}:58", _EXACT, MAX),
        "e_fast": Body("r2b.e_fast", f"{R2B}:75", CLIP | MASK, MAX),
        "dotonly": Body("r2b.dotonly", f"{R2B}:88", 0, FIRST),
        "e_fast_guard": Body("r2b.e_fast_guard", f"{R2B}:98",
                             GUARD | CLIP | MASK, MAX),
    },
    "r2c": {
        "dotonly": Body("r2c.dotonly", f"{R2C}:33", 0, FIRST),
        "fastguard": Body("r2c.fastguard", f"{R2C}:41", GUARD | CLIP, MAX),
        "fastguard_top2": Body("r2c.fastguard_top2", f"{R2C}:55",
                               GUARD | CLIP, TOP2),
        "staged_f32": Body("r2c.staged_f32", f"{R2C}:84", GUARD | DIV | CLIP,
                           MAX),
    },
    "r2d": {
        "dotonly": Body("r2d.dotonly", f"{R2D}:20", 0, FIRST),
        "fg2": Body("r2d.fg2", f"{R2D}:27", GUARD | CLIP, TOP2),
    },
}


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, NaN at the same positions, the rest equal."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])
