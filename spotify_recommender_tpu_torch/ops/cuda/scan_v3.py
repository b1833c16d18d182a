"""Kernel 1 of the certified path: the epilogue-free v3 bin scan.

`scan_v3(q2, ft, w=, depth=, topc=, ncols=)` scans split-plane unit
queries against the split-plane prenormalized catalog and returns, per
query, the top-`topc` candidates of its bin structure and the coverage
bound:

    q2   (B, 4F) bf16   [qh, ql, ql, qh]
    ft   (P*F, Np) bf16 catalog planes [hi; lo] (P = 2) or
                        [hi; lo; hi; lo] (P = 4); Np a multiple of w
    out  (B, topc) f32 approx scores, (B, topc) int32 columns,
         (B, 1) f32 bound

Only the first `ncols` columns (default all Np; the catalog's real rows)
enter a bin: the layout's pad columns score 0 on their zero planes and
would otherwise fill the bins of a query whose real scores are all below
0.  Bin of column c: c mod w.  Each bin keeps its top-`depth` (value, column)
with strict `>` (lowest column wins ties) and its (depth+1)-th best value;
the output is the top-`topc` of the depth*w slots (slot = level*w + bin) by
value descending, slot ascending, with empty slots as (-inf, -1).  This is
what the TPU kernel `_scan_kernel_v3`
(spotify_recommender_tpu/ops/pallas/fused_topk.py:1069) computes.

On a CUDA tensor `scan_v3` launches hand-written kernels, on one of two
routes (`scan_route`), each a scan whose blocks cover (query tiles x
catalog slices of whole w-column groups), each writing its slice's full
bin structures to scratch, then a merge that folds the slices per bin:

    flat  csrc/scan_v3.cu over csrc/bin_scan.cuh: w up to FLAT_MAX_BINS
          (a bin per thread), depth up to FLAT_MAX_DEPTH (register
          lists), rows that fit its tile (`flat_fits`), topc up to
          ROUNDS_MAX_TOPC: the merge extracts the top-`topc` by argmax
          rounds;
    wide  csrc/scan_wide.cu: any w (blocks of WIDE_BINS bins, a third grid
          dimension over the bin groups), any depth (register lists to
          WIDE_MAX_REG_DEPTH, then a runtime-depth instance whose lists
          live in the scratch), any F (row chunks, `wide_stage`), then
          `srt_bin_select`, an exact radix selection of the top-topc.

`scan_slice` picks the slice so that the grid covers the card's block
slots a few times over at any B, with the scratch under SCRATCH_CAP; a
batch whose one slice would pass SCRATCH_CEILING runs in chunks of
`batch_chunk` queries, one launch each; `scan_plan` keeps a shape's
route, chunks and slices, so a repeated call does only the launches' host
work.  On a CPU tensor it runs
`scan_v3_plain`, which sums the same 4F products in the kernel's order:
on the card the two agree bitwise, whatever the route, split, bin groups
or row chunks, because the merge only compares values
(`split_bin_structures` repeats it in torch).  Both read only the [hi; lo]
rows of `ft` and the [qh, ql] columns of `q2`.  The helpers below are
shared with kernel 4 (ops/cuda/scan_v2.py) and the prototype scans
(ops/cuda/proto_scans.py), which run the flat instances only.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.topk import topk_stable

FLAT_MAX_BINS = 1024      # the flat instances: one bin per thread of a block
FLAT_MAX_DEPTH = 4        # their register lists
WIDE_BINS = 128           # bins of a wide-route scan block
WIDE_MAX_REG_DEPTH = 8    # its deepest register lists
# the flat merge's argmax rounds extract a top-C up to this; a larger C
# goes the wide route, whose radix selection does not grow with C
ROUNDS_MAX_TOPC = 128
# dynamic shared memory a flat scan block may take (bin_scan.cuh kMaxSmem)
SMEM_LIMIT = 232448 - 1024
TILE_BYTES = 24576        # bin_scan.cuh kTileBytes
H100_SMS = 132            # the schedule the plain split follows on the CPU
MAX_SLICES = 65535        # the scan kernel's gridDim.y
# the split scan's grid: blocks per SM it aims for (two to three waves of
# the blocks an SM holds at once), the fewest w-column groups in a slice (a
# thinner slice costs the merge more than the scan gains), and the cap on
# its per-slice scratch
SCAN_BLOCKS_PER_SM = 8
MIN_SLICE_GROUPS = 16
SCRATCH_CAP = 64 << 20    # bytes
# a batch whose one slice of scratch would pass this runs in chunks
SCRATCH_CEILING = 512 << 20


def queries_per_block(w: int) -> int:
    """Queries per block of a W-bin scan (bin_scan.cuh)."""
    return 16 if w <= 256 else (8 if w <= 512 else 4)


def split_slice(b: int, np_: int, w: int, tq: int, sms: int,
                blocks_per_sm: int, slice_bytes: int = 0) -> int:
    """Columns per catalog slice (a multiple of w) so that (query tiles x
    slices) blocks cover `sms` SMs `blocks_per_sm` times over, in at most
    MAX_SLICES slices and, where each slice's scratch takes `slice_bytes`,
    at most SCRATCH_CAP bytes of it (or one slice)."""
    tiles = max(1, -(-b // tq))
    slices = max(1, -(-blocks_per_sm * sms // tiles))
    if slice_bytes:
        slices = min(slices, max(1, SCRATCH_CAP // slice_bytes))
    slices = min(slices, MAX_SLICES)
    per = -(-np_ // slices)
    return max(w, -(-per // w) * w)


def device_sms(device: torch.device) -> int:
    """SMs of a CUDA device; H100_SMS for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def flat_fits(f: int, w: int) -> bool:
    """Whether a flat scan block's query tile and two tiles of one w-column
    group of the 2F rows fit its shared memory (bin_scan.cuh `launch`)."""
    rows = 2 * f
    return 4 * rows * queries_per_block(w) + 4 * rows * w <= SMEM_LIMIT


def scan_route(f: int, w: int, depth: int, topc: int) -> str:
    """"flat" where the flat instances take (F, w, depth) and the merge's
    rounds the top-`topc` (0: the full structures), else "wide"."""
    flat = (w <= FLAT_MAX_BINS and depth <= FLAT_MAX_DEPTH and flat_fits(f, w)
            and topc <= ROUNDS_MAX_TOPC)
    return "flat" if flat else "wide"


def wide_tiling(depth: int) -> Tuple[int, int]:
    """(queries a block, columns a thread scores a step) of a wide scan
    block (csrc/scan_wide.cu `wide_queries`, `wide_cols`): register lists
    to depth WIDE_MAX_REG_DEPTH (8 queries past depth 4), then the
    runtime-depth instance."""
    if depth > WIDE_MAX_REG_DEPTH:
        return 16, 4
    if depth > FLAT_MAX_DEPTH:
        return 8, 2
    return 16, 4 if depth <= 2 else (2 if depth == 3 else 1)


def wide_stage(f: int, depth: int) -> Tuple[int, int]:
    """(features per row chunk, dynamic shared memory in bytes) of a wide
    scan block (csrc/scan_wide.cu `chunk_features`, `run_wide`): a stage
    of U groups of WIDE_BINS columns near TILE_BYTES, and TQ query rows."""
    tq, u = wide_tiling(depth)
    most = TILE_BYTES // (2 * u * WIDE_BINS * 2)
    n = -(-f // most)
    fc = -(-f // n)
    return fc, 2 * (4 * 2 * fc * tq + 2 * 2 * fc * u * WIDE_BINS)


def slice_bytes(b: int, w: int, depth: int) -> int:
    """Bytes of one catalog slice's scratch for `b` queries."""
    return 4 * b * (2 * depth * w + w)


def batch_chunk(b: int, w: int, depth: int) -> int:
    """Queries per launch: all of `b`, or as many as keep one slice's
    scratch under SCRATCH_CEILING (a multiple of 16, the query tile,
    where more than 16 fit)."""
    fit = max(1, SCRATCH_CEILING // slice_bytes(1, w, depth))
    if fit >= b:
        return b
    return fit - fit % 16 if fit > 16 else fit


def scan_slice(b: int, np_: int, w: int, depth: int,
               device: torch.device, route: str = "flat") -> int:
    """Columns per catalog slice of the split scan on `device` (kernels 1
    and 4): `split_slice` at SCAN_BLOCKS_PER_SM over the route's (query
    tiles x bin groups) blocks a slice, the scratch under SCRATCH_CAP, at
    least MIN_SLICE_GROUPS groups of w columns."""
    if route == "flat":
        tiles = max(1, -(-b // queries_per_block(w)))
    else:
        tiles = max(1, -(-b // wide_tiling(depth)[0])) * (w // WIDE_BINS)
    slice_ = split_slice(tiles, np_, w, 1, device_sms(device),
                         SCAN_BLOCKS_PER_SM, slice_bytes(b, w, depth))
    return max(slice_, MIN_SLICE_GROUPS * w)


@functools.lru_cache(maxsize=1024)
def scan_plan(b: int, np_: int, f: int, w: int, depth: int, topc: int,
              device: torch.device) -> Tuple[str, Tuple[Tuple[int, ...], ...]]:
    """The launches of one `scan_v3` / `scan_v2` call: its route and, per
    batch chunk (`batch_chunk`), (first query, queries, slice columns,
    slices).  Cached: a serving path calls with few shapes, and the plan is
    host work before every launch."""
    route = scan_route(f, w, depth, topc)
    chunk = batch_chunk(b, w, depth)
    chunks = []
    for c0 in range(0, b, chunk):
        m = min(chunk, b - c0)
        slice_ = scan_slice(m, np_, w, depth, device, route)
        chunks.append((c0, m, slice_, -(-np_ // slice_)))
    return route, tuple(chunks)


def scan_scratch(slices: int, b: int, w: int, depth: int,
                 device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The split scan's per-slice structures: (slices, B, depth*w) f32
    values, int32 columns and (slices, B, w) f32 bounds, as `torch.empty`
    on `device`."""
    return (
        torch.empty((slices, b, depth * w), dtype=torch.float32, device=device),
        torch.empty((slices, b, depth * w), dtype=torch.int32, device=device),
        torch.empty((slices, b, w), dtype=torch.float32, device=device),
    )


def row_ptrs(row: int, *tensors: torch.Tensor) -> list:
    """The address of row `row` of each contiguous tensor (a batch chunk's
    first row), without making a view."""
    if not row:
        return [t.data_ptr() for t in tensors]
    return [t.data_ptr() + row * t.stride(0) * t.element_size()
            for t in tensors]


def check_kernel_bins(w: int) -> None:
    """Raise unless the CUDA bin scans take `w` bins: a multiple of 128, as
    the JAX layout's W is."""
    if w % 128 or w < 128:
        raise ValueError(
            f"scan_bins W={w}: the CUDA bin scans take W a multiple of 128")


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


def merge_bins(parts, depth: int) -> Tuple[torch.Tensor, ...]:
    """Fold the bin structures (values (B, depth*w), columns, bounds
    (B, w)) of consecutive catalog slices, as the merge kernel does: each
    later slice's `depth` pairs go, in their order, through the walk's
    insert (strict `>`: the earlier slice, the lower column, wins ties),
    and the bound is the max of the two bounds and every value evicted."""
    sv, si, bnd = parts[0]
    b, w = bnd.shape
    v = list(sv.view(b, depth, w).unbind(1))
    ix = list(si.view(b, depth, w).unbind(1))
    for pv, pi, pb in parts[1:]:
        pv, pi = pv.view(b, depth, w), pi.view(b, depth, w)
        for lv in range(depth):
            s, col = pv[:, lv], pi[:, lv]
            bnd = torch.maximum(bnd, torch.minimum(s, v[-1]))
            c = [s > x for x in v]
            for l in range(depth - 1, 0, -1):
                v[l] = torch.where(c[l - 1], v[l - 1], torch.where(c[l], s, v[l]))
                ix[l] = torch.where(c[l - 1], ix[l - 1],
                                    torch.where(c[l], col, ix[l]))
            v[0] = torch.where(c[0], s, v[0])
            ix[0] = torch.where(c[0], col, ix[0])
        bnd = torch.maximum(bnd, pb)
    return torch.stack(v, 1).view(b, -1), torch.stack(ix, 1).view(b, -1), bnd


def split_bin_structures(
    scores: torch.Tensor, w: int, depth: int, slice_: int, groups: int = 1,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`bin_structures` as the kernels build them: per batch chunk of
    `chunk` queries (`batch_chunk`), per bin group of w // groups bins (a
    wide-route block's bins: the columns of each w-column group whose bin
    lies in the group), per slice of `slice_` columns (a multiple of w),
    then `merge_bins`; bitwise equal to `bin_structures(scores, w,
    depth)`."""
    b, np_ = scores.shape
    wb = w // groups
    out = []
    for q0 in range(0, b, chunk or b):
        sc = scores[q0:q0 + (chunk or b)]
        m = sc.shape[0]
        merged = []
        for g in range(groups):
            cols = sc.reshape(m, np_ // w, w)[:, :, g * wb:(g + 1) * wb]
            parts = []
            for c0 in range(0, np_, slice_):
                part = cols[:, c0 // w:(c0 + slice_) // w].reshape(m, -1)
                sv, si, bnd = bin_structures(part, wb, depth)
                # part column p is catalog column (c0/w + p/wb)*w + g*wb + p%wb
                si = torch.where(
                    si >= 0, (c0 // w + si // wb) * w + g * wb + si % wb, si)
                parts.append((sv, si, bnd))
            merged.append(merge_bins(parts, depth))
        # slot level*w + g*wb + t
        out.append(tuple(
            torch.cat([x[i].view(m, -1, wb) for x in merged], 2).reshape(m, -1)
            for i in range(2)) + (torch.cat([x[2] for x in merged], 1),))
    return tuple(torch.cat([o[i] for o in out]) for i in range(3))


def top_slots(
    sv: torch.Tensor, si: torch.Tensor, bound: torch.Tensor, topc: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compact output: top-`topc` slots by value descending, slot
    ascending, and the max bound over the bins (B, 1)."""
    top_v, slot = topk_stable(sv, topc)
    return (top_v, torch.gather(si, 1, slot),
            bound.amax(dim=1, keepdim=True))


def scan_v3_plain(
    q2: torch.Tensor, ft: torch.Tensor, *, w: int, depth: int, topc: int,
    ncols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dots = split_plane_dots(q2, ft)
    if ncols is not None:
        dots[:, ncols:] = float("-inf")   # never enters a bin
    sv, si, bound = bin_structures(dots, w, depth)
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
    q2: torch.Tensor, ft: torch.Tensor, *, w: int, depth: int, topc: int,
    ncols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    f = check_scan_inputs(q2, ft, w, "scan_v3")
    if not 1 <= topc <= depth * w:
        raise ValueError(f"scan_v3: topc={topc} outside 1..depth*w={depth * w}")
    np_ = ft.shape[1]
    ncols = np_ if ncols is None else ncols
    if not 0 <= ncols <= np_:
        raise ValueError(f"scan_v3: ncols={ncols} outside 0..Np={np_}")
    if q2.device.type == "cpu" and ft.device.type == "cpu":
        return scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc, ncols=ncols)
    check_kernel_layout(q2, ft, w, "scan_v3")
    if depth < 1:
        raise ValueError(f"scan_v3: depth {depth} < 1")
    b = q2.shape[0]
    ov = torch.empty((b, topc), dtype=torch.float32, device=q2.device)
    oi = torch.empty((b, topc), dtype=torch.int32, device=q2.device)
    ob = torch.empty((b, 1), dtype=torch.float32, device=q2.device)
    route, chunks = scan_plan(b, np_, f, w, depth, topc, q2.device)
    lib = _build.library()
    with torch.cuda.device(q2.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0, m, slice_, slices in chunks:
            qc, o = row_ptrs(c0, q2), row_ptrs(c0, ov, oi, ob)
            wv, wi, wb = scan_scratch(slices, m, w, depth, q2.device)
            scratch = (wv.data_ptr(), wi.data_ptr(), wb.data_ptr())
            if route == "flat":
                err = lib.srt_scan_v3(
                    *qc, m, f, ft.data_ptr(), ft.stride(0), np_, ncols, w,
                    depth, topc, slice_, *scratch, *o, stream)
            else:
                # the merged full structures into the scratch's slice 0,
                # then the exact selection of the top-topc
                err = lib.srt_scan_wide(
                    *qc, None, m, f, ft.data_ptr(), ft.stride(0), None, np_,
                    ncols, None, 0, 0.0, 0, w, depth, slice_, *scratch,
                    *scratch, stream)
                if not err:
                    err = lib.srt_bin_select(*scratch, m, w, depth, topc, *o,
                                             stream)
            if err:
                _build.check(err, f"scan_v3 {route} (w={w}, depth={depth}, "
                                  f"F={f}, topc={topc}, slice={slice_})")
            scan_v3.launches += 1
    return ov, oi, ob


scan_v3.launches = 0   # launches, one per batch chunk (CUDA tensors only)
