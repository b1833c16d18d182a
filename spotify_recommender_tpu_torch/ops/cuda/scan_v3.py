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

On a CUDA tensor `scan_v3` launches the hand-written kernels
(`csrc/scan_v3.cu` over `csrc/bin_scan.cuh`: w a multiple of 128 up to
KERNEL_MAX_BINS, depth 1-4): a scan whose blocks cover (query tiles x
catalog slices of whole w-column groups), each writing its slice's full
bin structures to scratch, then a merge that folds the slices per bin and
extracts the top-`topc`.  `scan_slice` picks the slice so that the grid
covers the card's block slots a few times over at any B, with the scratch
under SCRATCH_CAP.  On a CPU tensor it runs `scan_v3_plain`, which sums
the same 4F products in the kernel's order: on the card the two agree
bitwise, whatever the split, because the merge only compares values
(`split_bin_structures` repeats it in torch).  Both read only the [hi; lo]
rows of `ft` and the [qh, ql] columns of `q2`.  The helpers below are
shared with kernel 4 (ops/cuda/scan_v2.py) and the prototype scans
(ops/cuda/proto_scans.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.topk import topk_stable

KERNEL_MAX_BINS = 1024    # one bin per thread of a block
KERNEL_MAX_DEPTH = 4
H100_SMS = 132            # the schedule the plain split follows on the CPU
MAX_SLICES = 65535        # the scan kernel's gridDim.y
# the split scan's grid: blocks per SM it aims for (two to three waves of
# the blocks an SM holds at once), the fewest w-column groups in a slice (a
# thinner slice costs the merge more than the scan gains), and the cap on
# its per-slice scratch
SCAN_BLOCKS_PER_SM = 8
MIN_SLICE_GROUPS = 16
SCRATCH_CAP = 64 << 20    # bytes


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


def scan_slice(b: int, np_: int, w: int, depth: int,
               device: torch.device) -> int:
    """Columns per catalog slice of the split scan on `device` (kernels 1
    and 4): `split_slice` at SCAN_BLOCKS_PER_SM, the scratch under
    SCRATCH_CAP, at least MIN_SLICE_GROUPS groups of w columns."""
    slice_ = split_slice(b, np_, w, queries_per_block(w), device_sms(device),
                         SCAN_BLOCKS_PER_SM, 4 * b * (2 * depth * w + w))
    return max(slice_, MIN_SLICE_GROUPS * w)


def scan_scratch(b: int, np_: int, w: int, depth: int, device: torch.device):
    """The split scan's slice (columns) and its per-slice structures
    (slices, B, depth*w) f32 values, int32 columns and (slices, B, w) f32
    bounds, as `torch.empty` on `device`."""
    slice_ = scan_slice(b, np_, w, depth, device)
    slices = max(1, -(-np_ // slice_))
    wv = torch.empty((slices, b, depth * w), dtype=torch.float32, device=device)
    wi = torch.empty((slices, b, depth * w), dtype=torch.int32, device=device)
    wb = torch.empty((slices, b, w), dtype=torch.float32, device=device)
    return slice_, wv, wi, wb


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
    scores: torch.Tensor, w: int, depth: int, slice_: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`bin_structures` as the kernels build them: per slice of `slice_`
    columns (a multiple of w), then `merge_bins`; bitwise equal to
    `bin_structures(scores, w, depth)`."""
    parts = []
    for c0 in range(0, scores.shape[1], slice_):
        sv, si, bnd = bin_structures(scores[:, c0:c0 + slice_], w, depth)
        parts.append((sv, torch.where(si >= 0, si + c0, si), bnd))
    return merge_bins(parts, depth)


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
    if not 1 <= depth <= KERNEL_MAX_DEPTH:
        raise ValueError(
            f"the CUDA scan supports depth 1-{KERNEL_MAX_DEPTH}, got {depth}")
    b = q2.shape[0]
    slice_, wv, wi, wb = scan_scratch(b, np_, w, depth, q2.device)
    ov = torch.empty((b, topc), dtype=torch.float32, device=q2.device)
    oi = torch.empty((b, topc), dtype=torch.int32, device=q2.device)
    ob = torch.empty((b, 1), dtype=torch.float32, device=q2.device)
    with torch.cuda.device(q2.device):
        err = _build.library().srt_scan_v3(
            q2.data_ptr(), b, f, ft.data_ptr(), ft.stride(0), np_, ncols, w,
            depth, topc, slice_, wv.data_ptr(), wi.data_ptr(), wb.data_ptr(),
            ov.data_ptr(), oi.data_ptr(), ob.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, f"scan_v3 (w={w}, depth={depth}, F={f}, slice={slice_})")
    scan_v3.launches += 1
    return ov, oi, ob


scan_v3.launches = 0   # kernel launches (CUDA tensors only)
