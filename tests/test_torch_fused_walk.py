"""Kernel 3's walk and plans (ops/cuda/fused.py, csrc/fused_topk.cu) on the
CPU: every column in exactly one split and one chunk of U groups, the
query tile a batch takes, the splits within the merge's limits, B = 1
filling an H100's SMs, the route by (k, B), the copy width a layout
allows, and the plain version's bf16 chain (one fused multiply-add a
step, as the card's __fmaf_rn) against exact arithmetic.  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from test_torch_ablation_contraction import exact_step, random_triples
from test_torch_fused_select import kernel3_args, tie_inputs

from spotify_recommender_tpu_torch.ops.cuda import fused
from spotify_recommender_tpu_torch.ops.cuda.fused import (
    SMALL_BATCH,
    SMALL_K_MAX,
    _large_plan,
    _splits,
    copy_width,
    fused_route,
    fused_topk_plain,
    kernel_dots,
    query_tile,
    tile,
    walk_chunks,
)
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2_plain

CPU = torch.device("cpu")
H100_SMS = 132


def _plans(b, np_, k):
    """((path, nsplit, split_cols, U), ...) of both paths' plans at (b, np,
    k) on a CPU device (the warp lists only at k <= SMALL_K_MAX)."""
    tq = query_tile(b)
    out = [("large", *_large_plan(b, np_, CPU, fq=12, k=k, exact=True,
                                  bf16=False)[1:3], tile(True, k, tq))]
    if k <= SMALL_K_MAX:
        out.append(("lists", *_splits(b, np_, CPU, k=k), tile(False, k, tq)))
    return out


@pytest.mark.parametrize("np_", [1, 127, 200, 1000, 2600, 20011, 10**6,
                                 10**7 + 3])
@pytest.mark.parametrize("b", [1, 5, 17, 1024])
@pytest.mark.parametrize("k", [10, 128, 1000])
def test_walk_covers_every_column_once(np_, b, k):
    """The splits tile [0, np) and each split's chunks tile the split, in
    ascending order, each at most U x 128 columns in ceil(cols / 128)
    groups; splits are whole 128-column groups (the last cut at np), so a
    chunk is short only at a split's end."""
    for path, nsplit, cols, u in _plans(b, np_, k):
        assert cols % 128 == 0 and nsplit * cols >= np_
        assert (nsplit - 1) * cols < max(np_, 1)
        if np_ > 10**6:                 # coverage checked by its edges
            splits = [0, nsplit - 1]
        else:
            splits = range(nsplit)
        seen = 0
        for s in splits:
            chunks = walk_chunks(np_, cols, u, s)
            begin, end = s * cols, min(np_, (s + 1) * cols)
            assert [c[0] for c in chunks] == list(range(begin, end, u * 128))
            for i, (c0, c1, groups) in enumerate(chunks):
                assert 0 < c1 - c0 <= u * 128
                assert groups == -(-(c1 - c0) // 128) and 1 <= groups <= u
                assert c1 - c0 == u * 128 or i == len(chunks) - 1
                seen += c1 - c0
            assert sum(c1 - c0 for c0, c1, _ in chunks) == end - begin
        if np_ <= 10**6:
            assert seen == np_, (path, nsplit, cols)


def test_walk_ragged_chunk_and_a_split_shorter_than_a_chunk():
    """A split of 200 columns is one chunk of 2 groups (U = 4); 1000
    columns in splits of 640: a full chunk and a one-group chunk, then a
    split of 360 columns in one chunk of 3 groups."""
    assert walk_chunks(200, 256, 4, 0) == [(0, 200, 2)]
    assert walk_chunks(1000, 640, 4, 0) == [(0, 512, 4), (512, 640, 1)]
    assert walk_chunks(1000, 640, 4, 1) == [(640, 1000, 3)]
    assert walk_chunks(1000, 640, 2, 1) == [(640, 896, 2), (896, 1000, 1)]


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 9, 16, 17, 128, 129, 1024])
def test_query_tile_and_instance_by_batch(b):
    """B <= SMALL_BATCH takes the 4-query tile (U = 4 on both paths); a
    larger batch the 16-query one, with U = 4 for the warp lists (k <=
    SMALL_K_MAX) and U = 2 for the large-k path (four blocks an SM)."""
    tq = query_tile(b)
    assert tq == (4 if b <= SMALL_BATCH else 16)
    for k in (1, 32, 33, SMALL_K_MAX):
        assert tile(False, k, tq) == 4
    assert tile(True, 1000, tq) == (4 if tq == 4 else 2)


@pytest.mark.parametrize("np_", [1000, 10**6, 2**31 - 2])
@pytest.mark.parametrize("b", [1, 4, 1024])
@pytest.mark.parametrize("k", [1, 10, 128, 129, 1000, 10**5])
def test_splits_stay_within_the_merge_limits(np_, b, k):
    """At most 65535 splits (the grid's y), nsplit x k keys a query below
    2^31 (the merge's select counts in int), nsplit x split_cols >= np."""
    for path, nsplit, cols, _ in _plans(b, np_, k):
        assert 1 <= nsplit <= 65535
        assert nsplit * k < 2**31
        assert nsplit * cols >= np_


@pytest.mark.parametrize("k", [1, 10, 64, 128])
def test_b1_grid_holds_a_block_per_h100_sm(k):
    """At B = 1 (one 4-query tile) both paths launch at least one block per
    SM of an H100 over 1M columns: the warp lists fill one wave of four
    blocks an SM (528), where the warp merge held them to 128."""
    for path, nsplit, cols, _ in _plans(1, 10**6, k):
        assert -(-1 // query_tile(1)) * nsplit >= H100_SMS, (path, nsplit)
    assert _splits(1, 10**6, CPU, k=k)[0] >= 4 * H100_SMS - 8


# the warp lists' largest k at each batch (fused.LISTS_MAX_K, as measured)
ROUTE_LIMITS = {1: 64, 2: 24, 4: 24, 7: 24, 8: 32, 9: 32, 16: 32, 17: 48,
                64: 48, 128: 48, 129: 48, 255: 48, 256: 64, 1024: 64,
                10**5: 64}


@pytest.mark.parametrize("b", sorted(ROUTE_LIMITS))
def test_route_boundaries(b):
    """The route by (k, B), at its boundaries: the warp lists up to the
    limit of the largest batch of LISTS_MAX_K at or below B, the large-k
    path above it and at every k above SMALL_K_MAX (the lists' largest,
    the table's largest limit)."""
    top = ROUTE_LIMITS[b]
    assert max(lim for _, lim in fused.LISTS_MAX_K) == SMALL_K_MAX
    for k in (1, 10, top):
        assert fused_route(k, b) == "lists"
    for k in (top + 1, SMALL_K_MAX + 1, 1000):
        assert fused_route(k, b) == "large"


def test_copy_width_by_layout():
    """16-byte copies on a contiguous transposed catalog whose row stride
    is a multiple of 16 bytes; 8 or 4 where the stride or the base is off
    that grid; one value a copy for a row-major window through `.t()` and
    for a bf16 slice at an odd column."""
    assert copy_width(torch.zeros(12, 1024)) == 16
    assert copy_width(torch.zeros(12, 1026)) == 8
    assert copy_width(torch.zeros(12, 20011)) == 4
    assert copy_width(torch.zeros(12, 1024)[:, 1:]) == 4
    assert copy_width(torch.zeros(12, 1024)[:, 2:]) == 8
    assert copy_width(torch.zeros(1024, 12).t()) == 0
    assert copy_width(torch.zeros(24, 1024, dtype=torch.bfloat16)) == 16
    assert copy_width(torch.zeros(24, 1024, dtype=torch.bfloat16)[:, 1:]) == 0
    assert copy_width(torch.zeros(1, 1000)[:, 4:]) == 16


def test_bf16_chain_is_one_rounding_a_step():
    """The plain version's bf16 chain (`kernel_dots`): the first product
    rounded, then acc + q[d] * f[d] rounded once to fp32 (as __fmaf_rn),
    against exact rational arithmetic, on products reaching below 2^-134;
    there a separate multiply would round first, and on these inputs it
    changes one sum's last bit."""
    _, a, b = random_triples(3000, seed=5)
    _, a2, b2 = random_triples(3000, seed=6)
    q = torch.from_numpy(np.stack([a, a2], 1)).to(torch.bfloat16)
    ft = torch.from_numpy(np.stack([b, b2], 0)).to(torch.bfloat16)
    got = torch.diagonal(kernel_dots(q, ft)).numpy()
    first = (a * b).astype(np.float32)
    want = np.array([exact_step(p, x, y) for p, x, y in zip(first, a2, b2)],
                    np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    mul_add = (first + (a2 * b2).astype(np.float32)).astype(np.float32)
    assert (mul_add.view(np.int32) != want.view(np.int32)).sum() >= 1


def test_bf16_chain_equals_mul_add_on_unit_rows():
    """On unit bf16 rows (every product far above 2^-134) the fused chain
    is the multiply-then-add chain bit for bit, so the tiers' answers, and
    their comparisons with the JAX package, are those of the chain before
    it; query column d meets catalog row d mod Fc ([qh, ql, ql, qh]
    against [hi; lo])."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 12)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for q, ft in ((torch.from_numpy(x[:9]).bfloat16(),
                   torch.from_numpy(x.T).bfloat16()),
                  (torch.from_numpy(np.tile(x[:9], 4)).bfloat16(),
                   torch.from_numpy(np.concatenate([x.T, x.T])).bfloat16())):
        fc = ft.shape[0]
        old = q.float()[:, 0:1] * ft.float()[0:1]
        for d in range(1, q.shape[1]):
            old = old + q.float()[:, d:d + 1] * ft.float()[d % fc:d % fc + 1]
        assert torch.equal(kernel_dots(q, ft), old)


@pytest.mark.parametrize("b", [1, 5, 17])
@pytest.mark.parametrize("kind", ["constant", "duplicates", "zero_norm"])
def test_plain_version_bf16x2_on_ties_is_stable(kind, b):
    """The plain version over bf16x2 operands of a tie-heavy catalog ([qh,
    ql, ql, qh] against [hi; lo] and against [hi; lo; hi; lo]): the two
    layouts give the same bits, the lowest column first on equal values."""
    feats, q, excl = tie_inputs(kind, 2600, b, seed=b)
    args = kernel3_args(feats, q, excl, exact=False)
    qu, qn, ft, norms = args[:4]
    qh, ql = split_bf16x2_plain(qu)
    q4 = torch.cat([qh, ql, ql, qh], dim=1)
    ft2 = torch.cat(split_bf16x2_plain(ft), dim=0)
    v2, i2 = fused_topk_plain(q4, qn, ft2, norms, args[4], 2590, k=33,
                              exact=False)
    v4, i4 = fused_topk_plain(q4, qn, torch.cat([ft2, ft2]), norms, args[4],
                              2590, k=33, exact=False)
    assert torch.equal(i2, i4) and torch.equal(v2, v4)
    for r in range(b):
        vals, cols = v2[r].tolist(), i2[r].tolist()
        for j in range(32):
            if vals[j] == vals[j + 1] and cols[j + 1] >= 0:
                assert cols[j] < cols[j + 1]
