"""The port's approx tier (`ApproxRetriever`, the Retriever's "approx"
backend) on the CPU against the JAX package's `ApproxRetriever` in
interpret mode, and the two JAX faults it repairs against the port's exact
oracle.

The comparison with JAX uses features and queries that are multiples of
1/256: their squared norms are exact in fp32 in any summation order, so
both packages compute the same query norms and unit queries.  On arbitrary
fp32 queries the two norms can differ by an ulp, which can flip the
rounding of a lo plane and move an approx score by ~2e-6 (each package
stays within BF16X2_EPS of the exact score, which
`test_recall_and_score_bound` checks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.ops.pallas.fused_topk import (
    ApproxRetriever as JaxApprox,
)
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.fused_topk import (
    BF16X2_EPS,
    ApproxRetriever,
)
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

CPU = torch.device("cpu")
SCORE_ATOL = 1e-6     # approx scores against the JAX tier's
SEP = 2e-6            # indices compared where neighbours are further apart


def quantized(rng, shape):
    return (rng.integers(0, 256, shape) / 256).astype(np.float32)


def separated(scores, sep=SEP):
    """Positions whose neighbouring scores (both sides) are > `sep` apart;
    the last position's right neighbour is unknown, so it is left out."""
    gap = np.diff(scores, axis=1) < -sep
    edge = np.ones((len(scores), 1), bool)
    sep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
    sep[:, -1] = False
    return sep


def jax_approx(feats, q, k, excl):
    js, ji = JaxApprox(feats, interpret=True)(
        jnp.asarray(q), k,
        exclude_rows=None if excl is None else jnp.asarray(excl, jnp.int32))
    return np.asarray(js), np.asarray(ji)


def exact_scores(q, feats, rows):
    """The port's exact cosine (guard included) of each query's rows."""
    s = similarity.cosine_scores_batched(torch.from_numpy(q),
                                         torch.from_numpy(feats)).numpy()
    return np.take_along_axis(s, np.maximum(rows, 0), axis=1)


@pytest.mark.parametrize("n,b,k,exclude", [
    (5000, 64, 10, True),
    (1037, 5, 64, True),        # N unaligned to the 128-column tile
    (3000, 1, 1, False),
    (1037, 64, 1, True),
    (8200, 5, 10, False),       # two catalog tiles, the last one short
    (4133, 1, 64, True),
])
def test_matches_jax_interpret(n, b, k, exclude):
    rng = np.random.default_rng(n + b + k)
    feats = quantized(rng, (n, 12))
    rows = rng.integers(0, n, b).astype(np.int32)
    q = feats[rows] if exclude else quantized(rng, (b, 12))
    excl = rows if exclude else None
    ts, ti = ApproxRetriever(feats, None, None, CPU)(q, k, excl)
    ts, ti = ts.numpy(), ti.numpy()
    js, ji = jax_approx(feats, q, k, excl)
    assert ts.shape == ti.shape == (b, k)
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_ATOL)
    sep = separated(js)
    np.testing.assert_array_equal(ti[sep], ji[sep])
    assert ((ti >= 0) & (ti < n)).all()
    if exclude:
        assert not (ti == rows[:, None]).any()


def test_recall_and_score_bound():
    """Arbitrary fp32 data (JAX tests/test_pallas_topk.py:249-272): recall@10
    >= 0.99 against the port's fixed-order oracle, and the scores of the
    rows both return within BF16X2_EPS."""
    rng = np.random.default_rng(50)
    feats = rng.random((5000, 12), dtype=np.float32)
    q = feats[:64] + 0.01 * rng.standard_normal((64, 12)).astype(np.float32)
    s, i = ApproxRetriever(feats, None, None, CPU)(q, 10)
    os_, oi = similarity.exact_topk_iterative(
        torch.from_numpy(q), torch.from_numpy(feats), k=10, fixed_order=True)
    both = i[:, :, None] == oi[:, None, :]
    assert both.any(dim=2).float().mean().item() >= 0.99
    err = (s[:, :, None] - os_[:, None, :]).abs()[both].max().item()
    assert err <= BF16X2_EPS


def test_k_beyond_the_scan_capacity_raises_as_jax():
    rng = np.random.default_rng(52)
    feats = rng.random((2000, 12), dtype=np.float32)
    with pytest.raises(ValueError, match="scan_bins") as port:
        ApproxRetriever(feats, None, None, CPU)(feats[:4], 400)
    with pytest.raises(ValueError) as jax_err:
        JaxApprox(feats, interpret=True)(jnp.asarray(feats[:4]), 400)
    assert str(port.value) == str(jax_err.value)


def test_tiny_norm_rows_score_zero():
    """A row with qn * norm <= eps scores 0, as in the exact tier.  (The
    JAX tier stores the row as a unit vector and scores its cosine, ~1.)"""
    rng = np.random.default_rng(53)
    feats = rng.random((3000, 12), dtype=np.float32)
    q = feats[:4].copy()
    tiny = np.arange(100, 104)
    feats[tiny] = q * np.float32(1e-10)          # the queries' directions
    s, i = ApproxRetriever(feats, None, None, CPU)(q, 10)
    s, i = s.numpy(), i.numpy()
    assert not np.isin(i, tiny).any()            # they score 0, not ~1
    np.testing.assert_allclose(s, exact_scores(q, feats, i), rtol=0,
                               atol=BF16X2_EPS)
    # the exact oracle scores the tiny rows 0
    assert (exact_scores(q, feats, np.tile(tiny, (4, 1))) == 0).all()
    _, ji = jax_approx(feats, q, 10, None)
    # the JAX fault: each query's tiny copy ties with it at ~1
    assert all(t in ji[j, :2] for j, t in enumerate(tiny))


def test_anti_aligned_query_leaks_no_pad_index():
    """Every real cosine of an anti-aligned query is < 0, and the pad
    columns (score 0 on their zero planes) never enter the scan's bins:
    every slot holds a real row, within BF16X2_EPS of its exact score, and
    the oracle's top-k wherever the oracle's scores are more than
    2 * BF16X2_EPS apart.  (The JAX tier returns the pad indices.)"""
    rng = np.random.default_rng(54)
    n = 1037                                     # 115 pad columns
    feats = rng.random((n, 12), dtype=np.float32) + 0.01
    rows = np.arange(8)
    q = -feats[rows]
    s, i = ApproxRetriever(feats, None, None, CPU)(q, 10, rows)
    s, i = s.numpy(), i.numpy()
    assert ((i >= 0) & (i < n)).all() and not (i == rows[:, None]).any()
    assert (s < 0).all()
    np.testing.assert_allclose(s, exact_scores(q, feats, i), rtol=0,
                               atol=BF16X2_EPS)
    rs, ri = similarity.exact_topk(torch.from_numpy(q), torch.from_numpy(feats),
                                   exclude_rows=torch.from_numpy(rows), k=10)
    sep = separated(rs.numpy(), 2 * BF16X2_EPS)
    assert sep.sum() > 40
    np.testing.assert_array_equal(i[sep], ri.numpy()[sep])
    _, ji = jax_approx(feats, q, 10, rows)
    assert (ji >= n).any()                       # the JAX fault


def _catalog(feats):
    n = len(feats)
    ids = np.asarray([f"id{i}" for i in range(n)], object)
    return Catalog(feats, None, ids, ids, ids, np.zeros(n, np.int32), ["g"],
                   np.zeros(11, np.float32), np.ones(11, np.float32))


def test_recommend_by_index_never_reports_the_last_song():
    """Row 0 of a 6-row catalog at n = 10: the approx tier fills the 5 slots
    that the other rows can fill and leaves the rest (-inf, -1), and the -1
    rows are dropped (`track_ids[-1]` would report the last song again)."""
    rng = np.random.default_rng(55)
    feats = -(rng.random((6, 12), dtype=np.float32) + 0.01)
    feats[0] = -feats[0]
    r = Retriever(_catalog(feats), RetrievalConfig(dtype="bfloat16"), CPU)
    assert r.backend == "approx"
    _, i = r.retrieve_host(feats[:1], k=10, exclude_rows=np.zeros(1, np.int64))
    assert (i[0, 5:] == -1).all()
    rows = [x.row for x in r.recommend_by_index(0, 10)]
    assert sorted(rows) == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16x2"])
@pytest.mark.parametrize("exact_scores", [True, False])
def test_retriever_selects_the_approx_tier(dtype, exact_scores):
    """Any "bfloat16..." dtype selects the approx tier, as the JAX
    Retriever's `_select_backend` does; answers are the tier's."""
    rng = np.random.default_rng(56)
    feats = quantized(rng, (2000, 12))
    cfg = RetrievalConfig(dtype=dtype, exact_scores=exact_scores)
    r = Retriever(_catalog(feats), cfg, CPU)
    assert r.backend == "approx" and r.certified is None and r.fused is None
    rows = np.arange(0, 2000, 250)
    s, i = r.retrieve_host(feats[rows], k=10, exclude_rows=rows)
    ws, wi = ApproxRetriever(feats, None, cfg, CPU)(feats[rows], 10, rows)
    np.testing.assert_array_equal(i, wi.numpy())
    np.testing.assert_array_equal(s, ws.numpy())
    recs = r.recommend_by_id("id250", 5)
    assert [x.row for x in recs] == i[1, :5].tolist()


def test_the_device_holds_only_the_split_planes_and_norms():
    feats = np.random.default_rng(57).random((3000, 12), dtype=np.float32)
    ar = ApproxRetriever(feats, None, None, CPU)
    tensors = {k: v for k, v in vars(ar).items() if isinstance(v, torch.Tensor)}
    assert set(tensors) == {"ft", "nrm_row"}
    assert ar.ft.dtype == torch.bfloat16 and ar.ft.shape == (24, 3072)
    assert ar.nrm_row.shape == (3072,) and (ar.nrm_row[3000:] == 0).all()


def _masked_scan_reference(dots, n, w, depth, topc):
    """Top-`topc` of each bin's top-`depth` over the first `n` columns, by
    value descending then slot ascending (slot = level*w + bin), as numpy
    loops; columns >= n never enter a bin."""
    vals = np.full((len(dots), topc), -np.inf, np.float32)
    cols = np.full((len(dots), topc), -1, np.int64)
    for b, row in enumerate(dots):
        slots = []
        for bin_ in range(w):
            c = np.arange(bin_, n, w)
            order = c[np.lexsort((c, -row[c]))][:depth]
            slots += [(-row[col], lv * w + bin_, col)
                      for lv, col in enumerate(order)]
        for j, (v, _, col) in enumerate(sorted(slots)[:topc]):
            vals[b, j], cols[b, j] = -v, col
    return vals, cols


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_scan_v3_plain_with_ncols_agrees_with_the_unmasked_scan_on_real_columns(
        sign):
    """`scan_v3_plain(ncols=N)` keeps the pad columns out of the bins.  On
    queries aligned with the (positive) catalog every real column beats the
    pads' 0, so it equals the unmasked scan; anti-aligned, the unmasked
    scan's top slots are all pads and the masked scan's are real columns,
    as a reference built from the real columns alone gives them."""
    from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (
        scan_v3, scan_v3_plain, split_plane_dots)
    from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2
    from spotify_recommender_tpu_torch.ops.fused_topk import (
        build_certified_layout, layout_to_device)

    rng = np.random.default_rng(58)
    n, w, depth, topc = 1037, 128, 2, 32
    feats = rng.random((n, 12), dtype=np.float32) + 0.01
    ft = layout_to_device(build_certified_layout(feats, None, RetrievalConfig()),
                          CPU).ft
    q = torch.from_numpy(sign * feats[:6])
    qh, ql = split_bf16x2(q / similarity.row_norms(q)[:, None])
    q2 = torch.cat([qh, ql, ql, qh], 1)
    mv, mi, mb = scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc, ncols=n)
    uv, ui, ub = scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc)
    rv, ri = _masked_scan_reference(split_plane_dots(q2, ft).numpy(), n, w,
                                    depth, topc)
    np.testing.assert_array_equal(mv.numpy(), rv)
    np.testing.assert_array_equal(mi.numpy(), ri)
    assert ((mi >= 0) & (mi < n)).all() and torch.isfinite(mb).all()
    if sign > 0:
        for m, u in ((mv, uv), (mi, ui), (mb, ub)):
            assert torch.equal(m, u)
    else:
        assert (ui >= n).all() and (uv == 0).all()
    # the wrapper takes ncols in 0..Np, and on the CPU is the plain version
    out = scan_v3(q2, ft, w=w, depth=depth, topc=topc, ncols=n)
    assert all(torch.equal(a, b) for a, b in zip(out, (mv, mi, mb)))
    for bad in (-1, ft.shape[1] + 1):
        with pytest.raises(ValueError, match="ncols"):
            scan_v3(q2, ft, w=w, depth=depth, topc=topc, ncols=bad)
