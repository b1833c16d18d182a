"""The port's oracle and top-k merges against the JAX package and the
reference transcription in conftest.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reference_cpu_similarities, reference_topk

from spotify_recommender_tpu.ops import similarity as jsim
from spotify_recommender_tpu.ops import topk as jtopk
from spotify_recommender_tpu_torch.ops import similarity as tsim
from spotify_recommender_tpu_torch.ops import topk as ttopk

# fp32 dots and norms summed in another order than XLA's or numpy's: a few
# ulp on scores of magnitude <= 1
SCORE_ATOL = 2e-6


def _data(seed, n=3000, b=16, f=12):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, f), dtype=np.float32)
    feats[5] = 0.0                                   # zero-norm row: guard
    rows = rng.integers(0, n, b)
    q = feats[rows] + 0.01 * rng.standard_normal((b, f)).astype(np.float32)
    q[3] = 0.0                                       # zero-norm query
    return feats, q, rows


def test_cosine_scores_match_jax_and_reference():
    feats, q, _ = _data(0)
    got = tsim.cosine_scores_batched(
        torch.from_numpy(q), torch.from_numpy(feats)
    ).numpy()
    want = np.asarray(jsim.cosine_scores_batched(q, feats))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    for b in range(q.shape[0]):
        ref = reference_cpu_similarities(q[b], feats)
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=SCORE_ATOL)
    assert np.all(got[3] == 0.0) and np.all(got[:, 5] == 0.0)


def _separated(scores):
    """(B, k) mask of ranks whose score is more than SCORE_ATOL from both
    neighbours: there the index order cannot depend on summation order."""
    gaps = np.diff(scores, axis=1) < -SCORE_ATOL
    left = np.concatenate([np.ones((scores.shape[0], 1), bool), gaps], axis=1)
    right = np.concatenate([gaps, np.ones((scores.shape[0], 1), bool)], axis=1)
    return left & right


@pytest.mark.parametrize("fn", ["exact_topk", "exact_topk_iterative", "chunked"])
@pytest.mark.parametrize("excl", [False, True])
def test_exact_topk_variants_match_jax(fn, excl):
    feats, q, rows = _data(1)
    k = 10
    ex = rows if excl else None
    rs, ri = map(np.asarray, jsim.exact_topk(
        q, feats, exclude_rows=None if ex is None else jnp.asarray(ex), k=k
    ))
    tq, tf = torch.from_numpy(q), torch.from_numpy(feats)
    te = None if ex is None else torch.from_numpy(ex)
    if fn == "chunked":
        s, i = tsim.exact_topk_chunked(tq, tf, exclude_rows=te, k=k, chunk=700)
    else:
        s, i = getattr(tsim, fn)(tq, tf, exclude_rows=te, k=k)
    s, i = s.numpy(), i.numpy()
    np.testing.assert_allclose(s, rs, rtol=0, atol=SCORE_ATOL)
    sep = _separated(rs)
    np.testing.assert_array_equal(i[sep], ri[sep])
    assert sep.mean() > 0.5
    for b in range(q.shape[0]):
        if excl:
            assert rows[b] not in i[b]
        ref = reference_cpu_similarities(q[b], feats)
        want = reference_topk(ref, rows[b] if excl else -1, k)
        np.testing.assert_array_equal(i[b][sep[b]], np.asarray(want)[sep[b]])


@pytest.mark.parametrize("fn", ["exact_topk", "exact_topk_iterative", "chunked"])
def test_duplicate_rows_lowest_index_first(fn):
    rng = np.random.default_rng(2)
    feats = rng.random((2000, 12), dtype=np.float32)
    feats[[700, 1500, 1999]] = feats[40]
    q = torch.from_numpy(feats[40][None, :])
    tf = torch.from_numpy(feats)
    if fn == "chunked":
        _, i = tsim.exact_topk_chunked(q, tf, k=4, chunk=512)
    else:
        _, i = getattr(tsim, fn)(q, tf, k=4)
    assert i[0].tolist() == [40, 700, 1500, 1999]


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(3)
    # coarse scores so that ties are common
    sa = np.round(rng.random((8, 6)), 1).astype(np.float32)
    sb = np.round(rng.random((8, 5)), 1).astype(np.float32)
    ia = rng.integers(0, 100, (8, 6)).astype(np.int32)
    ib = rng.integers(100, 200, (8, 5)).astype(np.int32)
    js, ji = jtopk.merge_topk(sa, ia, sb, ib, 7)
    ts, ti = ttopk.merge_topk(*map(torch.from_numpy, (sa, ia, sb, ib)), 7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_merge_topk_deterministic_matches_jax():
    rng = np.random.default_rng(4)
    s = np.round(rng.random((8, 12)), 1).astype(np.float32)
    idx = np.stack([rng.permutation(1000)[:12] for _ in range(8)]).astype(np.int32)
    js, ji = jtopk.merge_topk_deterministic(s, idx, 5)
    ts, ti = ttopk.merge_topk_deterministic(
        torch.from_numpy(s), torch.from_numpy(idx), 5
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
