"""Kernel 3's bf16 and bf16x2 storage instances, `FusedRetriever` over
them, `exact_rerank` and `PrefilterRetriever`: the port on the CPU (the
kernel's plain version) against an fp64 sum, the JAX package in interpret
mode and the oracle.

Tolerances.  Both packages add exact bf16 x bf16 products in fp32 (the
TPU's MXU; XLA:CPU's dot in interpret mode; the port's fixed-order chain),
so the port is held to an fp64 sum of its own bf16 operands within 1e-6.
Against JAX the queries are normalized by two libraries' norm routines,
which can differ by an ulp and so flip one query element's bf16 rounding:
a step of 2^-8 of that element, < 4e-3 on a cosine.  So bf16 scores are
compared within 4e-3 with recall >= 0.9; bf16x2 keeps 16 bits of every
element, so its scores are compared within 1e-5 (BF16X2_EPS is 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    FusedRetriever as JFusedRetriever,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    PrefilterRetriever as JPrefilterRetriever,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import _exact_rerank
from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.ops import similarity as tsim
from spotify_recommender_tpu_torch.ops.cuda.fused import (
    fused_topk,
    fused_topk_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2
from spotify_recommender_tpu_torch.ops.fused_topk import (
    FusedRetriever,
    PrefilterRetriever,
    exact_rerank,
)

CPU = torch.device("cpu")
DTYPES = ["bfloat16", "bfloat16x2"]
JCFG = dict(query_tile=16, catalog_tile=1024)


def make_data(seed, n=3000, b=16):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    q = feats[rows] + 0.01 * rng.standard_normal((b, 12)).astype(np.float32)
    return feats, rows, q


def fast(dtype, **kw):
    return RetrievalConfig(dtype=dtype, exact_scores=False, **kw)


def oracle(q, feats, k, excl=None):
    s, i = exact_topk(jnp.asarray(q), jnp.asarray(feats), k=k,
                      exclude_rows=None if excl is None else jnp.asarray(excl))
    return np.asarray(s), np.asarray(i)


def recall(i, ri):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(i, ri)])


def separated(s, gap):
    """Positions whose scores are more than `gap` from both neighbours."""
    d = np.diff(s, axis=1) < -gap
    edge = np.ones((len(s), 1), bool)
    sep = np.concatenate([edge, d], 1) & np.concatenate([d, edge], 1)
    sep[:, -1] = False         # the (k+1)-th value is unknown
    return sep


def query_operands(q, dtype):
    """The bf16 query operands `prepare_and_call` hands the kernel."""
    tq = torch.from_numpy(q)
    qn = tsim.row_norms(tq)
    qu = tq / qn.clamp_min(1e-30)[:, None]
    if dtype == "bfloat16":
        return qu.to(torch.bfloat16), qn
    qh, ql = split_bf16x2(qu)
    return torch.cat([qh, ql, ql, qh], dim=1), qn


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_equals_fp64_sum_of_the_bf16_operands(dtype):
    feats, rows, q = make_data(0)
    fr = FusedRetriever(feats, None, fast(dtype), CPU)
    assert fr.features_t.dtype == torch.bfloat16
    assert fr.features_t.shape == ((24 if dtype == "bfloat16x2" else 12), 3000)
    s, i = fr(q, 10, rows)
    qb, qn = query_operands(q, dtype)
    ft = fr.features_t.double()
    if dtype == "bfloat16x2":
        ft = torch.cat([ft, ft])           # [qh, ql, ql, qh] . [hi; lo; hi; lo]
    dots = (qb.double() @ ft).numpy()
    den = qn.numpy()[:, None].astype(np.float64) * fr.norms.numpy()[None, :]
    want = np.where(den > 1e-8, np.clip(dots, -1, 1), 0.0)
    want[np.arange(len(rows)), rows] = -np.inf
    got = np.take_along_axis(want, i.numpy(), 1)
    np.testing.assert_allclose(s.numpy(), got, rtol=0, atol=1e-6)
    order = np.argsort(-want, axis=1, kind="stable")[:, :10]
    sep = separated(np.take_along_axis(want, order, 1), 2e-6)
    np.testing.assert_array_equal(i.numpy()[sep], order[sep])


def test_plain_takes_four_or_two_planes_alike():
    """bf16x2 over [hi; lo] (the port's) and over the JAX package's
    [hi; lo; hi; lo] sums the same products in the same order: bitwise."""
    feats, rows, q = make_data(1)
    fr = FusedRetriever(feats, None, fast("bfloat16x2"), CPU)
    q2, qn = query_operands(q, "bfloat16x2")
    excl = torch.from_numpy(rows)
    args = (qn, fr.features_t, fr.norms, excl, 3000)
    a = fused_topk_plain(q2, *args, k=10, exact=False)
    four = torch.cat([fr.features_t, fr.features_t])
    b = fused_topk(q2, qn, four, fr.norms, excl, 3000, k=10, exact=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_matches_jax_fused_retriever(dtype):
    feats, rows, q = make_data(2)
    jfr = JFusedRetriever(feats, config=JConfig(dtype=dtype, exact_scores=False,
                                                **JCFG), interpret=True)
    js, ji = map(np.asarray, jfr(jnp.asarray(q), 10,
                                 jnp.asarray(rows, jnp.int32)))
    s, i = FusedRetriever(feats, None, fast(dtype), CPU)(q, 10, rows)
    s, i = s.numpy(), i.numpy()
    rs, ri = oracle(q, feats, 10, rows)
    if dtype == "bfloat16":
        np.testing.assert_allclose(s, js, rtol=0, atol=4e-3)
        assert recall(i, ji) >= 0.9 and recall(i, ri) >= 0.9
    else:
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)
        sep = separated(js, 2e-5)
        np.testing.assert_array_equal(i[sep], ji[sep])
        np.testing.assert_allclose(s, rs, rtol=0, atol=2e-5)
    assert not (i == rows[:, None]).any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_from_layout_of_the_jax_retriever(dtype):
    feats, rows, q = make_data(3, n=700)
    jfr = JFusedRetriever(feats, config=JConfig(dtype=dtype, exact_scores=False,
                                                **JCFG), interpret=True)
    cfg = fast(dtype)
    tfr = FusedRetriever.from_layout(np.asarray(jfr.features_t),
                                     np.asarray(jfr.norms), 700, cfg, CPU)
    own = FusedRetriever(feats, None, cfg, CPU)
    # the JAX layout, padded to its tile; bf16x2 keeps [hi; lo] of its 4
    assert tfr.features_t.shape[1] == 768 and tfr.feature_dim == 12
    assert torch.equal(tfr.features_t[:, :700], own.features_t)
    assert not tfr.features_t[:, 700:].any()
    a = tfr(q, 10, rows)
    b = own(q, 10, rows)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_from_layout_rejects_a_mismatched_dtype():
    feats = make_data(4, n=300)[0]
    jfr = JFusedRetriever(feats, config=JConfig(**JCFG), interpret=True)
    with pytest.raises(ValueError, match="does not match"):
        FusedRetriever.from_layout(np.asarray(jfr.features_t),
                                   np.asarray(jfr.norms), 300,
                                   fast("bfloat16"), CPU)


@pytest.mark.parametrize("reverse", [False, True])
def test_exact_rerank_on_jax_candidates(reverse):
    """The port's rerank of JAX `_exact_rerank`'s own candidates.  Duplicate
    rows tie on exact score; the earlier candidate wins, so reversing the
    candidate order reverses the winner in both packages alike."""
    feats, rows, q = make_data(5, b=8)
    feats[700] = feats[rows[0]]
    feats[2000] = feats[rows[0]]
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    jpr = JPrefilterRetriever(feats, config=JConfig(**JCFG), prefilter=32,
                              interpret=True)
    _, cand = jpr._approx(jnp.asarray(q), 32)
    cand = np.array(cand)
    cand[0, :3] = [rows[0], 700, 2000]      # three equal exact scores
    cand[1, -4:] = -1                       # empty prefilter slots
    if reverse:
        cand = cand[:, ::-1].copy()
    js, ji = _exact_rerank(jnp.asarray(q), jnp.asarray(cand),
                           jnp.asarray(feats), jnp.asarray(norms), k=10,
                           eps=1e-8)
    s, i = exact_rerank(torch.from_numpy(q), torch.from_numpy(cand),
                        torch.from_numpy(feats), torch.from_numpy(norms),
                        k=10, eps=1e-8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    first = [2000, 700, rows[0]] if reverse else [rows[0], 700, 2000]
    assert i[0, :3].tolist() == first


class TestPrefilterRetriever:
    def test_recall_and_exclusions(self):
        feats, rows, q = make_data(6, n=5000, b=32)
        pr = PrefilterRetriever(feats, None, None, CPU, prefilter=64)
        s, i = pr(q, 10, exclude_rows=rows)
        rs, ri = oracle(q, feats, 10, rows)
        assert recall(i.numpy(), ri) >= 0.99
        assert not (i.numpy() == rows[:, None]).any()
        agree = i.numpy() == ri
        np.testing.assert_allclose(s.numpy()[agree], rs[agree], rtol=0,
                                   atol=1e-6)

    def test_small_catalog_fills_with_the_catalog(self):
        feats, rows, q = make_data(7, n=20, b=3)
        pr = PrefilterRetriever(feats, None, None, CPU, prefilter=64)
        assert pr.prefilter == 20
        s, i = pr(q, 5, exclude_rows=rows)
        rs, ri = oracle(q, feats, 5, rows)
        np.testing.assert_array_equal(i.numpy(), ri)

    def test_candidates_beyond_the_kernel_limit_raise(self):
        """C = max(k, prefilter) = 200 candidates, above the old limit of
        128, no longer raises: kernel 3's large-k path gives the bf16
        top-200, and the rerank equals the JAX package's."""
        feats, rows, q = make_data(8, n=500, b=4)
        pr = PrefilterRetriever(feats, None, None, CPU, prefilter=200)
        s, i = pr(q, 10, rows)
        jp = JPrefilterRetriever(feats, config=JConfig(**JCFG),
                                 prefilter=200, interpret=True)
        js, ji = jp(jnp.asarray(q), 10, jnp.asarray(rows, jnp.int32))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-6)
        assert not (i.numpy() == rows[:, None]).any()
