"""The port's fused score + top-k path on the CPU (kernel 3's plain
version) against the JAX package's `fused_score_topk` / `FusedRetriever`
run in interpret mode, the cases of tests/test_pallas_topk.py.

Indices must be equal.  Scores: in exact mode within 1e-6 abs, because
the JAX kernel sums the dot on XLA:CPU in its own order (an MXU-style
product for query tiles above 16 rows) while the port rounds each
multiply and add in ascending feature order; in prenormalized mode within
1e-5 rel, because the query norms behind the prenormalization come from
two libraries' norm routines and can differ by an ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_select import TIE_KINDS, tie_inputs

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    FusedRetriever as JFusedRetriever,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    fused_score_topk as jax_fused,
)
from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops.cuda.fused import (
    SMALL_K_MAX,
    fused_topk,
)
from spotify_recommender_tpu_torch.ops.fused_topk import (
    FusedRetriever,
    fused_score_topk,
)
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

CPU = torch.device("cpu")
EXACT_ATOL = 1e-6
FAST_RTOL = 1e-5
JCFG = dict(query_tile=16, catalog_tile=128)


def random_features(n, d=12, seed=0):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def both(q, feats, k, excl=None, exact=True, jcfg=None):
    """(JAX interpret-mode result, port result) as numpy arrays."""
    jc = JConfig(exact_scores=exact, **(jcfg or JCFG))
    js, ji = jax_fused(
        jnp.asarray(q), feats, k=k, config=jc, interpret=True,
        exclude_rows=None if excl is None else jnp.asarray(excl, jnp.int32),
    )
    ts, ti = fused_score_topk(q, feats, k=k, exclude_rows=excl,
                              config=RetrievalConfig(exact_scores=exact),
                              device=CPU)
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


def assert_same(j, t, exact=True):
    np.testing.assert_array_equal(t[1], j[1])
    if exact:
        np.testing.assert_allclose(t[0], j[0], rtol=0, atol=EXACT_ATOL)
    else:
        np.testing.assert_allclose(t[0], j[0], rtol=FAST_RTOL, atol=0)


class TestFusedAgainstJax:
    @pytest.mark.parametrize("n,b,k", [(500, 8, 10), (1000, 33, 7), (128, 5, 3)])
    def test_matches_jax(self, n, b, k):
        feats = random_features(n, seed=n)
        assert_same(*both(feats[:b], feats, k))

    def test_exclusion(self):
        feats = random_features(300, seed=1)
        excl = np.arange(12)
        j, t = both(feats[:12], feats, 10, excl=excl)
        assert_same(j, t)
        for i in range(12):
            assert i not in t[1][i]

    def test_unaligned_catalog(self):
        feats = random_features(137, seed=2)
        j, t = both(feats[:4], feats, 10)
        assert_same(j, t)
        assert t[1].max() < 137

    def test_zero_norm_rows_score_zero(self):
        # every real row scores < 0 against a negative query, so the
        # zero-norm row's guarded 0.0 is the best hit
        feats = random_features(200, seed=3) + 0.1
        feats[50] = 0.0
        q = -np.ones((2, 12), np.float32)
        j, t = both(q, feats, 3)
        assert_same(j, t)
        assert list(t[1][:, 0]) == [50, 50]
        assert (t[0][:, 0] == 0.0).all()

    def test_ties_prefer_lowest_index(self):
        feats = np.ones((64, 12), np.float32)
        j, t = both(feats[:1], feats, 5)
        assert_same(j, t)
        assert list(t[1][0]) == [0, 1, 2, 3, 4]

    def test_k_above_valid_columns_is_unfilled(self):
        feats = random_features(6, seed=6)
        j, t = both(feats[:3], feats, 10, excl=np.array([0, -1, 2]))
        assert_same(j, t)
        unfilled = t[1] == -1
        assert (unfilled.sum(axis=1) == [5, 4, 5]).all()
        assert (t[0][unfilled] == -np.inf).all()
        assert (t[0][~unfilled] > -np.inf).all()

    def test_multi_query_tiles(self):
        feats = random_features(256, seed=5)
        assert_same(*both(feats[:40], feats, 10))

    @pytest.mark.parametrize("seed", range(4))
    def test_random_shapes(self, seed):
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(50, 700))
        b = int(rng.integers(1, 40))
        k = int(rng.integers(1, min(20, n)))
        exact = bool(seed % 2)
        jcfg = dict(query_tile=int(rng.choice([8, 16, 24])),
                    catalog_tile=int(rng.choice([128, 256])))
        feats = rng.random((n, 12), dtype=np.float32)
        q = rng.random((b, 12), dtype=np.float32)
        excl = rng.integers(-1, n, size=b)
        j, t = both(q, feats, k, excl=excl, exact=exact, jcfg=jcfg)
        assert_same(j, t, exact=exact)


class TestTieHeavy:
    """The tie-heavy catalogs kernel 3's selection is held to on the card
    (a constant catalog, query rows duplicated across warp edges, zero
    rows among negative scores), against the JAX kernel."""

    @pytest.mark.parametrize("exact", [True, False])
    @pytest.mark.parametrize("kind", TIE_KINDS)
    def test_matches_jax(self, kind, exact):
        feats, q, excl = tie_inputs(kind, 700, 5, seed=8)
        j, t = both(q, feats, 33, excl=excl, exact=exact)
        assert_same(j, t, exact=exact)


class TestFastMode:
    def test_matches_jax_and_oracle(self):
        feats = random_features(2000, seed=11)
        q = feats[:16]
        j, t = both(q, feats, 10, exact=False)
        assert_same(j, t, exact=False)
        o_s, o_i = exact_topk(jnp.asarray(q), jnp.asarray(feats), k=10)
        np.testing.assert_array_equal(t[1], np.asarray(o_i))

    def test_zero_norm_query_and_rows(self):
        feats = random_features(300, seed=12) + 0.1
        feats[50] = 0.0
        q = np.zeros((1, 12), np.float32)
        j, t = both(q, feats, 3, exact=False)
        assert_same(j, t, exact=False)
        np.testing.assert_array_equal(t[0][0], np.zeros(3))


class TestRetrieverState:
    @pytest.mark.parametrize("exact", [True, False])
    def test_from_layout_of_the_jax_retriever(self, exact):
        feats = random_features(700, seed=21)
        rows = np.arange(0, 700, 50)
        jfr = JFusedRetriever(feats, config=JConfig(exact_scores=exact, **JCFG),
                              interpret=True)
        tfr = FusedRetriever.from_layout(
            np.asarray(jfr.features_t), np.asarray(jfr.norms), 700,
            RetrievalConfig(exact_scores=exact), CPU,
        )
        assert tfr.features_t.shape[1] > 700            # the TPU's padding
        js, ji = jfr(jnp.asarray(feats[rows]), 10, jnp.asarray(rows, jnp.int32))
        ts, ti = tfr(feats[rows], 10, rows)
        assert_same((np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy()),
                    exact=exact)
        own = FusedRetriever(feats, None, RetrievalConfig(exact_scores=exact), CPU)
        os_, oi = own(feats[rows], 10, rows)
        assert torch.equal(oi, ti) and torch.equal(os_, ts)

    def test_reused_retriever_multiple_batches(self):
        feats = random_features(400, seed=4)
        jfr = JFusedRetriever(feats, config=JConfig(**JCFG), interpret=True)
        tfr = FusedRetriever(feats, None, None, CPU)
        for b, seed in [(3, 0), (17, 1)]:
            q = np.random.default_rng(seed).random((b, 12)).astype(np.float32)
            js, ji = jfr(jnp.asarray(q), 10)
            ts, ti = tfr(q, 10)
            assert_same((np.asarray(js), np.asarray(ji)),
                        (ts.numpy(), ti.numpy()))

    @pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16x2"])
    def test_bf16_storage_not_ported(self, dtype):
        """bf16 storage cannot give the reference's exact scores: it needs
        `exact_scores=False`, as in the JAX package (tests/test_torch_bf16.py
        holds the storage itself)."""
        feats = random_features(100, seed=40)
        cfg = RetrievalConfig(dtype=dtype, exact_scores=True)
        with pytest.raises(ValueError, match="bfloat16"):
            FusedRetriever(feats, None, cfg, CPU)
        with pytest.raises(ValueError, match="bfloat16"):
            JFusedRetriever(feats, config=JConfig(dtype=dtype))

    def test_k_above_the_kernel_limit_raises(self):
        """k above the warp lists' SMALL_K_MAX no longer raises: kernel 3
        takes it on its large-k path, and the answer is the JAX kernel's
        at SMALL_K_MAX + 1 and past the catalog's 300 rows (unfilled
        slots (-inf, -1)).  Only k < 1 raises."""
        feats = random_features(300, seed=41)
        fr = FusedRetriever(feats, None, None, CPU)
        jfr = JFusedRetriever(feats, config=JConfig(**JCFG), interpret=True)
        for k in (SMALL_K_MAX + 1, 337):
            s, i = fr(feats[:2], k, np.arange(2))
            assert s.shape == i.shape == (2, k)
            js, ji = jfr(jnp.asarray(feats[:2]), k,
                         jnp.asarray(np.arange(2), jnp.int32))
            assert_same((np.asarray(js), np.asarray(ji)),
                        (s.numpy(), i.numpy()))
        assert ((i == -1).sum(dim=1) == 337 - 299).all()
        with pytest.raises(ValueError, match="k >= 1"):
            fr(feats[:2], 0)

    def test_one_shot_wrapper_runs_on_the_card_by_default(self):
        """`fused_score_topk` without a device asks for CUDA: on a card its
        results lie there; without one it raises (no CPU fallback)."""
        feats = random_features(200, seed=42)
        if torch.cuda.is_available():
            s, i = fused_score_topk(feats[:2], feats, k=3)
            assert s.device.type == "cuda" and i.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fused_score_topk(feats[:2], feats, k=3)

    def test_wrapper_rejects_bad_inputs(self):
        q = torch.zeros((2, 12))
        ft = torch.zeros((12, 30))
        n = torch.zeros(30)
        excl = torch.full((2,), -1)
        with pytest.raises(TypeError):
            fused_topk(q, n[:2], ft, n, excl.int(), 30, k=3, exact=True)
        with pytest.raises(ValueError):
            fused_topk(q, n[:2], ft[:11], n, excl, 30, k=3, exact=True)
        with pytest.raises(ValueError):
            fused_topk(q, n[:2], ft, n, excl, 30, k=0, exact=True)


def _catalog(n, seed):
    feats = random_features(n, seed=seed)
    ids = np.asarray([f"t{i}" for i in range(n)], dtype=object)
    return Catalog(feats, None, ids, ids, ids, np.zeros(n, np.int32), ["g"],
                   np.zeros(11, np.float32), np.ones(11, np.float32))


class TestRetrieverBackends:
    def test_fast_scores_build_the_pallas_backend(self):
        cat = _catalog(500, seed=30)
        r = Retriever(cat, RetrievalConfig(exact_scores=False), CPU)
        assert r.backend == "pallas" and r.fused is not None
        s, i = r.retrieve(cat.features[:8], k=5, exclude_rows=np.arange(8))
        j, t = both(cat.features[:8], cat.features, 5, excl=np.arange(8),
                    exact=False)
        assert_same(j, (s.numpy(), i.numpy()), exact=False)
        recs = r.recommend_by_index(3, 4)
        assert [x.row for x in recs] == i[3, :4].tolist()

    @pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16x2"])
    def test_bf16_still_raises_with_a_pointer(self, dtype):
        """bf16 storage no longer raises: the Retriever serves it with the
        approx tier (tests/test_torch_approx.py), not kernel 3."""
        r = Retriever(_catalog(500, seed=31),
                      RetrievalConfig(dtype=dtype, exact_scores=False), CPU)
        assert r.backend == "approx" and r.fused is None

    def test_exact_scores_keep_the_certified_backend(self):
        r = Retriever(_catalog(300, seed=32), None, CPU)
        assert r.backend == "certified" and r.fused is None
