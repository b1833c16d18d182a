"""The port's certified tier on the CPU (plain kernel versions) against the
JAX package's oracle: the cases of tests/test_certified.py, plus the
Retriever around it.

In every case but the near-tie one (see there) the port's indices equal
`exact_topk` of the JAX package.  Scores: the rerank (a gathered batched product), the port's oracle and the
JAX oracle sum fp32 dots in different orders, so scores are compared
within 1e-6 (a few ulp at magnitude <= 1) unless the case pins them.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    build_certified_layout as jax_layout,
)
from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops import similarity as tsim
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import scan_v3
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2
from spotify_recommender_tpu_torch.ops.fused_topk import (
    BF16X2_EPS,
    CertifiedRetriever,
    build_certified_layout,
    layout_to_device,
)
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

CPU = torch.device("cpu")
SCORE_ATOL = 1e-6


def oracle(queries, feats, norms, k, excl=None):
    s, i = exact_topk(
        jnp.asarray(queries), jnp.asarray(feats), jnp.asarray(norms),
        exclude_rows=None if excl is None else jnp.asarray(excl), k=k,
    )
    return np.asarray(s), np.asarray(i)


def certified(feats, norms, q, k, config=None, excl=None):
    cr = CertifiedRetriever(feats, norms, config, CPU)
    s, i = cr(q, k, exclude_rows=excl)
    return cr, s.numpy(), i.numpy()


def make_data(seed, n, f=12, b=16):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, f), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    q = feats[rng.integers(0, n, b)] + 0.01 * rng.standard_normal(
        (b, f)).astype(np.float32)
    return feats, norms, q


def assert_matches_oracle(s, i, rs, ri):
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, rs, rtol=0, atol=SCORE_ATOL)


class TestCertifiedExactness:
    @pytest.mark.parametrize("n", [1000, 4133, 8192])
    def test_matches_oracle(self, n):
        feats, norms, q = make_data(n, n)
        cr, s, i = certified(feats, norms, q, 10)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 10))
        assert cr.fallbacks == 0

    def test_exclusions(self):
        feats, norms, _ = make_data(1, 5000)
        rows = np.random.default_rng(1).integers(0, 5000, 8).astype(np.int32)
        q = feats[rows]
        _, s, i = certified(feats, norms, q, 10, excl=rows)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 10, excl=rows))
        assert not np.any(i == rows[:, None])

    def test_k_larger_than_prefilter(self):
        feats, norms, q = make_data(2, 3000, b=4)
        _, s, i = certified(feats, norms, q, 50, RetrievalConfig(prefilter=8))
        np.testing.assert_array_equal(i, oracle(q, feats, norms, 50)[1])

    def test_k_beyond_scan_capacity_uses_oracle(self, caplog):
        feats, norms, q = make_data(3, 3000, b=4)
        # the package logger does not propagate to pytest's root handler
        logger = logging.getLogger("spotify_recommender_tpu_torch")
        logger.addHandler(caplog.handler)
        try:
            cr, s, i = certified(feats, norms, q, 300)   # > depth 2 * W 128
        finally:
            logger.removeHandler(caplog.handler)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 300))
        assert "exceeds the certified scan capacity" in caplog.text

    def test_large_k_on_negative_catalog_returns_no_pad_rows(self):
        """k beyond the scan capacity goes to the oracle over the real rows
        only.  (The JAX package's `_fallback` scores its 512-row-padded
        fp32 catalog there, so on a catalog whose real scores are all
        negative, zero pad rows, which score 0, enter its top-k.)"""
        rng = np.random.default_rng(18)
        n, f = 1000, 16                  # 1000: not a multiple of 512
        q = rng.random((2, f)).astype(np.float32) + 0.5
        feats = -(rng.random((n, f)).astype(np.float32) + 0.5)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        _, s, i = certified(feats, norms, q, 300)
        rs, ri = oracle(q, feats, norms, 300)
        np.testing.assert_allclose(s, rs, rtol=0, atol=SCORE_ATOL)
        # 300 deep in 1000 rows, some neighbours tie to the ulp: compare the
        # indices whose scores are more than 2e-6 from both neighbours
        gap = np.diff(rs, axis=1) < -2e-6
        edge = np.ones((len(rs), 1), bool)
        sep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
        np.testing.assert_array_equal(i[sep], ri[sep])
        assert sep.mean() > 0.5 and i.max() < n

    def test_zero_norm_query_and_rows(self):
        feats, norms, _ = make_data(4, 2000)
        feats[7] = 0.0
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        q = np.zeros((2, 12), np.float32)
        q[1] = feats[100]
        _, s, i = certified(feats, norms, q, 5)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 5))


def _one_bin_catalog(seed, num_hot, gap):
    """Top `num_hot` items in ONE scan bin (columns 13, 13+W, ...) with
    distinct descending cosines 1, 1-gap, 1-2*gap, ...: perturbations
    orthogonal to the query separate them by ~gap, well past the rerank's
    gap check.  The filler rows have mixed signs and score far lower.

    (tests/test_certified.py builds its hot rows as scaled copies of the
    query, whose cosines all round to ~1.0: their order is then decided by
    fp32 rounding, which differs between XLA's and torch's products.)"""
    rng = np.random.default_rng(seed)
    n, f, w = 8192, 12, 128
    feats = 0.01 * rng.standard_normal((n, f)).astype(np.float32)
    target = rng.random(f).astype(np.float32) + 1.0
    v = rng.standard_normal(f).astype(np.float32)
    v -= (v @ target) / (target @ target) * target
    v /= np.linalg.norm(v)
    tu = target / np.linalg.norm(target)
    hot = [13 + j * w for j in range(num_hot)]
    for rank, col in enumerate(hot):
        feats[col] = tu + np.float32(np.sqrt(2.0 * gap * rank)) * v
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    return feats, norms, target[None, :], hot


class TestAdversarial:
    def test_near_ties_within_eps_stay_exact(self):
        """Scores around the k-th boundary differ by less than BF16X2_EPS:
        the certificate must fail and the oracle must answer."""
        rng = np.random.default_rng(5)
        n, f = 4000, 12
        base = rng.random(f).astype(np.float32) + 0.5
        feats = np.tile(base, (n, 1))
        feats += (1e-7 * rng.standard_normal((n, f))).astype(np.float32)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        q = base[None, :].astype(np.float32)
        cr, s, i = certified(feats, norms, q, 10)
        assert cr.fallbacks >= 1      # the certificate must not bluff here
        # the scores tie to ~1e-7, so their order is decided by fp32
        # rounding, which differs between torch's and XLA's products: the
        # port is held to its own oracle (the certificate's contract) and to
        # the JAX oracle's scores
        ts, ti = tsim.exact_topk(torch.from_numpy(q), torch.from_numpy(feats),
                                 torch.from_numpy(norms), k=10)
        np.testing.assert_array_equal(i, ti.numpy())
        np.testing.assert_array_equal(s, ts.numpy())
        np.testing.assert_allclose(s, oracle(q, feats, norms, 10)[0], rtol=0,
                                   atol=SCORE_ATOL)

    def test_bin_collision_forces_fallback_stays_exact(self):
        feats, norms, q, hot = _one_bin_catalog(6, 6, 1e-4)
        cr, s, i = certified(feats, norms, q, 6)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 6))
        assert set(hot) == set(i[0].tolist())
        assert cr.fallbacks >= 1

    def test_eps_bound_holds_empirically(self):
        """|approx - exact| of the scan's own candidates stays below
        BF16X2_EPS: the certificate's soundness rests on this bound."""
        feats, norms, q = make_data(7, 8192, b=64)
        dl = layout_to_device(build_certified_layout(feats, norms,
                                                     RetrievalConfig()), CPU)
        tq = torch.from_numpy(q)
        qu = tq / torch.linalg.vector_norm(tq, dim=1, keepdim=True)
        qh, ql = split_bf16x2(qu)
        v, idx, _ = scan_v3(torch.cat([qh, ql, ql, qh], 1), dl.ft, w=128,
                            depth=2, topc=32)
        exact = np.clip((q @ feats.T) / (np.linalg.norm(q, axis=1)[:, None]
                                         * norms[None, :]), -1, 1)
        err = np.abs(v.numpy() - np.take_along_axis(exact, idx.numpy(), 1))
        assert err.max() < BF16X2_EPS


class TestGuardSoundness:
    def test_tiny_nonzero_norm_row_anti_correlated_query(self):
        """A tiny-nonzero-norm row (qn*rn <= 1e-8) has raw cosine -1 but an
        exact score pinned to 0 by the guard; with every other score
        negative, the guard-aware certificate must fail and the oracle must
        put the guarded row first."""
        rng = np.random.default_rng(8)
        n, f = 4096, 12
        q = rng.random(f).astype(np.float32) + 0.5
        feats = -q[None, :] + 0.3 * rng.standard_normal((n, f)).astype(np.float32)
        guarded = 3
        feats[guarded] = -q * np.float32(1e-12)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        assert 0 < norms[guarded] and norms[guarded] * np.linalg.norm(q) < 1e-8
        cr, s, i = certified(feats, norms, q[None, :], 3)
        assert_matches_oracle(s, i, *oracle(q[None, :], feats, norms, 3))
        assert i[0, 0] == guarded and s[0, 0] == 0.0
        assert cr.fallbacks >= 1

    def test_guard_aware_cert_no_false_fallback_on_positive(self):
        feats, norms, q = make_data(9, 4096, b=8)
        feats[11] *= np.float32(1e-12)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        cr, s, i = certified(feats, norms, q, 10)
        np.testing.assert_array_equal(i, oracle(q, feats, norms, 10)[1])
        assert cr.fallbacks == 0


class TestNegativeCatalogs:
    @pytest.mark.parametrize("n", [5000, 8192])
    def test_standard_normal_embeddings_match_oracle(self, n):
        rng = np.random.default_rng(n)
        feats = rng.standard_normal((n, 64)).astype(np.float32)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        q = rng.standard_normal((16, 64)).astype(np.float32)
        _, s, i = certified(feats, norms, q, 10)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 10))

    def test_all_negative_scores_with_exclusions_and_pads(self):
        rng = np.random.default_rng(10)
        n, f, b = 3333, 16, 8            # 3333: forces pad columns
        q = rng.random((b, f)).astype(np.float32) + 0.5
        feats = -(rng.random((n, f)).astype(np.float32) + 0.5)
        rows = rng.integers(0, n, b).astype(np.int32)
        feats[rows] = q
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        _, s, i = certified(feats, norms, q, 10, excl=rows)
        np.testing.assert_array_equal(
            i, oracle(q, feats, norms, 10, excl=rows)[1])
        assert not np.any(i == rows[:, None])
        assert np.all((i >= 0) & (i < n))


class TestDepthCollision:
    @pytest.mark.parametrize("config,n_hot", [
        (RetrievalConfig(scan_depth=2, scan_escalate=0), 3),
        (RetrievalConfig(scan_depth=3, scan_escalate=0), 4),
        (RetrievalConfig(), 4),          # beats depth 2 AND the depth-3 rescan
    ])
    def test_collision_past_depth_forces_fallback(self, config, n_hot):
        feats, norms, q, hot = _one_bin_catalog(11, n_hot, 1e-4)
        cr, s, i = certified(feats, norms, q, n_hot, config)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, n_hot))
        assert set(hot) == set(i[0].tolist())
        assert cr.fallbacks >= 1

    def test_default_config_is_escalating_depth2(self):
        cfg = RetrievalConfig()
        assert cfg.scan_depth == 2 and cfg.scan_escalate == 3


class TestTieSemantics:
    def test_duplicate_rows_lowest_index_wins(self):
        feats = np.random.default_rng(12).random((3000, 12), dtype=np.float32)
        feats[500] = feats[100]
        feats[2500] = feats[100]
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        _, _, i = certified(feats, norms, feats[100][None, :], 3)
        assert i[0].tolist() == oracle(feats[100][None, :], feats, norms, 3)[1][0].tolist()
        assert i[0, 0] == 100 and i[0].tolist().index(500) < i[0].tolist().index(2500)


class TestPlaneLayouts:
    @pytest.mark.parametrize("planes", [4, 2])
    def test_jax_built_layouts_match_oracle(self, planes):
        """One JAX-built layout (4 or 2 planes) fed to the port; the port's
        own 2-plane layout gives the same answers."""
        feats, norms, q = make_data(13, 6000, b=8)
        lay = jax_layout(feats, norms, JConfig(split_planes=planes))
        assert lay.planes == planes
        cr = CertifiedRetriever.from_layout(lay, len(feats), 12, None, CPU)
        s, i = cr(q, 10)
        _, s2, i2 = certified(feats, norms, q, 10)
        np.testing.assert_array_equal(i.numpy(), i2)
        assert_matches_oracle(s.numpy(), i.numpy(), *oracle(q, feats, norms, 10))


class TestEscalation:
    def test_bin_collision_resolved_by_escalation(self):
        cfg = RetrievalConfig(scan_depth=2, scan_escalate=4)
        feats, norms, q, hot = _one_bin_catalog(14, 4, 1e-3)
        cr, s, i = certified(feats, norms, q, 4, cfg)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 4))
        assert set(hot) == set(i[0].tolist())
        assert cr.escalations == 1       # the one query was rescanned
        assert cr.fallbacks == 0         # ...and the rescan certified it

    def test_escalation_still_exact_when_insufficient(self):
        cfg = RetrievalConfig(scan_depth=2, scan_escalate=3)
        feats, norms, q, hot = _one_bin_catalog(15, 6, 5e-4)
        cr, s, i = certified(feats, norms, q, 6, cfg)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 6))
        assert cr.escalations == 1 and cr.fallbacks == 1

    def test_random_batch_escalation_matches_oracle(self):
        rng = np.random.default_rng(16)
        n, b = 8192, 64
        feats = rng.random((n, 12), dtype=np.float32)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        rows = rng.integers(0, n, size=b)
        q = feats[rows] + rng.normal(0, 0.01, (b, 12)).astype(np.float32)
        _, s, i = certified(feats, norms, q, 10, excl=rows)
        assert_matches_oracle(s, i, *oracle(q, feats, norms, 10, excl=rows))


class TestRetriever:
    @pytest.fixture
    def catalog(self):
        feats, norms, _ = make_data(17, 2500)
        n = len(feats)
        ids = np.asarray([f"id{r}" for r in range(n)], dtype=object)
        return Catalog(feats, norms, ids, ids.copy(), ids.copy(),
                       np.zeros(n, np.int32), ["g"], np.zeros(11, np.float32),
                       np.ones(11, np.float32))

    @pytest.mark.parametrize("use_pallas,backend", [(True, "certified"),
                                                    (False, "oracle")])
    def test_backends_match_oracle(self, catalog, use_pallas, backend):
        r = Retriever(catalog, RetrievalConfig(use_pallas=use_pallas), CPU)
        assert r.backend == backend
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        rows = np.arange(0, 2500, 250)
        s, i = r.retrieve_host(catalog.features[rows], k=10, exclude_rows=rows)
        rs, ri = oracle(catalog.features[rows], catalog.features, catalog.norms,
                        10, excl=rows)
        assert_matches_oracle(s, i, rs, ri)
        recs = r.recommend_by_id("id250", 5)
        assert [x.row for x in recs] == ri[1, :5].tolist()

    @pytest.mark.parametrize("kwargs,match", [
        ({"config": RetrievalConfig(dtype="bfloat16", exact_scores=False)},
         "approx"),
        ({"mesh": object()}, "mesh"),
    ])
    def test_unported_options_raise(self, catalog, kwargs, match):
        kwargs.setdefault("config", None)
        with pytest.raises(NotImplementedError, match=match):
            Retriever(catalog, device=CPU, **kwargs)

    def test_cuda_without_a_card_raises(self, catalog):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Retriever(catalog, None, "cuda")
