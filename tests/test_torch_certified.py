"""The port's certified tier on the CPU (plain kernel versions) against the
JAX package's oracle: the cases of tests/test_certified.py, plus the
Retriever around it.

In every case but the near-tie one (see there) the port's indices equal
`exact_topk` of the JAX package.  Scores: the port's rerank and its
certified oracle (kernel 3, here its plain version) both sum in fixed
feature order (`similarity.fixed_order_dots`), the JAX oracle in XLA's,
so scores are compared within 1e-6 (a few ulp at magnitude <= 1) unless
the case pins them.
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
from spotify_recommender_tpu_torch.core.config import MeshConfig, RetrievalConfig
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops import fused_topk as tft
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


class TestPinnedExamples:
    def test_hypothesis_example_52667(self):
        """The example that Hypothesis drew for the JAX package's
        tests/test_property.py::test_always_matches_oracle (seed 52667, n
        1119, dup_frac 0.3, scale 1e-4, 8 self-excluded catalog-row
        queries, k 10), built as that test builds it.  There the JAX
        oracle returns row 703 at query 1, slot 9, where the JAX certified
        tier returns 484 (scores 0.9279501 and 0.9279502, a near-tie).  The
        port's certified tier is held to its fixed-order oracle, bitwise,
        and to the JAX certified tier: indices equal, scores within 1e-6."""
        from spotify_recommender_tpu.ops.pallas.fused_topk import (
            CertifiedRetriever as JaxCertified,
        )

        rng = np.random.default_rng(52667)
        n = 1119
        feats = (1e-4 * rng.random((n, 12))).astype(np.float32)
        ndup = int(0.3 * n)
        src = rng.integers(0, n, ndup)
        dst = rng.integers(0, n, ndup)
        feats[dst] = feats[src]
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        rows = rng.integers(0, n, 8).astype(np.int32)
        q = feats[rows]
        cr, s, i = certified(feats, norms, q, 10, excl=rows)
        fs, fi = tsim.exact_topk_iterative(
            torch.from_numpy(q), torch.from_numpy(feats),
            torch.from_numpy(norms), torch.from_numpy(rows), k=10,
            fixed_order=True)
        np.testing.assert_array_equal(i, fi.numpy())
        np.testing.assert_array_equal(s, fs.numpy())
        js, ji = JaxCertified(feats, norms, interpret=True)(
            q, 10, exclude_rows=rows)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=SCORE_ATOL)
        assert i[1, 9] == 484
        assert not np.any(i == rows[:, None])

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
        # rounding, which differs between the fixed feature order and XLA's
        # product: the port is held to its own fixed-order oracle (the
        # certificate's contract), bitwise, and to the JAX oracle's scores
        ts, ti = tsim.exact_topk_iterative(
            torch.from_numpy(q), torch.from_numpy(feats),
            torch.from_numpy(norms), k=10, fixed_order=True)
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


def fixed_order_oracles(q, feats, norms, k, excl=None):
    """The fixed-order fp32 oracle both ways, as torch tensors: the k
    rounds of argmax, and the catalog in ascending chunks merged."""
    args = (torch.from_numpy(q), torch.from_numpy(feats),
            torch.from_numpy(norms))
    ex = None if excl is None else torch.from_numpy(np.asarray(excl))
    return (tsim.exact_topk_iterative(*args, exclude_rows=ex, k=k,
                                      fixed_order=True),
            tsim.exact_topk_chunked(*args, exclude_rows=ex, k=k, chunk=1024,
                                    fixed_order=True))


def assert_bitwise_fixed_order(s, i, q, feats, norms, k, excl=None):
    """Indices and score bits identical to both fixed-order oracles."""
    for rs, ri in fixed_order_oracles(q, feats, norms, k, excl):
        np.testing.assert_array_equal(i, ri.numpy())
        np.testing.assert_array_equal(s.view(np.int32),
                                      rs.numpy().view(np.int32))


def oracle_case(data, f, seed=20, n=3000, b=6):
    """Catalog rows and queries: uniform rows and queries near them, or
    "ties": 40 rows copies of row 5 (the first query is row 5 itself),
    three zero-norm rows and a zero-norm query."""
    rng = np.random.default_rng(seed + f)
    feats = rng.random((n, f), dtype=np.float32)
    rows = rng.integers(0, n, b)
    q = feats[rows] + 0.01 * rng.standard_normal((b, f)).astype(np.float32)
    if data == "ties":
        feats[rng.choice(np.arange(6, n), 40, replace=False)] = feats[5]
        feats[[0, 17, n - 1]] = 0.0
        rows[0] = 5
        q[0] = feats[5]
        q[1] = 0.0
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    return feats, norms, q, rows


@pytest.fixture
def kernel3_calls(monkeypatch):
    """The queries of each kernel-3 call the certified tier makes (its
    oracle), in order."""
    calls = []
    real = tft.fused_topk

    def counted(queries, *args, **kw):
        calls.append(queries.shape[0])
        return real(queries, *args, **kw)

    monkeypatch.setattr(tft, "fused_topk", counted)
    return calls


class TestOracleOnKernel3:
    """The oracle (k > depth x W, and the fallbacks) answers on kernel 3:
    bitwise the fixed-order oracle's, one call a batch that needs it, on
    those queries alone.  On the CPU kernel 3 is its plain version,
    `fused_topk_plain`."""

    @pytest.mark.parametrize("data", ["uniform", "ties"])
    @pytest.mark.parametrize("excl", [False, True])
    @pytest.mark.parametrize("f", [12, 64])
    @pytest.mark.parametrize("k", [257, 1000])     # depth 2 x W 128 = 256
    def test_k_beyond_the_scan_bitwise_fixed_order(self, k, f, excl, data,
                                                   kernel3_calls):
        feats, norms, q, rows = oracle_case(data, f)
        ex = rows if excl else None
        cr, s, i = certified(feats, norms, q, k, excl=ex)
        assert_bitwise_fixed_order(s, i, q, feats, norms, k, ex)
        assert kernel3_calls == [len(q)]
        assert cr.fallbacks == cr.escalations == 0
        if excl:
            assert not np.any(i == rows[:, None])
        if data == "ties":
            # row 5's copies first, the lowest index first
            copies = [r for r in np.flatnonzero((feats == feats[5]).all(1))
                      if not (excl and r == 5)]
            assert i[0, :len(copies)].tolist() == copies
            assert (s[1] == 0.0).all()       # the zero-norm query

    @pytest.mark.parametrize("case", [
        "collision", "depth2", "escalation_short", "margin_f12",
        "margin_f64_excl", "margin_ties", "none"])
    def test_fallbacks_bitwise_fixed_order(self, case, kernel3_calls):
        """Queries whose certificate fails go to kernel 3: a top-k in one
        bin (the collision fixtures), or every query of a batch under an
        impossible certificate margin; one call on the `.fallbacks`
        queries, and none where nothing falls back."""
        config, excl = None, None
        if case in ("collision", "depth2", "escalation_short"):
            seed, n_hot, gap, config = {
                "collision": (6, 6, 1e-4, None),
                "depth2": (11, 3, 1e-4,
                           RetrievalConfig(scan_depth=2, scan_escalate=0)),
                "escalation_short": (15, 6, 5e-4,
                                     RetrievalConfig(scan_depth=2,
                                                     scan_escalate=3)),
            }[case]
            feats, norms, q, _ = _one_bin_catalog(seed, n_hot, gap)
            # the hot query beside catalog rows that certify
            q = np.concatenate([feats[[100, 2000, 5000]], q])
            k = n_hot
        else:
            f = 64 if case == "margin_f64_excl" else 12
            feats, norms, q, rows = oracle_case(
                "ties" if case == "margin_ties" else "uniform", f)
            excl = rows if case in ("margin_f64_excl", "margin_ties") else None
            if case != "none":
                config = RetrievalConfig(certify_eps=10.0)
            k = 10
        cr, s, i = certified(feats, norms, q, k, config, excl=excl)
        assert_bitwise_fixed_order(s, i, q, feats, norms, k, excl)
        if case == "none":
            assert cr.fallbacks == 0
        elif case.startswith("margin"):
            assert cr.fallbacks == len(q)
        else:
            assert cr.fallbacks == 1
        assert kernel3_calls == ([cr.fallbacks] if cr.fallbacks else [])

    @pytest.mark.parametrize("n,k,margin", [
        (300, 300, False),      # k > depth x W, k = N: the start's oracle
        (300, 320, False),      # k > N
        (200, 200, True),       # every query a fallback at k = N
    ])
    def test_k_at_the_row_count_leaves_unfilled_slots_empty(self, n, k,
                                                            margin,
                                                            kernel3_calls):
        """Where k reaches the row count some slot has no row: kernel 3
        answers there too, and the slots no row fills are (-inf, -1), as
        the chunked fixed-order oracle's; every filled slot is its row,
        bit for bit."""
        feats, norms, q, rows = oracle_case("uniform", 12, n=n, b=4)
        config = RetrievalConfig(certify_eps=10.0) if margin else None
        cr, s, i = certified(feats, norms, q, k, config, excl=rows)
        _, (rs, ri) = fixed_order_oracles(q, feats, norms, k, rows)
        np.testing.assert_array_equal(i, ri.numpy())
        np.testing.assert_array_equal(s.view(np.int32),
                                      rs.numpy().view(np.int32))
        empty = i == -1
        assert (empty.sum(axis=1) == k - (n - 1)).all()   # n - 1 rows each
        assert np.isneginf(s[empty]).all() and np.isfinite(s[~empty]).all()
        assert kernel3_calls == [len(q)]
        assert cr.fallbacks == (len(q) if margin else 0)


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
        if match == "approx":
            # ported since: bf16 storage selects the approx tier
            assert Retriever(catalog, device=CPU, **kwargs).backend == "approx"
            return
        # ported since: a mesh row-shards the catalog (parallel/sharding.py);
        # an object that is not a mesh still raises
        with pytest.raises(AttributeError, match="shape"):
            Retriever(catalog, device=CPU, **kwargs)
        mesh = make_mesh(MeshConfig(catalog=2), devices=[CPU] * 2)
        r = Retriever(catalog, None, CPU, mesh=mesh)
        assert r.backend == "sharded"
        rows = np.arange(0, 2500, 500)
        s, i = r.retrieve_host(catalog.features[rows], k=10, exclude_rows=rows)
        assert_matches_oracle(s, i, *oracle(catalog.features[rows],
                                            catalog.features, catalog.norms,
                                            10, excl=rows))

    def test_cuda_without_a_card_raises(self, catalog):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Retriever(catalog, None, "cuda")
