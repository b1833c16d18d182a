"""Kernel 3 at k > 128 through every entry point that runs it, on the CPU
(its plain version), against the JAX package run in interpret mode (whose
kernel takes any k): `FusedRetriever` (fp32 exact and prenormalized, bf16,
bf16x2), `fused_score_topk`, the "pallas" `Retriever`, `PrefilterRetriever`,
`StreamingRetriever` and `ShardedCatalog(use_pallas=True)` on a [cpu] * 4
mesh, at k = 129, 300, the catalog's rows (`valid`) and valid + 37.

Tolerances: scores as tests/test_torch_fused.py holds them (exact mode
within 1e-6 abs, prenormalized within 1e-5 rel: the two packages sum the
fp32 dot in their own orders and take the query norm from their own
routines).  Indices are bitwise the JAX package's, JAX asked for k + 32
rows so that the row after the cut is known, but at the swaps listed in
SWAPS: there two rows whose JAX scores lie one ulp apart, inside the
tolerance, come the other way round in the port (its own sums order them
so).  Each such case is named with its (query, position) pairs, and the
test fails if a listed swap goes away or another one shows.  Bitwise, the
port is held to its own plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).  bf16 follows tests/test_torch_bf16.py's rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_select import tie_inputs

from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    FusedRetriever as JFusedRetriever,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    PrefilterRetriever as JPrefilterRetriever,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    fused_score_topk as jax_fused,
)
from spotify_recommender_tpu.parallel.sharding import ShardedCatalog as JSharded
from spotify_recommender_tpu.retrieval.streaming_retriever import (
    StreamingRetriever as JStreamingRetriever,
)
from spotify_recommender_tpu_torch.core.config import (
    MeshConfig,
    RetrievalConfig,
)
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops.cuda.fused import SMALL_K_MAX
from spotify_recommender_tpu_torch.ops.fused_topk import (
    FusedRetriever,
    PrefilterRetriever,
    fused_score_topk,
)
from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog
from spotify_recommender_tpu_torch.retrieval import StreamingRetriever
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

CPU = torch.device("cpu")
N = 3000
EXACT_ATOL = 1e-6
FAST_RTOL = 1e-5
JCFG = dict(query_tile=16, catalog_tile=1024)
KS = [129, 300, "valid", "valid+37"]
MORE = 32                 # JAX's rows past the port's k


def k_of(k, n=N):
    return {"valid": n, "valid+37": n + 37}.get(k, k)


def make_inputs(b, seed, data="random", n=N):
    """(features, queries, exclusions (-1 on odd queries)): catalog rows
    plus a little noise, or tie_inputs' duplicates (each query's row copied
    beside every 32nd column and the 1024-column edges)."""
    if data == "duplicates":
        return tie_inputs("duplicates", n, b, seed, edges=range(0, n, 1024))
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    q = feats[rows] + 0.01 * rng.standard_normal((b, 12)).astype(np.float32)
    excl = np.where(np.arange(b) % 2 == 0, rows, -1).astype(np.int64)
    return feats, q, excl


# (query, position p): the port holds JAX's rows p and p + 1 the other
# way round.  Seen on this file's inputs with JAX in interpret mode.
SWAPS = {
    "test_bf16_storage_matches_jax[bfloat16x2-valid+37]": [
        (0, 141), (0, 2487), (5, 1389), (7, 292), (7, 1107)],
    "test_bf16_storage_matches_jax[bfloat16x2-valid]": [
        (0, 1409), (3, 497), (3, 714), (3, 1574), (5, 1985), (5, 2020), (6,
        1022)],
    "test_fused_retriever_matches_jax[exact-valid+37-17]": [
        (3, 259), (3, 1969), (4, 2676), (5, 2205), (11, 2250), (14, 525), (15,
        1824)],
    "test_fused_retriever_matches_jax[exact-valid+37-1]": [
        (0, 337), (0, 2073)],
    "test_fused_retriever_matches_jax[exact-valid+37-8]": [
        (1, 1149), (2, 2323), (3, 1425), (5, 1891), (6, 2218)],
    "test_fused_retriever_matches_jax[exact-valid-17]": [
        (6, 156), (7, 870), (7, 1300), (7, 2605), (8, 1891), (9, 1088), (9,
        1885), (9, 2099), (12, 1242), (15, 336)],
    "test_fused_retriever_matches_jax[exact-valid-1]": [
        (0, 2327)],
    "test_fused_retriever_matches_jax[exact-valid-8]": [
        (0, 287), (2, 322), (2, 1162), (4, 231)],
    "test_fused_retriever_matches_jax[prenormalized-300-17]": [
        (10, 228)],
    "test_fused_retriever_matches_jax[prenormalized-300-8]": [
        (2, 250)],
    "test_fused_retriever_matches_jax[prenormalized-valid+37-17]": [
        (0, 1540), (1, 55), (3, 2337), (3, 2721), (4, 1567), (6, 10), (7,
        931), (9, 1803), (9, 2449), (10, 1434), (12, 1184), (12, 1554), (14,
        2417), (15, 1824)],
    "test_fused_retriever_matches_jax[prenormalized-valid+37-8]": [
        (4, 1150), (6, 1077)],
    "test_fused_retriever_matches_jax[prenormalized-valid-17]": [
        (2, 1251), (6, 156), (7, 870), (7, 1652), (7, 2605), (12, 1565), (15,
        336), (16, 357)],
    "test_fused_retriever_matches_jax[prenormalized-valid-8]": [
        (0, 287), (3, 1361)],
    "test_fused_score_topk_matches_jax[exact-valid+37]": [
        (0, 1889), (5, 2537), (6, 1255), (6, 1389)],
    "test_fused_score_topk_matches_jax[prenormalized-valid+37]": [
        (0, 1531), (0, 2056), (1, 2260), (2, 647), (3, 1080), (5, 2537), (6,
        1389)],
    "test_pallas_retriever_backend_at_large_k[valid+37]": [
        (0, 993), (3, 2232), (5, 438), (5, 1241), (6, 1510), (6, 1533), (6,
        1562), (6, 1614), (6, 1693), (6, 2325), (6, 2534), (7, 1337), (7,
        2411)],
    "test_pallas_retriever_backend_at_large_k[valid]": [
        (0, 993), (3, 2232), (5, 438), (5, 1241), (6, 1510), (6, 1533), (6,
        1562), (6, 1614), (6, 1693), (6, 2325), (6, 2534), (7, 1337), (7,
        2411)],
    "test_prefilter_retriever_at_large_candidate_counts[valid+37-64]": [
        (0, 2593), (3, 1158), (3, 1404)],
    "test_prefilter_retriever_at_large_candidate_counts[valid-64]": [
        (0, 2593), (3, 1158), (3, 1404)],
    "test_sharded_catalog_kernel3_backend_at_large_k[valid+37]": [
        (1, 613), (1, 2670), (5, 2908), (7, 1025), (10, 1840)],
    "test_sharded_catalog_kernel3_backend_at_large_k[valid]": [
        (1, 613), (1, 2670), (5, 2908), (7, 1025), (10, 1840)],
    "test_streaming_retriever_at_large_k[valid+37]": [
        (1, 1435), (1, 1696), (1, 2285), (2, 1956), (3, 2220), (4, 1252), (6,
        812), (6, 1788), (6, 1858), (6, 2539), (7, 567)],
    "test_streaming_retriever_at_large_k[valid]": [
        (1, 1435), (1, 1696), (1, 2285), (2, 1956), (3, 2220), (4, 1252), (6,
        812), (6, 1788), (6, 1858), (6, 2539), (7, 567)],
    "test_tie_heavy_catalog_matches_jax[300]": [
        (4, 56)],
    "test_tie_heavy_catalog_matches_jax[valid+37]": [
        (0, 1601), (1, 2402), (3, 351), (7, 667), (7, 1771), (10, 1116), (10,
        1349), (10, 2060), (11, 1456), (12, 868), (12, 955), (12, 1084), (12,
        1787), (13, 525), (13, 846), (14, 336), (14, 1827), (14, 2630), (15,
        870), (15, 1233)],
    "test_tie_heavy_catalog_matches_jax[valid]": [
        (1, 1235), (1, 1414), (1, 2383), (2, 1312), (3, 1818), (4, 230), (4,
        2510), (5, 623), (5, 2144), (5, 2861), (6, 168), (6, 1095), (6, 2330),
        (7, 1726), (10, 526), (12, 818), (13, 888), (13, 1393), (13, 2704)],
}


def assert_same(request, t, j, atol=0.0, rtol=0.0):
    """(scores, indices) of the port `t`, (B, k) numpy, against JAX's `j`,
    (B, >= k): indices bitwise but at this case's SWAPS, where JAX's two
    scores must lie within the tolerance of each other; the same unfilled
    slots (-inf, -1); finite scores within atol + rtol * |JAX's| of JAX's
    score of the same row."""
    (ts, ti), (js, ji) = t, j
    k = ti.shape[1]
    want_i, want_s = ji[:, :k].copy(), js[:, :k].copy()
    for r, p in SWAPS.get(request.node.name, ()):
        assert abs(js[r, p] - js[r, p + 1]) <= atol + rtol * abs(js[r, p])
        want_i[r, p], want_s[r, p] = ji[r, p + 1], js[r, p + 1]
        if p + 1 < k:
            want_i[r, p + 1], want_s[r, p + 1] = ji[r, p], js[r, p]
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(want_s))
    fin = np.isfinite(want_s)
    np.testing.assert_allclose(ts[fin], want_s[fin], rtol=rtol, atol=atol)


def jax_fused_retriever(feats, exact, dtype="float32"):
    return JFusedRetriever(feats, config=JConfig(
        exact_scores=exact, dtype=dtype, **JCFG), interpret=True)


def port(out):
    return out[0].numpy(), out[1].numpy()


def jnp_out(out):
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("b", [1, 8, 17])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "prenormalized"])
def test_fused_retriever_matches_jax(request, exact, k, b):
    k = k_of(k)
    feats, q, excl = make_inputs(b, seed=b + (k % 97))
    j = jnp_out(jax_fused_retriever(feats, exact)(
        jnp.asarray(q), k + MORE, jnp.asarray(excl, jnp.int32)))
    t = port(FusedRetriever(feats, None, RetrievalConfig(exact_scores=exact),
                            CPU)(q, k, excl))
    assert t[1].shape == (b, k) and t[0].dtype == np.float32
    tol = dict(atol=EXACT_ATOL) if exact else dict(rtol=FAST_RTOL)
    assert_same(request, t, j, **tol)
    assert not ((t[1] == excl[:, None]) & (excl[:, None] >= 0)).any()
    if k >= N:                       # every row, the excluded one left out
        assert ((t[1] == -1).sum(axis=1) == k - N + (excl >= 0)).all()


@pytest.mark.parametrize("k", KS)
def test_tie_heavy_catalog_matches_jax(request, k):
    """Duplicate rows beside every warp and split edge: equal scores, which
    both packages order by the lowest row."""
    k, b = k_of(k), 17
    feats, q, excl = make_inputs(b, seed=k % 89, data="duplicates")
    j = jnp_out(jax_fused_retriever(feats, True)(
        jnp.asarray(q), k + MORE, jnp.asarray(excl, jnp.int32)))
    t = port(FusedRetriever(feats, None, None, CPU)(q, k, excl))
    assert_same(request, t, j, atol=EXACT_ATOL)
    np.testing.assert_array_equal(t[1][:, :2], j[1][:, :2])   # the ties


@pytest.mark.parametrize("k", [129, "valid+37"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "prenormalized"])
def test_fused_score_topk_matches_jax(request, exact, k):
    k = k_of(k)
    feats, q, excl = make_inputs(8, seed=31)
    js, ji = jax_fused(jnp.asarray(q), feats, k=k + MORE,
                       config=JConfig(exact_scores=exact, **JCFG),
                       interpret=True,
                       exclude_rows=jnp.asarray(excl, jnp.int32))
    t = port(fused_score_topk(q, feats, k=k, exclude_rows=excl,
                              config=RetrievalConfig(exact_scores=exact),
                              device=CPU))
    tol = dict(atol=EXACT_ATOL) if exact else dict(rtol=FAST_RTOL)
    assert_same(request, t, jnp_out((js, ji)), **tol)


def _recall(i, ri):
    return np.mean([len(set(a) & set(c)) / len(c) for a, c in zip(i, ri)])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16x2"])
def test_bf16_storage_matches_jax(request, dtype, k):
    """tests/test_torch_bf16.py's rule: bf16 scores within 4e-3 and recall
    >= 0.9; bf16x2 scores within 1e-5 and indices as `assert_same` holds
    them."""
    k, b = k_of(k), 8
    feats, q, excl = make_inputs(b, seed=k % 83)
    j = jnp_out(jax_fused_retriever(feats, False, dtype)(
        jnp.asarray(q), k + MORE, jnp.asarray(excl, jnp.int32)))
    t = port(FusedRetriever(feats, None, RetrievalConfig(
        dtype=dtype, exact_scores=False), CPU)(q, k, excl))
    if dtype == "bfloat16":
        j = j[0][:, :k], j[1][:, :k]
        np.testing.assert_array_equal(t[1] == -1, j[1] == -1)
        fin = np.isfinite(j[0])
        np.testing.assert_allclose(t[0][fin], j[0][fin], rtol=0, atol=4e-3)
        assert _recall(t[1], j[1]) >= 0.9
    else:
        assert_same(request, t, j, atol=1e-5)
    assert not ((t[1] == excl[:, None]) & (excl[:, None] >= 0)).any()


def _catalog(feats):
    n = len(feats)
    ids = np.asarray([f"t{i}" for i in range(n)], dtype=object)
    return Catalog(feats, None, ids, ids, ids, np.zeros(n, np.int32), ["g"],
                   np.zeros(11, np.float32), np.ones(11, np.float32))


K_TIERS = [129, 200, 300, "valid", "valid+37"]


@pytest.mark.parametrize("k", K_TIERS)
def test_pallas_retriever_backend_at_large_k(request, k):
    k = k_of(k)
    feats, q, excl = make_inputs(8, seed=41)
    r = Retriever(_catalog(feats), RetrievalConfig(exact_scores=False), CPU)
    assert r.backend == "pallas"
    t = port(r.retrieve(q, k=k, exclude_rows=excl))
    j = jnp_out(jax_fused_retriever(feats, False)(
        jnp.asarray(q), k + MORE, jnp.asarray(excl, jnp.int32)))
    assert_same(request, t, j, rtol=FAST_RTOL)
    recs = r.recommend_by_index(3, k)       # row 3, itself excluded
    _, want = r.retrieve(feats[3:4], k=k, exclude_rows=[3])
    assert [x.row for x in recs] == want[0][want[0] >= 0].tolist()
    assert len(recs) == min(k, N - 1)


@pytest.mark.parametrize("k,prefilter", [(k, 64) for k in K_TIERS]
                         + [(10, 200)])
def test_prefilter_retriever_at_large_candidate_counts(request, k,
                                                       prefilter):
    """C = max(k, prefilter) above 128 (the old limit raised here): the
    bf16 prefilter's top-C and the exact rerank equal the JAX package's.
    JAX is asked for k rows: k + 32 would widen its C."""
    k = k_of(k)
    feats, q, excl = make_inputs(8, seed=43)
    jp = JPrefilterRetriever(feats, config=JConfig(**JCFG),
                             prefilter=prefilter, interpret=True)
    j = jnp_out(jp(jnp.asarray(q), k, jnp.asarray(excl, jnp.int32)))
    pr = PrefilterRetriever(feats, None, None, CPU, prefilter=prefilter)
    t = port(pr(q, k, excl))
    assert_same(request, t, j, atol=EXACT_ATOL)
    assert not ((t[1] == excl[:, None]) & (excl[:, None] >= 0)).any()


@pytest.mark.parametrize("k", K_TIERS)
def test_streaming_retriever_at_large_k(request, k):
    """Kernel 3 per window (use_fused's default) and the windows' merge:
    windows of 1000 rows, so that k = 300 and up spans windows, and k >=
    1000 asks a window for more rows than it has."""
    k = k_of(k)
    feats, q, excl = make_inputs(9, seed=47)
    sr = StreamingRetriever(feats, None, None, CPU, window=1000)
    assert sr.use_fused
    t = port(sr(q, k, exclude_rows=excl))
    js = JStreamingRetriever(feats, window=1000, use_fused=True)
    j = jnp_out(js(q, k + MORE, exclude_rows=excl.astype(np.int32)))
    assert_same(request, t, j, atol=EXACT_ATOL)


@pytest.mark.parametrize("k", K_TIERS)
def test_sharded_catalog_kernel3_backend_at_large_k(request, k):
    """ShardedCatalog(use_pallas=True) on a [cpu] * 4 mesh: kernel 3 per
    shard and the shards' deterministic merge, against the JAX package's
    sharded kernel-3 backend on its 4-device CPU mesh."""
    n, shards = 3001, 4
    k = k_of(k, n)
    feats, q, excl = make_inputs(12, seed=53, n=n)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    mesh = make_mesh(MeshConfig(catalog=shards), devices=[CPU] * shards)
    sc = ShardedCatalog(feats, norms, mesh, use_pallas=True,
                        config=RetrievalConfig(catalog_tile=128))
    assert sc.backend == "pallas"
    t = port(sc.retrieve(q, k, excl))
    jsc = JSharded(feats, norms, jmake_mesh(JMeshConfig(catalog=shards)),
                   interpret=True, use_pallas=True, query_tile=16,
                   catalog_tile=128)
    js, ji = jnp_out(jsc.retrieve(jnp.asarray(q), k + MORE,
                                  jnp.asarray(excl, jnp.int32)))
    # past the valid rows the JAX shards add their offset to the kernel's
    # -1 (ROADMAP 3c): its unfilled slots are (-inf, a row); the port's
    # are (-inf, -1), as every single-device tier's
    assert (np.isinf(js[:, :k]) == (t[1] == -1)).all()
    assert_same(request, t, (js, np.where(np.isinf(js), -1, ji)),
                atol=EXACT_ATOL)
    assert t[1].max() < n
    assert not ((t[1] == excl[:, None]) & (excl[:, None] >= 0)).any()


def test_the_large_k_path_starts_right_above_the_warp_lists():
    """k = SMALL_K_MAX and SMALL_K_MAX + 1 give the same first SMALL_K_MAX
    rows: the two paths of kernel 3 agree where they meet."""
    feats, q, excl = make_inputs(5, seed=59)
    fr = FusedRetriever(feats, None, None, CPU)
    s_top, i_top = fr(q, SMALL_K_MAX, excl)
    s_next, i_next = fr(q, SMALL_K_MAX + 1, excl)
    assert torch.equal(i_next[:, :SMALL_K_MAX], i_top)
    assert torch.equal(s_next[:, :SMALL_K_MAX], s_top)
