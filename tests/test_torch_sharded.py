"""The port's row-sharded catalog (parallel/sharding.py) on the CPU, with
S shards of one catalog on one device (core/mesh.make_mesh over a
repeated device), against the JAX package's ShardedCatalog on the
conftest's 8-device CPU mesh (Pallas in interpret mode) and against the
port's single-device tiers.

Tolerances: indices equal; scores within 1e-6 of the JAX package's (the
port's oracle and certified rerank sum dots in fixed feature order, XLA in
its own), and bitwise equal between the port's sharded and single-device
answers (the same fixed-order sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh
from spotify_recommender_tpu.data.catalog import Catalog as JCatalog
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    build_certified_layout as jax_layout,
)
from spotify_recommender_tpu.parallel.sharding import ShardedCatalog as JSharded
from spotify_recommender_tpu.retrieval.retriever import Retriever as JRetriever
from spotify_recommender_tpu_torch.core.config import MeshConfig, RetrievalConfig
from spotify_recommender_tpu_torch.core.mesh import Mesh, make_mesh
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops.fused_topk import (
    CertifiedRetriever,
    build_certified_layout,
)
from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

CPU = torch.device("cpu")
SCORE_ATOL = 1e-6
BACKENDS = {
    "xla": ({}, {}),
    # the JAX test's small kernel tiles, in both packages (same layout)
    "pallas": ({"use_pallas": True,
                "config": RetrievalConfig(catalog_tile=128)},
               {"use_pallas": True, "query_tile": 16, "catalog_tile": 128}),
    "certified": ({"use_certified": True}, {"use_certified": True}),
}


def make_data(seed, n, b=12, f=12):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, f), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    rows = rng.integers(0, n, b)
    return feats, norms, rows


def cpu_mesh(catalog, data=1):
    return make_mesh(MeshConfig(data=data, catalog=catalog),
                     devices=[CPU] * (data * catalog))


def border_rows(rows, n_local, n):
    """`rows` with its first entries on and beside the shard borders."""
    border = [c * n_local + o for c in range(1, -(-n // n_local))
              for o in (-1, 0) if c * n_local + o < n]
    rows = rows.copy()
    rows[:len(border)] = border[:len(rows)]
    return rows


def jax_retrieve(feats, norms, shards, q, k, excl, backend, data=1):
    mesh = jmake_mesh(JMeshConfig(data=data, catalog=shards))
    sc = JSharded(feats, norms, mesh, interpret=True,
                  data_axis="data" if data > 1 else None,
                  **BACKENDS[backend][1])
    s, i = sc.retrieve(jnp.asarray(q), k,
                       None if excl is None else jnp.asarray(excl, jnp.int32))
    return np.asarray(s), np.asarray(i)


def single_certified(feats, norms, q, k, excl):
    s, i = CertifiedRetriever(feats, norms, None, CPU)(q, k, excl)
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_backend_matches_jax_and_single_device(backend, shards):
    """Unaligned N, exclusions on the shard borders: the port's shards
    equal the JAX package's and the single-device certified tier."""
    n, k = 3001, 10
    feats, norms, rows = make_data(shards, n)
    sc = ShardedCatalog(feats, norms, cpu_mesh(shards), **BACKENDS[backend][0])
    assert sc.backend == backend and sc.n_shards == shards
    rows = border_rows(rows, sc.n_local, n)
    q = feats[rows]
    s, i = sc.retrieve(q, k, rows)
    s, i = s.numpy(), i.numpy()
    assert i.max() < n and not (i == rows[:, None]).any()
    js, ji = jax_retrieve(feats, norms, shards, q, k, rows, backend)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=0, atol=SCORE_ATOL)
    rs, ri = single_certified(feats, norms, q, k, rows)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(s, rs)


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_retriever_on_a_mesh_equals_single_device(shards):
    """Retriever(mesh=make_mesh(MeshConfig(catalog=S), [cpu] * S)): the
    oracle per shard on the CPU, the same indices (and bits) as the
    single-device Retriever; recommend_by_* go through the shards."""
    n = 2500
    feats, norms, rows = make_data(40 + shards, n)
    ids = np.asarray([f"id{r}" for r in range(n)], dtype=object)
    cat = Catalog(feats, norms, ids, ids.copy(), ids.copy(),
                  np.zeros(n, np.int32), ["g"], np.zeros(11, np.float32),
                  np.ones(11, np.float32))
    sharded = Retriever(cat, None, CPU, mesh=cpu_mesh(shards))
    single = Retriever(cat, None, CPU)
    assert sharded.backend == ("sharded" if shards > 1 else "certified")
    s, i = sharded.retrieve_host(feats[rows], k=10, exclude_rows=rows)
    rs, ri = single.retrieve_host(feats[rows], k=10, exclude_rows=rows)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(s, rs)
    recs = sharded.recommend_by_id(f"id{rows[0]}", 5)
    assert [r.row for r in recs] == [r.row for r in
                                     single.recommend_by_id(f"id{rows[0]}", 5)]
    assert sharded.lookup(7).track_id == "id7"
    # the JAX Retriever on its 8-device CPU mesh (its sharded XLA oracle)
    jcat = JCatalog(feats, norms, ids, ids.copy(), ids.copy(),
                    np.zeros(n, np.int32), ["g"], np.zeros(11, np.float32),
                    np.ones(11, np.float32))
    jr = JRetriever(jcat, mesh=jmake_mesh(JMeshConfig(data=1, catalog=shards)))
    js, ji = jr.retrieve(jnp.asarray(feats[rows]), k=10,
                         exclude_rows=jnp.asarray(rows, jnp.int32))
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("data,catalog", [(2, 4), (4, 2)])
def test_2d_mesh_matches_jax(backend, data, catalog):
    """The batch split over "data", the rows over "catalog"."""
    n, k = 1003, 7
    feats, norms, rows = make_data(7, n, b=16)
    sc = ShardedCatalog(feats, norms, cpu_mesh(catalog, data),
                        data_axis="data", **BACKENDS[backend][0])
    s, i = sc.retrieve(feats[rows], k, rows)
    js, ji = jax_retrieve(feats, norms, catalog, feats[rows], k, rows,
                          backend, data=data)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=SCORE_ATOL)


def test_batch_must_divide_data_axis():
    feats, norms, _ = make_data(9, 640)
    sc = ShardedCatalog(feats, norms, cpu_mesh(4, 2), data_axis="data")
    with pytest.raises(ValueError, match="divide"):
        sc.retrieve(feats[:7], 5)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_layout_invariance(backend):
    feats, norms, rows = make_data(4, 3500)
    outs = [ShardedCatalog(feats, norms, cpu_mesh(s), **BACKENDS[backend][0])
            .retrieve(feats[rows], 25, rows) for s in (2, 3, 8)]
    for s, i in outs[1:]:
        assert torch.equal(i, outs[0][1]) and torch.equal(s, outs[0][0])


def test_layout_matches_jax_layout():
    """build_certified_layout(n_shards=8) pads as the JAX package's: the
    same W, depth, padded length, [hi; lo] planes and fp32 rows."""
    feats, norms, _ = make_data(11, 3000)
    lay = build_certified_layout(feats, norms, RetrievalConfig(), n_shards=8)
    jl = jax_layout(feats, norms, JConfig(), n_shards=8)
    assert (lay.w, lay.depth, lay.np_pad) == (jl.w, jl.depth, jl.np_pad)
    f = feats.shape[1]
    np.testing.assert_array_equal(lay.ft, np.asarray(jl.ft)[:2 * f])
    np.testing.assert_array_equal(lay.feats32, jl.feats32)
    np.testing.assert_array_equal(lay.norms1d, jl.norms1d)
    assert lay.rn_min == jl.rn_min
    assert (lay.np_pad // 8) % lay.w == 0


def test_every_shard_takes_the_global_rn_min_and_its_ncols():
    """A shard whose own rows have larger norms still certifies with the
    catalog's smallest nonzero norm, and scans only its real columns."""
    feats, norms, rows = make_data(12, 3000)
    feats[:10] *= np.float32(1e-3)           # tiny rows, all in shard 0
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    sc = ShardedCatalog(feats, norms, cpu_mesh(3), use_certified=True)
    shards = [sc._shards[(c, "cpu")] for c in range(3)]
    assert {s.layout.rn_min for s in shards} == {float(norms.min())}
    assert [s.num_items for s in shards] == [
        min(sc.n_local, 3000 - c * sc.n_local) for c in range(3)]
    s, i = sc.retrieve(feats[rows], 10, rows)
    rs, ri = single_certified(feats, norms, feats[rows], 10, rows)
    np.testing.assert_array_equal(i.numpy(), ri)


def test_fallbacks_are_summed_over_shards():
    """Top-10 crowded into one bin in every shard: each shard falls back
    to its oracle, the catalog counts the sum, the answer stays exact."""
    rng = np.random.default_rng(13)
    n, s_count = 4096, 2
    feats = rng.random((n, 12), dtype=np.float32)
    v = rng.random(12, dtype=np.float32)
    hot = np.arange(5, n, 128)                 # one bin (W = 128) per shard
    feats[hot] = v + 1e-4 * rng.standard_normal((hot.size, 12)).astype(
        np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    sc = ShardedCatalog(feats, norms, cpu_mesh(s_count), use_certified=True)
    s, i = sc.retrieve(v[None, :], 10)
    per_shard = sum(x.fallbacks for x in sc._shards.values())
    assert sc.fallbacks == per_shard and sc.fallbacks >= 1
    assert sc.escalations == sum(x.escalations for x in sc._shards.values())
    rs, ri = single_certified(feats, norms, v[None, :], 10, None)
    np.testing.assert_array_equal(i.numpy(), ri)
    js, ji = jax_retrieve(feats, norms, s_count, v[None, :], 10, None,
                          "certified")
    np.testing.assert_array_equal(i.numpy(), ji)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_shards_of_padding_only(backend):
    """300 rows over 8 shards: most shards hold no real row and return
    nothing; the answer is still the single device's."""
    feats, norms, rows = make_data(14, 300, b=5)
    sc = ShardedCatalog(feats, norms, cpu_mesh(8), **BACKENDS[backend][0])
    s, i = sc.retrieve(feats[rows], 10, rows)
    rs, ri = single_certified(feats, norms, feats[rows], 10, rows)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_allclose(s.numpy(), rs, rtol=0, atol=SCORE_ATOL)


def test_mesh_shape_and_repeated_devices():
    mesh = cpu_mesh(4, 2)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 2, "catalog": 4} and mesh.devices.size == 8
    assert all(d == CPU for d in mesh.devices.flat)
    assert not mesh.spans_processes
    with pytest.raises(ValueError, match="wants 9 devices"):
        make_mesh(MeshConfig(data=3, catalog=3), devices=[CPU] * 8)


def test_default_mesh_takes_the_cards():
    """make_mesh() spans the visible CUDA devices; without a card it has
    none to take and raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(ValueError, match="only 0 are visible"):
        make_mesh()
    with pytest.raises(ValueError, match="only 0 are visible"):
        make_mesh(MeshConfig(catalog=2))
