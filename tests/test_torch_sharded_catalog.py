"""The port's sharded catalog artifact (data/sharded_catalog.py, per-shard
``.npy`` row blocks under layout ``npy-shards-v1``) and
`ShardedCatalog.from_artifact`, against the JAX package's artifact and
sharded retrieval on its 8-device CPU mesh: the round trip, the sidecar,
an indivisible mesh axis, and retrieval from the artifact."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh
from spotify_recommender_tpu.data.catalog import Catalog as JCatalog
from spotify_recommender_tpu.data.sharded_catalog import (
    load_sharded_catalog as jload,
    save_sharded_catalog as jsave,
)
from spotify_recommender_tpu.parallel.sharding import ShardedCatalog as JSharded
from spotify_recommender_tpu_torch.core.config import MeshConfig
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.data.sharded_catalog import (
    LAYOUT,
    load_sharded_catalog,
    save_sharded_catalog,
)
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(3)
    n = 700
    feats = rng.random((n, 12), dtype=np.float32)
    return Catalog(
        features=feats,
        norms=np.linalg.norm(feats, axis=1).astype(np.float32),
        track_ids=np.asarray([f"tid{i:05d}" for i in range(n)], object),
        track_names=np.asarray([f"Song {i}" for i in range(n)], object),
        artists=np.asarray([f"Artist {i % 7}" for i in range(n)], object),
        genre_ids=(np.arange(n) % 5).astype(np.int32),
        genre_names=[f"g{j}" for j in range(5)],
        min_vals=np.zeros(11, np.float32),
        max_vals=np.ones(11, np.float32),
    )


def cpu_mesh(shards):
    return make_mesh(MeshConfig(catalog=shards), devices=[CPU] * shards)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_round_trip_reads_each_shards_rows(catalog, tmp_path, shards):
    path = str(tmp_path / "cat")
    save_sharded_catalog(catalog, path, shard_multiple=1024)
    art = load_sharded_catalog(path, cpu_mesh(shards))
    assert len(art) == len(catalog) and art.padded_rows == 1024
    n_local = 1024 // shards
    feats = np.concatenate([art.shard(c, shards)[0] for c in range(shards)])
    norms = np.concatenate([art.shard(c, shards)[1] for c in range(shards)])
    assert feats.shape == (1024, 12)
    np.testing.assert_array_equal(feats[:700], catalog.features)
    np.testing.assert_array_equal(norms[:700], catalog.norms)
    assert not feats[700:].any() and not norms[700:].any()  # zero pad rows
    np.testing.assert_array_equal(art.rows("genre_ids", 0, 700),
                                  catalog.genre_ids)
    # a shard inside one block is a read-only memmap view, nothing copied
    f0 = art.shard(0, shards)[0]
    assert f0.shape == (n_local, 12)
    if n_local <= art.padded_rows // art.meta["files"]:
        assert isinstance(f0, np.memmap) and not f0.flags.writeable
    assert art.genre_names == catalog.genre_names


def test_files_are_row_blocks_of_the_jax_arrays(catalog, tmp_path):
    """The same padded numeric arrays as the JAX package's OCDBT artifact,
    split into row blocks of one .npy each."""
    path, jpath = tmp_path / "t", tmp_path / "j"
    save_sharded_catalog(catalog, str(path), shard_multiple=1024)
    jsave(JCatalog(**{f: getattr(catalog, f) for f in (
        "features", "norms", "track_ids", "track_names", "artists",
        "genre_ids", "genre_names", "min_vals", "max_vals")}),
        str(jpath), shard_multiple=1024)
    meta = json.loads((path / "meta.json").read_text())
    jmeta = json.loads((jpath / "meta.json").read_text())
    assert meta["layout"] == LAYOUT and jmeta["layout"] == "ocdbt-v1"
    for key in ("format_version", "num_items", "padded_rows", "feature_dim",
                "shard_multiple", "num_genres", "genre_names"):
        assert meta[key] == jmeta[key], key
    jart = jload(str(jpath))
    for name in ("features", "norms", "genre_ids"):
        blocks = [np.load(path / f"{name}-{j:05d}.npy")
                  for j in range(meta["files"])]
        np.testing.assert_array_equal(np.concatenate(blocks),
                                      np.asarray(getattr(jart, name)))


def test_host_metadata_sidecar(catalog, tmp_path):
    path = str(tmp_path / "cat")
    save_sharded_catalog(catalog, path, shard_multiple=1024)
    art = load_sharded_catalog(path)
    assert list(art.host_column("track_ids")) == list(catalog.track_ids)
    assert list(art.host_column("artists")) == list(catalog.artists)
    np.testing.assert_array_equal(art.host_column("min_vals"),
                                  catalog.min_vals)


def test_indivisible_mesh_axis_rejected(catalog, tmp_path):
    path = str(tmp_path / "cat")
    save_sharded_catalog(catalog, path, shard_multiple=700)
    with pytest.raises(ValueError, match="not divisible"):
        load_sharded_catalog(path, cpu_mesh(8))


def test_jax_ocdbt_artifact_is_refused(catalog, tmp_path):
    """The JAX package's orbax artifact raises one clear error."""
    jpath = tmp_path / "j"
    jsave(JCatalog(**{f: getattr(catalog, f) for f in (
        "features", "norms", "track_ids", "track_names", "artists",
        "genre_ids", "genre_names", "min_vals", "max_vals")}),
        str(jpath), shard_multiple=1024)
    with pytest.raises(ValueError, match="ocdbt-v1.*not ported"):
        load_sharded_catalog(str(jpath), cpu_mesh(2))


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_from_artifact_matches_oracle_and_jax(catalog, tmp_path, shards):
    """The certified tier per shard, each shard's layout built from its
    own rows: the fixed-order oracle's answer bitwise, the JAX package's
    from_artifact indices on its mesh, and the port's ShardedCatalog."""
    path = str(tmp_path / "cat")
    save_sharded_catalog(catalog, path, shard_multiple=4096)
    mesh = cpu_mesh(shards)
    sc = ShardedCatalog.from_artifact(load_sharded_catalog(path, mesh), mesh)
    assert sc.backend == "certified" and sc.n_local == 4096 // shards
    rng = np.random.default_rng(1)
    rows = rng.integers(0, len(catalog), size=8)
    q = catalog.features[rows] + 0.01 * rng.standard_normal(
        (8, 12)).astype(np.float32)
    s, i = sc.retrieve(q, 5, rows)
    f = torch.from_numpy(catalog.features)
    rs, ri = similarity.exact_topk_chunked(
        torch.from_numpy(q), f, torch.from_numpy(catalog.norms),
        exclude_rows=torch.from_numpy(rows), k=5, fixed_order=True)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    jsave(JCatalog(**{fn: getattr(catalog, fn) for fn in (
        "features", "norms", "track_ids", "track_names", "artists",
        "genre_ids", "genre_names", "min_vals", "max_vals")}),
        str(tmp_path / "j"), shard_multiple=4096)
    jmesh = jmake_mesh(JMeshConfig(data=1, catalog=shards))
    jsc = JSharded.from_artifact(jload(str(tmp_path / "j"), jmesh), jmesh,
                                 interpret=True)
    js, ji = jsc.retrieve(jnp.asarray(q), 5,
                          exclude_rows=jnp.asarray(rows.astype(np.int32)))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    direct = ShardedCatalog(catalog.features, catalog.norms, mesh,
                            use_certified=True)
    ds, di = direct.retrieve(q, 5, rows)
    assert torch.equal(di, i)


def test_from_artifact_rejects_unalignable_shards(catalog, tmp_path):
    path = str(tmp_path / "small")
    save_sharded_catalog(catalog, path, shard_multiple=1024)
    mesh = cpu_mesh(8)
    art = load_sharded_catalog(path, mesh)      # 1024 / 8 = 128 < 512
    with pytest.raises(ValueError, match="shard_multiple"):
        ShardedCatalog.from_artifact(art, mesh)


def test_artifact_of_a_catalog_read_back_as_a_catalog(catalog, tmp_path):
    """Rows spanning two blocks join; the round trip keeps every column."""
    path = str(tmp_path / "cat")
    save_sharded_catalog(catalog, path, shard_multiple=64)   # 704 rows, 8 files
    art = load_sharded_catalog(path)
    assert art.meta["files"] == 8 and art.padded_rows == 704
    np.testing.assert_array_equal(art.rows("features", 80, 200),
                                  catalog.features[80:200])
    np.testing.assert_array_equal(art.rows("norms", 0, 700), catalog.norms)
