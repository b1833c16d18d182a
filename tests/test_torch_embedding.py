"""The port's row-sharded embedding table (parallel/embedding.py) on the
CPU, S shards on one device (core/mesh.make_mesh over a repeated device),
against the JAX package's `parallel/embedding.py` on the conftest's
8-device CPU mesh and against the dense gather.

Tolerances: none for the lookups.  Each row of a lookup's sum has exactly
one non-zero term, so every lookup is bitwise the dense `table[ids]` and
the JAX lookup.  The port's gradient is bitwise the dense one (the
upstream rows added into the looked-up rows); JAX's is within 2 ulp of it
(relative 2.4e-7; measured 1.2e-7 on an x86-64 CPU): under shard_map its
replicated output's cotangent is summed over the 8 shards' copies and
scaled back, which rounds."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh
from spotify_recommender_tpu.parallel import embedding as jemb
from spotify_recommender_tpu_torch.core.config import MeshConfig
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.parallel.embedding import (
    ShardedEmbeddingTable,
    local_lookup,
    local_shards,
    sharded_ids_lookup,
)


def cpu_mesh(catalog, data=1):
    return make_mesh(MeshConfig(data=data, catalog=catalog),
                     devices=["cpu"] * (data * catalog))


@pytest.fixture(scope="module")
def jmesh8():
    return jmake_mesh(JMeshConfig(data=1, catalog=8))


def ragged_ids(rng, vocab, rows=24, width=7):
    """Padded-ragged neighbour lists: row r holds 1..width ids, 0-padded
    (the layout of mf.Interactions.item_idx)."""
    ids = rng.integers(0, vocab, (rows, width))
    lens = rng.integers(1, width + 1, rows)
    ids[np.arange(width)[None, :] >= lens[:, None]] = 0
    return ids


@pytest.mark.parametrize("vocab,dim,shards", [
    (1000, 32, 8), (1003, 16, 8), (37, 4, 3), (8, 8, 8), (5, 3, 1),
])
def test_lookup_is_the_dense_gather_and_jax(vocab, dim, shards, jmesh8):
    rng = np.random.default_rng(vocab)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    t = ShardedEmbeddingTable(table, cpu_mesh(shards))
    assert t.padded_vocab % shards == 0 and t.padded_vocab - vocab < shards
    assert len(t.shards) == shards
    for ids in (np.asarray([0, vocab - 1, vocab // 2, 3 % vocab, 3 % vocab]),
                np.arange(vocab)[::7], ragged_ids(rng, vocab)):
        out = t.lookup(ids)
        assert out.shape == ids.shape + (dim,) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), table[ids])
        if shards == 8:
            theirs = jemb.ShardedEmbeddingTable(table, jmesh8).lookup(
                jnp.asarray(ids, jnp.int32))
            np.testing.assert_array_equal(out.numpy(), np.asarray(theirs))


def test_shards_are_views_when_no_padding_is_needed():
    table = torch.arange(64.0).reshape(16, 4)
    t = ShardedEmbeddingTable(table, cpu_mesh(4))
    assert [sh.data_ptr() for sh in t.shards] == [
        table[4 * c].data_ptr() for c in range(4)]
    padded = ShardedEmbeddingTable(table[:15], cpu_mesh(4))
    assert padded.padded_vocab == 16
    assert torch.equal(padded.shards[3][3], torch.zeros(4))


@pytest.mark.parametrize("bad", [[-1], [0, 1003], [1004], [[2, 1010]]])
def test_out_of_range_ids_raise_unless_unvalidated(bad):
    table = np.ones((1003, 4), np.float32)
    t = ShardedEmbeddingTable(table, cpu_mesh(8))
    with pytest.raises(IndexError, match=r"out of range \[0, 1003\)"):
        t.lookup(bad)
    # unvalidated, an id past the vocabulary is a zero row (the JAX
    # contract for traced ids)
    out = t.lookup(np.asarray(bad), validate=False)
    assert out.shape == np.asarray(bad).shape + (4,)


def test_local_lookup_gradient_reaches_the_owners_as_jax(jmesh8):
    """JAX tests/test_embedding.py:36, and the same gradient with
    repeated ids and an upstream gradient that is not all ones."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    ids = np.asarray([3, 17, 63, 17, 40], np.int32)
    up = rng.standard_normal((5, 8)).astype(np.float32)
    fn = jax.jit(jax.shard_map(
        partial(jemb.local_lookup, axis_name="catalog"), mesh=jmesh8,
        in_specs=(P("catalog", None), P()), out_specs=P(), check_vma=False))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(fn(t, jnp.asarray(ids)) * up))(
        jnp.asarray(table)))

    full = torch.from_numpy(table).requires_grad_(True)
    shards = list(full.split(8))          # 8 shards of 8 rows
    out = local_lookup(shards, torch.from_numpy(ids))
    (out * torch.from_numpy(up)).sum().backward()
    want = np.zeros_like(table)
    np.add.at(want, ids, up)
    np.testing.assert_array_equal(full.grad.numpy(), want)
    np.testing.assert_allclose(full.grad.numpy(), jg, rtol=2.4e-7, atol=0)
    untouched = np.setdiff1d(np.arange(64), ids)
    assert not full.grad[untouched].any()


@pytest.mark.parametrize("rows,md", [(8, 3), (5, 1)])
def test_sharded_ids_lookup_equals_jax_psum_scatter(rows, md, jmesh8):
    """Ids row-sharded over the same axis as the table: each shard gets
    the rows of its own ids, bitwise the JAX exchange and the dense
    gather."""
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((8 * rows, 6)).astype(np.float32)
    ids = rng.integers(0, 8 * rows, (8 * 4, md)).astype(np.int32)
    fn = jax.jit(jax.shard_map(
        partial(jemb.sharded_ids_lookup, axis_name="catalog"), mesh=jmesh8,
        in_specs=(P("catalog", None), P("catalog", None)),
        out_specs=P("catalog", None), check_vma=False))
    theirs = np.asarray(fn(jnp.asarray(table), jnp.asarray(ids)))

    t_shards = list(torch.from_numpy(table).split(rows))
    i_shards = list(torch.from_numpy(ids).split(4))
    ours = sharded_ids_lookup(t_shards, i_shards)
    assert len(ours) == 8
    got = torch.cat(ours).numpy()
    np.testing.assert_array_equal(got, theirs)
    np.testing.assert_array_equal(got, table[ids])


def test_sharded_ids_lookup_gradient_inside_one_process():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((12, 4)).astype(np.float32)
    ids = rng.integers(0, 12, (6, 2))
    full = torch.from_numpy(table).requires_grad_(True)
    out = sharded_ids_lookup(list(full.split(4)),
                             list(torch.from_numpy(ids).split(2)))
    torch.cat(out).sum().backward()
    want = np.zeros_like(table)
    np.add.at(want, ids.reshape(-1), 1.0)
    np.testing.assert_array_equal(full.grad.numpy(), want)


def test_local_shards_takes_the_first_row_of_the_catalog_axis():
    mesh = cpu_mesh(3, data=2)
    cells, home = local_shards(mesh)
    assert [c for c, _ in cells] == [0, 1, 2] and home == torch.device("cpu")
    with pytest.raises(ValueError, match="'catalog' axis"):
        local_shards(mesh, "data")
