"""The port's sharded matrix factorization (`models/mf.py`: sharded ALS,
both modes, and data-parallel SGD) on the CPU, S cells of one mesh on one
device, against the JAX package's sharded runs on the conftest's 8-device
CPU mesh and against the port's own single-device runs.

Tolerances (fp32 on both sides):
- ALS, replicated `other` table: bitwise the port's single-device run
  (each shard solves its rows as the single device does; the Gram is the
  same product); against JAX's sharded run within the port's ALS bound
  against JAX, 5e-5 (`tests/test_torch_mf.py`);
- ALS, `shard_tables`: within 1e-4 of the single-device run (the Gram is
  summed from per-shard partials; measured 9.0e-6 here, JAX's own sharded
  run differs from its single-device run by 2.0e-5) and within 1e-4 of
  JAX's `shard_tables` run;
- SGD over data=8 against JAX's data-parallel run: parameters after 20
  steps at batch 8192 within 1e-5 and each loss within 1e-4 relative (the
  bounds of `tests/test_torch_mf.py::test_train_sgd_matches_jax`); against
  the port's single-device run each loss within 1e-5 relative (measured
  1e-7: the mean of the slices' means against one mean)."""

import jax
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
from spotify_recommender_tpu.core.config import MFConfig as JMFConfig
from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh
from spotify_recommender_tpu.models import mf as jmf
from spotify_recommender_tpu_torch.core.config import MeshConfig, MFConfig
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.models import mf

JAX_ALS_ATOL = 5e-5
SHARD_TABLES_ATOL = 1e-4
ALS_CFG = dict(embedding_dim=16, num_iterations=3, reg=0.05, alpha=10.0)


def cpu_mesh(catalog=1, data=1):
    return make_mesh(MeshConfig(data=data, catalog=catalog),
                     devices=["cpu"] * (data * catalog))


@pytest.fixture(scope="module")
def als_data():
    """The case the JAX package's sharded runs were measured on (300
    users x 200 items, d 16, 3 iterations) with the port's single-device
    factors."""
    inter, _, _ = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=1)
    return inter, mf.train_als(inter, MFConfig(**ALS_CFG), device="cpu")


@pytest.mark.parametrize("shard_tables", [False, True])
def test_sharded_als_matches_jax_and_the_single_device(als_data,
                                                        shard_tables):
    inter, (u1, i1) = als_data
    ours = mf.train_als(inter, MFConfig(**ALS_CFG), mesh=cpu_mesh(8),
                        shard_tables=shard_tables)
    jmesh = jmake_mesh(JMeshConfig(data=1, catalog=8))
    theirs = jmf.train_als(inter, JMFConfig(**ALS_CFG), mesh=jmesh,
                           shard_tables=shard_tables)
    for mine, single, jax_side in zip(ours, (u1, i1), theirs):
        assert mine.shape == single.shape
        np.testing.assert_allclose(mine, np.asarray(jax_side), rtol=0,
                                   atol=SHARD_TABLES_ATOL if shard_tables
                                   else JAX_ALS_ATOL)
        if shard_tables:
            np.testing.assert_allclose(mine, single, rtol=0,
                                       atol=SHARD_TABLES_ATOL)
        else:
            np.testing.assert_array_equal(mine, single)


@pytest.mark.parametrize("shards,shard_tables", [
    (8, False), (8, True), (3, True), (1, True),
])
def test_uneven_rows_return_the_unpadded_shapes(shards, shard_tables):
    """JAX tests/test_mf_sharded.py's 203 x 101 case: rows padded to the
    shard count inside, the unpadded factors out."""
    inter, _, _ = mf.synthetic_interactions(203, 101, 4, density=0.05, seed=7)
    cfg = MFConfig(embedding_dim=8, num_iterations=3, reg=0.1, alpha=10.0)
    u1, i1 = mf.train_als(inter, cfg, device="cpu")
    seen = []
    u, i = mf.train_als(inter, cfg, mesh=cpu_mesh(shards),
                        shard_tables=shard_tables,
                        callback=lambda it, a, b: seen.append(
                            (it, tuple(a.shape), tuple(b.shape))))
    assert seen == [(it, (203, 8), (101, 8)) for it in range(3)]
    np.testing.assert_allclose(u, u1, rtol=0, atol=SHARD_TABLES_ATOL)
    np.testing.assert_allclose(i, i1, rtol=0, atol=SHARD_TABLES_ATOL)


def test_sharded_als_learns():
    """JAX tests/test_mf_sharded.py::test_sharded_learns, both modes."""
    inter, _, _ = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=1)
    train, heldout, seen = mf.split_leave_k_out(inter, k=1, seed=0)
    cfg = MFConfig(embedding_dim=16, num_iterations=6, reg=0.05, alpha=10.0)
    for shard_tables in (False, True):
        users, items = mf.train_als(train, cfg, mesh=cpu_mesh(8),
                                    shard_tables=shard_tables)
        m = mf.evaluate_ranking(users, items, heldout, k=10, train_mask=seen,
                                device="cpu")
        assert m["recall@k"] > 0.35, m


def test_sharded_table_half_step_keeps_the_tables_distributed():
    """JAX's `test_table_stays_distributed`: the step takes and returns
    per-shard row blocks, and equals the single-device half-step."""
    rng = np.random.default_rng(0)
    other = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 64, (64, 3)))
    conf = torch.ones((64, 3))
    mask = torch.ones((64, 3), dtype=torch.bool)
    step = mf.make_sharded_table_half_step(cpu_mesh(8), reg=0.1, alpha=1.0)
    out = step(*[list(t.split(8)) for t in (other, idx, conf, mask)])
    assert len(out) == 8 and all(o.shape == (8, 8) for o in out)
    want = mf._als_solve(other, idx, conf, mask, 0.1, 1.0)
    np.testing.assert_allclose(torch.cat(out).numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    rows = mf.make_sharded_half_step(cpu_mesh(8), reg=0.1, alpha=1.0)
    assert torch.equal(rows(other, idx, conf, mask), want)


def test_sharded_als_checkpoint_resumes_and_holds_unpadded_tables(tmp_path):
    inter, _, _ = mf.synthetic_interactions(203, 101, 4, density=0.05, seed=7)
    cfg = MFConfig(embedding_dim=8, num_iterations=3, reg=0.1, alpha=10.0)
    mesh = cpu_mesh(8)
    full = mf.train_als(inter, cfg, mesh=mesh, shard_tables=True)
    ck = str(tmp_path / "ck")
    mf.train_als(inter, MFConfig(**{**vars(cfg), "num_iterations": 2}),
                 mesh=mesh, shard_tables=True, checkpoint_dir=ck)
    state = torch.load(tmp_path / "ck" / "step_1.pt", weights_only=True)
    assert state["users"].shape == (203, 8) and state["items"].shape == (101, 8)
    resumed = mf.train_als(inter, cfg, mesh=mesh, shard_tables=True,
                           checkpoint_dir=ck)
    for a, b in zip(resumed, full):
        np.testing.assert_array_equal(a, b)


def _jax_dp_sgd(monkeypatch, inter, cfg, steps, mesh):
    """The JAX `train_sgd` over `mesh`, each data-parallel step's loss
    recorded (its loop keeps them to itself)."""
    losses, real_jit = [], jax.jit

    def jit(fn, *args, **kw):
        compiled = real_jit(fn, *args, **kw)

        def call(*a, **k):
            out = compiled(*a, **k)
            if isinstance(out, tuple) and len(out) == 3:
                losses.append(float(out[2]))
            return out
        return call

    monkeypatch.setattr(jmf.jax, "jit", jit)
    ju, ji = jmf.train_sgd(inter, JMFConfig(**cfg), num_steps=steps,
                           mesh=mesh)
    monkeypatch.undo()
    return np.asarray(ju), np.asarray(ji), np.asarray(losses)


def test_dp_sgd_matches_jax_and_the_single_device(monkeypatch):
    inter, _, _ = mf.synthetic_interactions(2000, 1000, 8, seed=0)
    cfg = dict(embedding_dim=16, reg=0.05, alpha=10.0, learning_rate=0.01)
    ju, ji, jl = _jax_dp_sgd(monkeypatch, inter, cfg, 20,
                             jmake_mesh(JMeshConfig(data=8, catalog=1)))
    tl, sl = [], []
    tu, ti = mf.train_sgd(inter, MFConfig(**cfg), num_steps=20,
                          mesh=cpu_mesh(data=8), losses=tl)
    mf.train_sgd(inter, MFConfig(**cfg), num_steps=20, device="cpu",
                 losses=sl)
    assert len(tl) == len(jl) == 20
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-5)
    assert (np.abs(np.asarray(tl) - jl) / jl).max() <= 1e-4
    assert (np.abs(np.asarray(tl) - sl) / np.asarray(sl)).max() <= 1e-5


@pytest.mark.parametrize("batch_size,nd,want", [
    (1024, 8, 1024), (1003, 8, 1000), (5, 8, 8), (10**6, 8, None),
])
def test_dp_global_batch_rule(monkeypatch, batch_size, nd, want):
    """max(nd, (min(batch, n_obs) // nd) * nd) draws per step, contiguous
    slices of it per data cell (JAX `train_sgd`, mf.py:640-642)."""
    inter, _, _ = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=2)
    n_obs = int(inter.mask.sum())
    want = want or (n_obs // nd) * nd
    sizes, step = [], mf.sgd_step

    def recorded(state, batch, reg, alpha, mesh=None):
        sizes.append((batch["user"].shape[0], mesh.shape["data"]))
        return step(state, batch, reg, alpha, mesh)

    monkeypatch.setattr(mf, "sgd_step", recorded)
    mf.train_sgd(inter, MFConfig(embedding_dim=4, batch_size=batch_size),
                 num_steps=2, mesh=cpu_mesh(data=nd))
    assert sizes == [(want, nd)] * 2


def test_dp_sgd_learns():
    """JAX tests/test_mf_sharded.py::TestShardedSGD."""
    inter, _, _ = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=2)
    train, heldout, seen = mf.split_leave_k_out(inter, k=1, seed=0)
    cfg = MFConfig(embedding_dim=16, reg=0.002, alpha=5.0,
                   learning_rate=0.05, batch_size=1024, seed=0)
    users, items = mf.train_sgd(train, cfg, num_steps=300,
                                mesh=cpu_mesh(data=8))
    m = mf.evaluate_ranking(users, items, heldout, k=10, train_mask=seen,
                            device="cpu")
    assert m["recall@k"] > 0.12, m


def test_data_cells_take_the_first_column():
    mesh = cpu_mesh(catalog=2, data=3)
    assert [d for d, _ in mf.data_cells(mesh)] == [0, 1, 2]
    with pytest.raises(ValueError, match="'data' axis"):
        mf.data_cells(mesh, "catalog")
