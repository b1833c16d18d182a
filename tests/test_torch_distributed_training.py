"""The training half of sharding across two `torch.distributed` (gloo)
processes on the CPU: the one part a mesh over repeated devices inside one
process cannot show.

Two worker processes, each with two CPU cells of a four-cell mesh
(`global_mesh(axis_sizes=...)`, rank-major), run a sharded-embedding
lookup and its gradient, a sharded-table ALS half-step and `train_als` in
both modes, one data-parallel SGD step (`train_sgd`) and one
data-parallel two-tower step (`train`), and hold each against the same
computation over four cells in one process (`make_mesh` over a repeated
device).  Tolerances: the lookup, its gradient and replicated ALS bitwise
(no sum crosses a process); the sharded-table half-step and ALS within
1e-5 (the Gramian's partials are summed per process, then across); the
SGD and two-tower parameters within 1e-6 (the gradients of each process's
slices are summed by autograd, then by `all_reduce`).  Each worker runs
under a timeout and is killed when it expires."""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import (
    MeshConfig, MFConfig, TwoTowerConfig,
)
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.models import mf, two_tower
from spotify_recommender_tpu_torch.parallel.distributed import (
    global_mesh, initialize_multihost,
)
from spotify_recommender_tpu_torch.parallel.embedding import (
    ShardedEmbeddingTable,
)

coord, pid = sys.argv[1], int(sys.argv[2])
torch.set_num_threads(1)
initialize_multihost(coordinator_address=coord, num_processes=2,
                     process_id=pid, timeout_s=60, device="cpu")
cpu = torch.device("cpu")
cat4 = global_mesh(axis_sizes=(1, 4), devices_per_process=[cpu, cpu])
data4 = global_mesh(axis_sizes=(4, 1), devices_per_process=[cpu, cpu])
one_cat4 = make_mesh(MeshConfig(catalog=4), devices=[cpu] * 4)
one_data4 = make_mesh(MeshConfig(data=4), devices=[cpu] * 4)
rng = np.random.default_rng(0)


def close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.abs(a - b).max() <= atol, (
        np.abs(a - b).max())


# the lookup and its gradient: this process's two shards
dense = rng.standard_normal((1003, 8)).astype(np.float32)
table = ShardedEmbeddingTable(dense, cat4)
assert table.shard_ids == [2 * pid, 2 * pid + 1]
ids = rng.integers(0, 1003, (16, 5))
up = rng.standard_normal((16, 5, 8)).astype(np.float32)
for sh in table.shards:
    sh.requires_grad_(True)
out = table.lookup(ids)
assert torch.equal(out, torch.from_numpy(dense[ids]))
(out * torch.from_numpy(up)).sum().backward()
want = np.zeros((1004, 8), np.float32)
np.add.at(want, ids.reshape(-1), up.reshape(-1, 8))
for c, sh in zip(table.shard_ids, table.shards):
    assert np.array_equal(sh.grad.numpy(), want[c * 251:(c + 1) * 251])

# the sharded-table half-step: both tables row-sharded
other = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
idx = torch.from_numpy(rng.integers(0, 64, (64, 3)))
conf = torch.from_numpy(rng.random((64, 3)).astype(np.float32))
mask = torch.from_numpy(rng.random((64, 3)) < 0.8)
whole = [list(t.split(16)) for t in (other, idx, conf, mask)]
mine = [p[2 * pid:2 * pid + 2] for p in whole]
got = mf.make_sharded_table_half_step(cat4, 0.1, 2.0)(*mine)
ref = mf.make_sharded_table_half_step(one_cat4, 0.1, 2.0)(*whole)
for g, r in zip(got, ref[2 * pid:2 * pid + 2]):
    close(g, r, 1e-5)

# train_als in both modes against one process
inter, _, _ = mf.synthetic_interactions(203, 101, 4, density=0.05, seed=7)
cfg = MFConfig(embedding_dim=8, num_iterations=3, reg=0.1, alpha=10.0)
for shard_tables in (False, True):
    got = mf.train_als(inter, cfg, mesh=cat4, shard_tables=shard_tables)
    ref = mf.train_als(inter, cfg, mesh=one_cat4, shard_tables=shard_tables)
    for g, r in zip(got, ref):
        if shard_tables:
            close(g, r, 1e-5)
        else:
            assert np.array_equal(g, r)

# one data-parallel SGD step, and two
for steps in (1, 2):
    scfg = MFConfig(embedding_dim=8, batch_size=512, learning_rate=0.01)
    gl, rl = [], []
    got = mf.train_sgd(inter, scfg, num_steps=steps, mesh=data4, losses=gl)
    ref = mf.train_sgd(inter, scfg, num_steps=steps, mesh=one_data4,
                       losses=rl)
    for g, r in zip(got, ref):
        close(g, r, 1e-6)
    close(gl, rl, 1e-6)

# one data-parallel two-tower step (the items all-gathered across the
# processes, differentiably)
feats = rng.random((400, 12)).astype(np.float32)
genres = (np.arange(400) % 4).astype(np.int32)
tcfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,), batch_size=32,
                      num_steps=1, learning_rate=3e-3)
got = two_tower.train(feats, genres, tcfg, mesh=data4)
ref = two_tower.train(feats, genres, tcfg, mesh=one_data4)
close(got.losses, ref.losses, 1e-6)
for name, p in ref.params.items():
    close(got.params[name], p, 1e-6)
print(f"proc {pid} OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        env.pop(var, None)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_process_gloo_sharded_training(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
            text=True, cwd=str(tmp_path),
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("two-process gloo run timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out
