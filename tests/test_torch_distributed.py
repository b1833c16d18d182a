"""Two-process `torch.distributed` (gloo) bootstrap of the port
(parallel/distributed.py): the one part of the sharded path that a mesh
over repeated devices inside one process cannot show.

Two CPU worker processes join one group through a localhost coordinator
(`tcp://127.0.0.1:<free port>`, a fresh port per test), run
`initialize_multihost` (twice: it is idempotent) and `global_mesh`, one
`all_reduce`, and sharded retrievals whose candidates cross the processes
through `all_gather_into_tensor`; every answer must equal the one-process
answer bit for bit.  A second case checks the fail-fast diagnostic, as
tests/test_distributed_multiprocess.py does for the JAX package.  Every
child runs under a timeout and is killed when it expires."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from spotify_recommender_tpu_torch.core.config import MeshConfig
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.data.sharded_catalog import (
    save_sharded_catalog,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

from spotify_recommender_tpu_torch.core.config import MeshConfig
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.data.sharded_catalog import (
    load_sharded_catalog,
)
from spotify_recommender_tpu_torch.parallel.distributed import (
    global_mesh, initialize_multihost,
)
from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog

coord, pid, art_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
for _ in range(2):                       # idempotent
    initialize_multihost(coordinator_address=coord, num_processes=2,
                         process_id=pid, timeout_s=60, device="cpu")
assert dist.get_world_size() == 2 and dist.get_rank() == pid
assert dist.get_backend() == "gloo"

# the mesh over both processes: two CPU cells each, rank-major
cpu = torch.device("cpu")
mesh = global_mesh(axis_sizes=(1, 4), devices_per_process=[cpu, cpu])
assert mesh.shape == {"data": 1, "catalog": 4} and mesh.spans_processes
assert mesh.process_ids.tolist() == [[0, 0, 1, 1]]
assert mesh.process_index == pid

t = torch.tensor([float(pid + 1)])
dist.all_reduce(t)
assert t.item() == 3.0, t

rng = np.random.default_rng(0)
feats = rng.random((2000, 12), dtype=np.float32)
feats[::97] *= np.float32(1e-3)
norms = np.linalg.norm(feats, axis=1).astype(np.float32)
rows = rng.integers(0, 2000, 8)
q = feats[rows]
local4 = make_mesh(MeshConfig(catalog=4), devices=[cpu] * 4)
for kw in ({}, {"use_pallas": True}, {"use_certified": True}):
    sc = ShardedCatalog(feats, norms, mesh, **kw)
    assert len(sc._local) == 2               # this process's two shards
    s, i = sc.retrieve(q, 5, rows)
    ref = ShardedCatalog(feats, norms, local4, **kw)
    rs, ri = ref.retrieve(q, 5, rows)
    assert torch.equal(i, ri) and torch.equal(s, rs), kw
    assert sc.fallbacks == ref.fallbacks, (sc.fallbacks, ref.fallbacks)

# 2-D: the batch split over "data", which crosses the processes
mesh22 = global_mesh(axis_sizes=(2, 2), devices_per_process=[cpu, cpu])
sc = ShardedCatalog(feats, norms, mesh22, use_certified=True,
                    data_axis="data")
s, i = sc.retrieve(q, 5, rows)
rs, ri = ShardedCatalog(feats, norms, local4, use_certified=True).retrieve(
    q, 5, rows)
assert torch.equal(i, ri) and torch.equal(s, rs)

# the sharded artifact: each process reads and lays out its own shards
art = load_sharded_catalog(art_dir, mesh)
sa = ShardedCatalog.from_artifact(art, mesh)
s, i = sa.retrieve(q, 5, rows)
assert torch.equal(i, ri) and torch.equal(s, rs)
assert sa.rn_min == float(norms[norms > 0].min())
dist.destroy_process_group()
print(f"proc {pid} OK")
"""

_BAD_CONFIG = r"""
import sys
from spotify_recommender_tpu_torch.parallel.distributed import (
    initialize_multihost,
)

# case 1: two processes asked for, no coordinator address anywhere
try:
    initialize_multihost(num_processes=2, process_id=1, timeout_s=5,
                         device="cpu")
    sys.exit(1)
except RuntimeError as e:
    assert "coordinator address is reachable" in str(e), e

# case 2: an address where nothing listens: the client gives up after
# its timeout with the same diagnostic
try:
    initialize_multihost(coordinator_address=sys.argv[1], num_processes=2,
                         process_id=1, timeout_s=5, device="cpu")
    sys.exit(1)
except RuntimeError as e:
    assert "coordinator address is reachable" in str(e), e
print("fail-fast OK")
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


def test_two_process_gloo_sharded_retrieval(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.random((2000, 12), dtype=np.float32)
    feats[::97] *= np.float32(1e-3)
    ids = np.asarray([f"t{i}" for i in range(2000)], dtype=object)
    cat = Catalog(feats, None, ids, ids, ids, np.zeros(2000, np.int32), ["g"],
                  np.zeros(11, np.float32), np.ones(11, np.float32))
    save_sharded_catalog(cat, str(tmp_path / "art"), shard_multiple=2048)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid),
             str(tmp_path / "art")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
            text=True, cwd=_REPO,
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


def test_bad_config_fails_fast_with_diagnostic(tmp_path):
    worker = tmp_path / "bad.py"
    worker.write_text(_BAD_CONFIG)
    coord = f"127.0.0.1:{_free_port()}"   # nothing listening
    p = subprocess.run(
        [sys.executable, str(worker), coord], capture_output=True,
        env=_env(), text=True, timeout=120, cwd=_REPO,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "fail-fast OK" in p.stdout


def test_global_mesh_needs_a_group():
    from spotify_recommender_tpu_torch.parallel.distributed import global_mesh

    with pytest.raises(RuntimeError, match="initialize_multihost"):
        global_mesh()


def test_mesh_config_matches_jax():
    from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig

    for kw in ({}, {"data": 2, "catalog": 4}):
        j, t = JMeshConfig(**kw), MeshConfig(**kw)
        assert (t.data, t.catalog, tuple(t.axis_names), t.num_devices) == (
            j.data, j.catalog, tuple(j.axis_names), j.num_devices)
