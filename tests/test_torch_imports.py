"""The port stands without JAX: no module of it, and not chip_smoke.py,
imports jax, flax, optax, msgpack, the JAX package `spotify_recommender_tpu`
or the repo's `experiments/`."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from spotify_recommender_tpu_torch.core.device import device_info, resolve_device

PKG = pathlib.Path(__file__).resolve().parents[1] / "spotify_recommender_tpu_torch"
SOURCES = [*sorted(PKG.rglob("*.py")), PKG.parent / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
             "spotify_recommender_tpu", "experiments")

_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "flax", "optax", "msgpack", "spotify_recommender_tpu",
                 "experiments"):
        sys.modules[name] = None       # any import of these now raises
    import numpy as np, torch
    import spotify_recommender_tpu_torch as pkg
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    from spotify_recommender_tpu_torch.ops.fused_topk import CertifiedRetriever
    from spotify_recommender_tpu_torch.ops.similarity import exact_topk
    feats = np.random.default_rng(0).random((3000, 12), dtype=np.float32)
    cr = CertifiedRetriever(feats, None, None, torch.device("cpu"))
    s, i = cr(feats[:8], 10, exclude_rows=np.arange(8))
    rs, ri = exact_topk(torch.from_numpy(feats[:8]), torch.from_numpy(feats),
                        exclude_rows=torch.arange(8), k=10)
    assert torch.equal(i, ri)
    # the two-tower model trains and its file round-trips without flax
    import os, tempfile
    from spotify_recommender_tpu_torch.core.config import TwoTowerConfig
    from spotify_recommender_tpu_torch.models import two_tower
    cfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,), batch_size=16,
                         num_steps=2)
    res = two_tower.train(feats[:200], np.zeros(200, np.int32), cfg,
                          device="cpu")
    path = os.path.join(tempfile.mkdtemp(), "tt")
    two_tower.save_model(path, res.params, cfg)
    params, cfg2 = two_tower.load_model(path)
    assert cfg2 == cfg and all(torch.equal(params[k], res.params[k])
                               for k in params)
    # the sharded catalog over a CPU mesh, and the native parse (g++)
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh
    from spotify_recommender_tpu_torch.data import native_ingest
    from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog
    mesh = make_mesh(MeshConfig(catalog=3), devices=["cpu"] * 3)
    ss, si = ShardedCatalog(feats, None, mesh, use_certified=True).retrieve(
        feats[:8], 10, np.arange(8))
    assert torch.equal(si, ri)
    hdr = ("track_id,track_name,artists,danceability,energy,key,loudness,"
           "mode,speechiness,acousticness,instrumentalness,liveness,valence,"
           "tempo,track_genre")
    t = native_ingest.parse_csv_rows_native(
        hdr, ["t1,S,A,0.5,0.6,C,-5,Major,0.1,0.2,0.3,0.4,0.5,120,rock"])
    assert t.num_valid_rows == 1
    assert not any(name == "jax" or name.startswith(("jax.", "jaxlib"))
                   for name in sys.modules if sys.modules[name] is not None)
    print("OK")
""")


def test_port_imports_and_retrieves_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        cwd=PKG.parent, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_source_file_imports_jax():
    offenders = [
        str(p) for p in SOURCES
        if any(line.strip().startswith(("import jax", "from jax"))
               for line in p.read_text().splitlines())
    ]
    assert offenders == []


def imported_modules(path: pathlib.Path):
    """Every absolute module name an import statement of `path` names."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_imports_the_jax_package_or_experiments():
    assert len(SOURCES) > 30 and SOURCES[-1].exists()
    offenders = {
        f"{p.relative_to(PKG.parent)}: {name}"
        for p in SOURCES for name in imported_modules(p)
        if name.split(".")[0] in FORBIDDEN
    }
    assert offenders == set()


TWO_TOWER = ["models/two_tower.py", "models/flax_msgpack.py", "cli.py",
             "benchmark.py"]


@pytest.mark.parametrize("rel", TWO_TOWER)
def test_two_tower_modules_are_checked_sources(rel):
    """The two-tower slice's modules are among the files the import checks
    walk, and import neither JAX nor flax, optax or msgpack."""
    path = PKG / rel
    assert path in SOURCES
    assert not {n for n in imported_modules(path)
                if n.split(".")[0] in FORBIDDEN}


DATA_AND_SHARDING = ["data/native_ingest.py", "data/streaming.py",
                     "data/sharded_catalog.py", "core/mesh.py",
                     "parallel/sharding.py", "parallel/distributed.py",
                     "retrieval/retriever.py"]


@pytest.mark.parametrize("rel", DATA_AND_SHARDING)
def test_data_and_sharding_modules_are_checked_sources(rel):
    """The rest of the data layer and the sharded serving path are among
    the files the import checks walk, and import none of the forbidden
    names."""
    path = PKG / rel
    assert path in SOURCES
    assert not {n for n in imported_modules(path)
                if n.split(".")[0] in FORBIDDEN}


ABLATION = ["ops/cuda/ablation.py", "experiments/kernel_ablation_r2.py",
            "experiments/kernel_ablation_r2b.py",
            "experiments/kernel_ablation_r2c.py",
            "experiments/kernel_ablation_r2d.py"]


@pytest.mark.parametrize("rel", ABLATION)
def test_ablation_modules_are_checked_sources(rel):
    """The ports of TPU kernels 5-8 are among the files the import checks
    above walk, and import none of the forbidden names."""
    path = PKG / rel
    assert path in SOURCES
    assert not {n for n in imported_modules(path)
                if n.split(".")[0] in FORBIDDEN}


@pytest.mark.parametrize("rel", [r for r in ABLATION if "experiments" in r])
def test_ablation_mains_default_to_the_card(rel):
    """Each main runs on the card unless asked for the CPU, and raises
    where torch sees none."""
    import importlib
    import inspect

    mod = importlib.import_module(
        "spotify_recommender_tpu_torch." + rel[:-3].replace("/", "."))
    assert inspect.signature(mod.main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(n=300, b=2)


def test_device_resolution_names_the_device():
    cpu = resolve_device("cpu")
    assert cpu == torch.device("cpu")
    assert device_info(cpu).platform == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
