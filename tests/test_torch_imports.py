"""The port stands without JAX: no module of it imports jax."""

import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from spotify_recommender_tpu_torch.core.device import device_info, resolve_device

PKG = pathlib.Path(__file__).resolve().parents[1] / "spotify_recommender_tpu_torch"

_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises
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
        str(p) for p in PKG.rglob("*.py")
        if any(line.strip().startswith(("import jax", "from jax"))
               for line in p.read_text().splitlines())
    ]
    assert offenders == []


def test_device_resolution_names_the_device():
    cpu = resolve_device("cpu")
    assert cpu == torch.device("cpu")
    assert device_info(cpu).platform == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
