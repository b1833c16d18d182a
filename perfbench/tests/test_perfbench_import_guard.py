"""Nothing a run loads has the top-level name jax, jaxlib, flax or
spotify_recommender_tpu (the JAX package), compared whole: the port's
spotify_recommender_tpu_torch passes.  The reference and the input makers
load nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

from perfbench.harness import bench
from perfbench.tests.conftest import BENCH, REPO


def _run(script: str) -> str:
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_forbidden_names_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["spotify_recommender_tpu_torch_x"] = sys
        sys.modules["jaxtyping"] = sys
        assert bench.forbidden_modules() == []
        sys.modules["spotify_recommender_tpu.ops"] = sys
        sys.modules["flax"] = sys
        assert bench.forbidden_modules() == ["flax",
                                             "spotify_recommender_tpu.ops"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax(tiny_root):
    cells = [w["name"] for w in
             json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
    out = _run(f"""
        import argparse, json, sys, time
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from perfbench.harness import bench, spec
        # every module each real cell names
        for name in {cells!r}:
            cell = spec.load_cell(name)
            spec.module("systems", cell.config["system"])
            spec.module("inputs", cell.config["inputs"])
            for m in cell.per_layer:
                spec.module("metrics", m["name"])
        # and whole runs, traced, through the port on the CPU
        for name in ("tiny12.b64-k5", "tinytt.b64-k5", "tiny12.b64-k300"):
            a = argparse.Namespace(workload=name, seed=1, seconds=0.2,
                                   trace=1)
            r = bench.run(a, time.perf_counter(), torch.device("cpu"),
                          root={str(tiny_root)!r})
            assert r["correct"], r
        assert "spotify_recommender_tpu_torch.retrieval.retriever" in sys.modules
        print(json.dumps(bench.forbidden_modules()))
    """)
    assert json.loads(out) == []


def test_reference_loads_nothing_of_the_port():
    out = _run(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        import perfbench.reference.cosine_topk, perfbench.reference.tower
        import perfbench.inputs.uniform, perfbench.inputs.tower_items
        import perfbench.harness.check
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0].startswith("spotify"))))
    """)
    assert json.loads(out) == []
    for path in list((BENCH / "reference").glob("*.py")) + list(
            (BENCH / "inputs").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "typing",
                                           "__future__", "perfbench"), (path, n)
                assert not n.startswith("perfbench.") or n.startswith(
                    "perfbench.reference"), (path, n)
