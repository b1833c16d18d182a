"""Fixtures of the benchmark's CPU tests: a tiny root (BENCHMARK.json and
data files for small cells, the benchmark's code imported from this
checkout) and the `cuda` fixture that skips where torch sees no card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_CELLS = {
    # cell: (config file it copies, rows, traffic file it copies, batch, k)
    "tiny12.b64-k5": ("audio12-1m", 4096, "b1024-k10", 64, 5),
    "tinytt.b64-k5": ("tt64-1m", 4096, "b1024-k10", 64, 5),
    "tiny12.b64-k300": ("audio12-1m", 4096, "b512-k1000", 64, 300),
}


@pytest.fixture
def cuda():
    """Skips the test where torch sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda", 0)


def make_tiny_root(root: Path) -> Path:
    """A root with BENCHMARK.json and the tiny cells' data files, the real
    limits of the cell each copies (so the tiny runs are held to them)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    data = root / BENCH.name
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    configs, workloads = {}, []
    for cell, (conf, rows, mix, b, k) in TINY_CELLS.items():
        cname, tname = cell.split(".")
        c = json.loads((BENCH / "configs" / f"{conf}.json").read_text())
        c.update(name=cname, rows=rows)
        (data / "configs" / f"{cname}.json").write_text(json.dumps(c))
        configs[cname] = {"name": cname, "source": "a test",
                          "file": f"{BENCH.name}/configs/{cname}.json",
                          "reduced": ["rows"], "why": "a test"}
        t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        t.update(name=tname, batch=b, k=k, pool_batches=3, warm_batches=3,
                 check_batches=3, trace_seconds=0.2)
        (data / "traffic" / f"{tname}.json").write_text(json.dumps(t))
        shutil.copy(BENCH / "limits" / f"{conf}.{mix}.json",
                    data / "limits" / f"{cell}.json")
        workloads.append({"name": cell, "config": cname, "traffic": tname,
                          "chips": 1, "why": "a test"})
    bench["configs"] = list(configs.values())
    bench["workloads"] = workloads
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny_root"))
