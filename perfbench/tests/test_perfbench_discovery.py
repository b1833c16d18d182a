"""A later configuration, input maker, traffic mix, traffic generator,
metric and cell are new files and new entries of BENCHMARK.json: the
harness finds each by name, and no file of the benchmark changes."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from perfbench.tests.conftest import BENCH, make_tiny_root


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_found_by_name(tmp_path):
    root = make_tiny_root(tmp_path)
    data = root / BENCH.name
    shutil.copytree(BENCH, data, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "spotify_recommender_tpu_torch").symlink_to(
        BENCH.parent / "spotify_recommender_tpu_torch")
    before = _digests(data)

    # new files only
    (data / "inputs" / "gaussian_later.py").write_text(textwrap.dedent("""
        import torch
        def make(config, gen, device):
            x = torch.randn((config["rows"], config["features"]),
                            generator=gen, device=device)
            return x.abs()
    """))
    conf = json.loads((data / "configs" / "tiny12.json").read_text())
    conf.update(name="later16", inputs="gaussian_later", features=16)
    (data / "configs" / "later16.json").write_text(json.dumps(conf))
    (data / "traffic" / "reversed_later.py").write_text(textwrap.dedent("""
        from perfbench.harness.window import Recorder
        from perfbench.traffic.closed_batches import make_pool
        def run_window(call, pool, traffic, seconds, keep, seed):
            rec = Recorder(keep, seed)
            i = 0
            while rec.end < rec.start + seconds:
                rec.batch(call, *pool[-1 - i % len(pool)])
                i += 1
            return rec.window()
    """))
    mix = json.loads((data / "traffic" / "b64-k5.json").read_text())
    mix.update(name="b4-k3", batch=4, k=3, generator="reversed_later")
    (data / "traffic" / "b4-k3.json").write_text(json.dumps(mix))
    shutil.copy(data / "limits" / "tiny12.b64-k5.json",
                data / "limits" / "later16.b4-k3.json")
    (data / "metrics" / "batches_later.py").write_text(textwrap.dedent("""
        def read(ctx):
            return float(ctx.window.batches)
    """))

    # new entries of BENCHMARK.json
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "later16", "source": "a test",
                         "file": f"{BENCH.name}/configs/later16.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "later16.b4-k3", "config": "later16",
                           "traffic": "b4-k3", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "batches_later", "unit": "batches",
                           "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "queries_per_s",
                           "workloads": ["later16.b4-k3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    script = textwrap.dedent(f"""
        import argparse, json, sys, time
        sys.path.insert(0, {str(root)!r})
        import torch
        from perfbench.harness import bench
        assert bench.__file__.startswith({str(root)!r})
        a = argparse.Namespace(workload="later16.b4-k3", seed=3,
                               seconds=0.3, trace=1)
        r = bench.run(a, time.perf_counter(), torch.device("cpu"))
        print(json.dumps(r))
    """)
    p = subprocess.run([sys.executable, "-c", script], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["batches_later"]["value"] > 0
    assert "batches_later" in r["metrics"]
    after = _digests(data)
    assert {k: after[k] for k in before} == before
