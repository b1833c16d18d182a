"""The result's last line and BENCHMARK.json against the benchmark's
contract; a machine with no card exits without a result."""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import pytest
import torch

from perfbench.harness import bench, spec
from perfbench.tests.conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_contract():
    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        f = json.loads((REPO / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    cells = b["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and _line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        (BENCH / "metrics" / f"{m['name']}.py").resolve(strict=True)
    for w in cells:
        cell = spec.load_cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_last_line_format(tiny_root, capsys):
    args = argparse.Namespace(workload="tiny12.b64-k5", seed=2**31 + 5,
                              seconds=0.3, trace=0)
    result = bench.run(args, time.perf_counter(), torch.device("cpu"),
                       root=tiny_root)
    bench.emit(result)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "check"
    assert last["correct"] is True and last["failed"] == 0
    assert set(last["metrics"]) == {"queries_per_s", "batch_p95_ms",
                                    "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # each number compared ends standard error beside its limit
    tail = err.strip().splitlines()[-len(last["check"]):]
    for line, (name, c) in zip(tail, last["check"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']}"


def test_traced_line(tiny_root):
    args = argparse.Namespace(workload="tiny12.b64-k5", seed=7, seconds=0.3,
                              trace=1)
    result = bench.run(args, time.perf_counter(), torch.device("cpu"),
                       root=tiny_root)
    assert result["correct"] is True
    assert {"step_mfu", "fallbacks_per_batch", "escalations_per_batch",
            "device_idle"} <= set(result["metrics"])
    assert "queries_per_s" not in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "audio12-1m.b1024-k10", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
