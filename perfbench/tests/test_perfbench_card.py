"""On the card (skipped elsewhere): each cell at its own size, a short run
of the command that comes out correct, and each control (the TF32
reference, the card's own TF32 product, the program's approx tier), on
the cell's set-up and window, that fails the cell's limits.

    python3 -m pytest perfbench/tests/test_perfbench_card.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.harness import spec
from perfbench.tests.conftest import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cuda, cell):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell,
                        "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["correct"] is True and last["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cuda, cell):
    from perfbench.tools import readings

    c = spec.load_cell(cell)
    row = readings.readings(c, 2147483671, 1.0, cuda, native=True)
    assert all(row["program"][n] <= lim for n, lim in c.limits.items())
    for side in ("control", "control_native_tf32", "control_approx"):
        assert any(row[side][n] > lim for n, lim in c.limits.items()), side
