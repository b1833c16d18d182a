"""What a run is made of, found by name: the cell in BENCHMARK.json, its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), its correctness limits (limits/<cell>.json), the
configuration's input maker (inputs/<name>.py) and system under test
(systems/<name>.py), the mix's generator (traffic/<generator>.py) and each
per-layer metric's reader (metrics/<metric>.py).  A later cell,
configuration, mix, generator or metric is a new file of these folders
and an entry in BENCHMARK.json; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
PACKAGE = BENCH_DIR.name


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]      # the cell's end-to-end metric entries
    per_layer: List[dict]       # the cell's per-layer metric entries


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files; raises
    KeyError for a cell the file does not list."""
    root = Path(root) if root is not None else ROOT
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    data = root / PACKAGE
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_load_json(root / conf["file"]),
        traffic=_load_json(data / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(data / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def module(kind: str, name: str):
    """The module `name` of the benchmark's folder `kind` ("inputs",
    "systems", "traffic", "metrics"), imported by its file name."""
    return importlib.import_module(f"{PACKAGE}.{kind}.{name}")
