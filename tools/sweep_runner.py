"""The runner that tools/ablation_sweep.py and tools/fused_k_sweep.py
share: time one tool's cases in several checkouts, such as this one and
a `git archive` of the parent commit, in turns on the card.

Each round starts one worker process per checkout (`TOOL --worker ROOT
ARGS...`), in the checkouts' order, then in the reverse order in the next
round, and so on; the first round's workers also get `--check`.  A
worker imports its checkout's package (`import_checkout`), which builds
its libraries into the checkout's own `_build/`, and prints one JSON line
per case: `case`, `ms`, with `--check` `bitwise_plain`, optionally the
further times of TIMES, and any other keys of its own.  A line without
`ms` (a case the checkout does not take) is left out.  `run` prints one
JSON line per (case, checkout), the median of each time over the rounds
beside each round's `ms`, then the card's name and power limit; with
`out` it writes them as one JSON file, and it exits non-zero if a case
differed from its plain version.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# times a worker's line may hold beside `ms`; each goes out as its median
TIMES = ("device_ms", "host_us")


def import_checkout(root: Path, tool: str) -> None:
    """Put the checkout at `root` first on the import path and exit unless
    its package is the one imported."""
    sys.path.insert(0, str(root))
    import spotify_recommender_tpu_torch as pkg

    if not Path(pkg.__file__).resolve().is_relative_to(root.resolve()):
        sys.exit(f"{tool}: imported {pkg.__file__}, not {root}'s")


def run(script: str, builds: dict, args: list, rounds: int,
        out: Path | None, **meta) -> None:
    """Run `script`'s workers for each checkout of `builds` (name -> root)
    over `rounds` alternating rounds with the worker arguments `args`;
    `meta` goes into the JSON file beside the card and the rows."""
    tool = Path(script).stem
    times, more, equal, extra = {}, {}, {}, {}
    order = list(builds)
    for r in range(rounds):
        for build in (order if r % 2 == 0 else order[::-1]):
            cmd = [sys.executable, script, "--worker", str(builds[build]),
                   *args, *(["--check"] if r == 0 else [])]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode:
                sys.exit(f"{tool}: {build} failed\n{res.stderr}")
            for ln in res.stdout.splitlines():
                if not ln.startswith("{"):
                    continue
                row = json.loads(ln)
                if "ms" not in row:
                    continue
                key = (row.pop("case"), build)
                times.setdefault(key, []).append(row.pop("ms"))
                for t in TIMES:
                    if t in row:
                        more.setdefault(key + (t,), []).append(row.pop(t))
                if "bitwise_plain" in row:
                    equal[key] = row.pop("bitwise_plain")
                extra.setdefault(key, row)
    rows = []
    for (case, build), ts in times.items():
        row = dict(case=case, build=build, ms=statistics.median(ts),
                   rounds=ts, **extra[case, build],
                   bitwise_plain=equal.get((case, build)))
        for t in TIMES:
            if (case, build, t) in more:
                row[t] = statistics.median(more[case, build, t])
        rows.append(row)
        print(json.dumps(row), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=gpu, **meta, rows=rows),
                                  indent=1))
    if not all(equal.values()):
        sys.exit(f"{tool}: a case differs from its plain version")
