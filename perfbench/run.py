"""The benchmark of spotify_recommender_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards that the
cell asks for (BENCHMARK.json); without them it exits 3 and prints no
result.  See perfbench/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches at fixed paths inside the checkout: only a checkout's first run
# of a cell builds or compiles anything
CACHE = ROOT / ".perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path[0] = str(ROOT)

from perfbench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T0))
