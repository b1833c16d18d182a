"""The port's autotuner (ops/autotune.py) on the CPU's plain kernels at
2048 x 8, mirroring the JAX package's tests/test_autotune.py: the sweep,
the cache, the log2 buckets, and the port's two repairs (failed
candidates recorded, nothing persisted with fewer than 2 successes).  The
times are the CPU's and only order the candidates; no tolerance applies:
every candidate's answers are the fixed-order oracle's bit for bit or the
candidate fails."""

import json
import logging
import os

import pytest
import torch

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops import autotune as jautotune
from spotify_recommender_tpu_torch import benchmark
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.ops import autotune, fused_topk

SHAPE = dict(n=2048, b=8, f=12, k=5)
GOOD = ((2, 3, 128, 8, 8192), (3, 0, 128, 8, 1024))
BAD = (2, 3, 128, 256, 0)            # catalog_tile 0: the layout divides by it


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "at.json"
    monkeypatch.setenv("SRT_AUTOTUNE_CACHE", str(path))
    return path


def test_tune_picks_and_persists_then_loads(cache):
    res = autotune.tune(**SHAPE, grid=GOOD, iters=1, reps=1, device="cpu")
    cfg = res.config
    assert isinstance(cfg, RetrievalConfig) and res.saved and not res.failed
    assert (cfg.scan_depth, cfg.scan_escalate) in ((2, 3), (3, 0))
    assert res.ms == min(c["ms"] for c in res.candidates) > 0
    with open(cache) as fh:
        entries = json.load(fh)
    assert list(entries) == [res.key] == ["cpu|n11|b3|f12|k5"]
    entry = entries[res.key]
    assert entry["n"] == 2048 and entry["ms"] > 0
    assert entry["catalog_tile"] == cfg.catalog_tile
    assert entry["query_tile"] == cfg.query_tile     # the JAX file's shape

    # read side: the same bucket hits and carries the base's other fields
    got = autotune.load_tuned(2048, 8, 12, 5, base=RetrievalConfig(prefilter=64),
                              device="cpu")
    assert got is not None and got.prefilter == 64
    assert (got.scan_depth, got.scan_bins, got.catalog_tile) == (
        cfg.scan_depth, cfg.scan_bins, cfg.catalog_tile)
    assert autotune.load_tuned(2000, 8, 12, 5, device="cpu") is not None
    assert autotune.load_tuned(1_000_000, 1024, 12, 5, device="cpu") is None
    assert autotune.load_tuned(2048, 8, 12, 10, device="cpu") is None


def test_load_tuned_empty_cache_returns_none(cache):
    assert autotune.load_tuned(4096, 16, 12, 10, device="cpu") is None
    cache.write_text("{not json")
    assert autotune.load_tuned(4096, 16, 12, 10, device="cpu") is None


def test_the_jax_package_reads_the_ports_entry(cache):
    """On the CPU both packages key the entry "cpu|...", and the JAX
    reader takes the fields it knows (it has no catalog_tile)."""
    res = autotune.tune(**SHAPE, grid=GOOD, iters=1, reps=1, device="cpu")
    got = jautotune.load_tuned(2048, 8, 12, 5, base=JConfig())
    assert got is not None
    assert (got.scan_depth, got.scan_escalate, got.scan_bins,
            got.query_tile) == (res.config.scan_depth, res.config.scan_escalate,
                                res.config.scan_bins, res.config.query_tile)


def test_failed_candidates_are_recorded(cache):
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    autotune.log.addHandler(handler)
    try:
        res = autotune.tune(**SHAPE, grid=(BAD, *GOOD), iters=1, reps=1,
                            device="cpu")
    finally:
        autotune.log.removeHandler(handler)
    assert res.saved and len(res.candidates) == 3
    [failed] = res.failed
    assert failed["catalog_tile"] == 0 and failed["ms"] is None
    assert failed["error"].startswith("ZeroDivisionError")
    assert any("tc=0 failed: ZeroDivisionError" in r.getMessage()
               for r in records)
    assert res.config.catalog_tile != 0


@pytest.mark.parametrize("grid", [(BAD, GOOD[0]), (GOOD[0],)])
def test_nothing_is_persisted_with_fewer_than_two_successes(cache, grid):
    res = autotune.tune(**SHAPE, grid=grid, iters=1, reps=1, device="cpu")
    assert not res.saved and not cache.exists()
    assert res.config.catalog_tile == GOOD[0][4]


def test_every_candidate_failing_raises(cache):
    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.tune(**SHAPE, grid=(BAD, BAD), iters=1, reps=1, device="cpu")
    assert not cache.exists()


def test_a_candidate_off_the_oracle_fails(cache, monkeypatch):
    """A candidate whose answers are not the fixed-order oracle's is a
    failure, not a fast candidate."""
    call = fused_topk.CertifiedRetriever.__call__

    def wrong_at_w256(self, queries, k, exclude_rows=None):
        s, i = call(self, queries, k, exclude_rows)
        return (s, i.flip(1)) if self.layout.w == 256 else (s, i)

    monkeypatch.setattr(fused_topk.CertifiedRetriever, "__call__",
                        wrong_at_w256)
    res = autotune.tune(**SHAPE, grid=(*GOOD, (2, 3, 256, 8, 8192)), iters=1,
                        reps=1, device="cpu")
    [failed] = res.failed
    assert failed["scan_bins"] == 256 and "fixed-order oracle" in failed["error"]


def test_the_grid_and_the_buckets():
    grid = autotune._DEFAULT_GRID
    jgrid = jautotune._DEFAULT_GRID
    assert len(grid) <= 8 and len(set(grid)) == len(grid)
    # JAX's five candidates at the default catalog tile, then catalog_tile
    # variants of the production default
    assert [g[:4] for g in grid[:5]] == [tuple(g) for g in jgrid]
    assert all(g[4] == RetrievalConfig().catalog_tile for g in grid[:5])
    assert {g[:4] for g in grid[5:]} == {jgrid[0]}
    assert autotune._candidate(jgrid[1])["catalog_tile"] == 8192
    for x in (1, 2, 3, 1000, 2048, 1_000_000):
        assert autotune._bucket(x) == jautotune._bucket(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        autotune.load_tuned(2048, 8, 12, 5)


@pytest.mark.parametrize("tuned", [False, True])
def test_the_benchmark_reads_the_cache(cache, tuned):
    if tuned:
        autotune.tune(n=3000, b=8, f=12, k=10, grid=GOOD, iters=1, reps=1,
                      device="cpu")
        want = json.loads(cache.read_text())["cpu|n12|b3|f12|k10"]
    else:
        want = {"scan_depth": 2, "scan_escalate": 3, "scan_bins": 128,
                "catalog_tile": RetrievalConfig().catalog_tile}
    r = benchmark.run_benchmark(num_items=3000, num_queries=8, warmup=1,
                                iters=1, backend="certified", device="cpu",
                                verify_queries=8)
    d = r.details
    assert d["autotuned"] is tuned
    for name in ("scan_depth", "scan_escalate", "scan_bins", "catalog_tile"):
        assert d[name] == want[name], name
    assert os.environ["SRT_AUTOTUNE_CACHE"] == str(cache)
