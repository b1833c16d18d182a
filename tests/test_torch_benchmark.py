"""The port's benchmark entry on the CPU against the JAX package's
`benchmark.py`: the same inputs bit for bit, the same metric string and
`details` keys for each backend (the JAX harness run with its Pallas
tiers in interpret mode), the JSON line, the suite's rows and budget, and
the fallback count per batch call."""

import functools
import json

import numpy as np
import pytest
import torch

from spotify_recommender_tpu import benchmark as jbench
from spotify_recommender_tpu.ops.pallas import fused_topk as jfused
from spotify_recommender_tpu_torch import benchmark, cli
from spotify_recommender_tpu_torch.core.config import TwoTowerConfig
from spotify_recommender_tpu_torch.models import two_tower
from spotify_recommender_tpu_torch.ops import fused_topk

SMALL = dict(num_items=4096, num_queries=16, warmup=1, iters=1)


@pytest.mark.parametrize("n,b,dim,seed", [
    (4096, 16, 12, 0), (1000, 1024, 64, 3), (10, 1, 12, 7),
])
def test_make_inputs_bitwise_equal_jax(n, b, dim, seed):
    for ours, theirs in zip(benchmark._make_inputs(n, b, dim, seed),
                            jbench._make_inputs(n, b, dim, seed)):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX harness's Pallas tiers in interpret mode (they do not lower
    to the CPU otherwise)."""
    for name in ("FusedRetriever", "ApproxRetriever", "CertifiedRetriever"):
        monkeypatch.setattr(jfused, name, functools.partial(
            getattr(jfused, name), interpret=True))


@pytest.mark.parametrize("backend", list(benchmark.BACKENDS))
def test_row_has_the_jax_metric_and_details_keys(backend, jax_interpret):
    ours = benchmark.run_benchmark(backend=backend, also_b1=True,
                                   device="cpu", **SMALL)
    theirs = jbench.run_benchmark(backend=backend, also_b1=True, **SMALL)
    assert ours.metric == theirs.metric
    assert ours.unit == theirs.unit
    assert set(ours.details) == set(theirs.details)
    assert ours.details["num_items"] == theirs.details["num_items"] == 4096
    want = {"auto": "oracle", "xla": "oracle", "pallas": "pallas",
            "bf16": "bf16-approx", "certified": "certified"}[backend]
    assert ours.details["backend"] == want
    assert ours.details["platform"] == "cpu"
    assert ours.value > 0 and ours.vs_baseline == round(
        ours.value / benchmark.REFERENCE_QPS, 2)


def test_to_json_line_round_trips():
    r = benchmark.run_benchmark(backend="certified", device="cpu", **SMALL)
    line = benchmark.to_json_line(r)
    assert "\n" not in line
    back = json.loads(line)
    assert benchmark.BenchResult(**back) == r
    assert list(back) == ["metric", "value", "unit", "vs_baseline", "details"]


def test_fallbacks_are_counted_per_batch_call(monkeypatch):
    """Every query fails its certificate (an impossible margin): each of
    the B = 16 batch calls sends all 16 queries to the oracle, so the count
    per batch is 16, whatever the B = 1 calls add.  (The JAX harness divides
    every call's fallbacks by warmup + iters + 1.)"""
    monkeypatch.setattr(fused_topk, "BF16X2_EPS", 10.0)
    r = benchmark.run_benchmark(backend="certified", also_b1=True, reps=2,
                                device="cpu", **SMALL)
    assert r.details["certificate_fallback_queries_per_batch"] == 16


def test_verify_holds_answers_to_the_oracle(monkeypatch):
    benchmark.run_benchmark(backend="certified", verify_queries=8,
                            device="cpu", **SMALL)
    benchmark.run_benchmark(backend="pallas", verify_queries=8,
                            device="cpu", **SMALL)
    with pytest.raises(ValueError, match="exact backend"):
        benchmark.run_benchmark(backend="bf16", verify_queries=8,
                                device="cpu", **SMALL)
    # a tier whose answers are wrong is caught
    real = fused_topk.CertifiedRetriever.__call__

    def off_by_one(self, q, k, excl=None):
        s, i = real(self, q, k, excl)
        return s, (i + 1) % self.num_items

    monkeypatch.setattr(fused_topk.CertifiedRetriever, "__call__", off_by_one)
    with pytest.raises(AssertionError, match="fixed-order oracle"):
        benchmark.run_benchmark(backend="certified", verify_queries=8,
                                device="cpu", **SMALL)


@pytest.fixture
def one_thread():
    """Torch's CPU ops in one thread, for the tests that run the quality
    row: its 2000 small training steps enter OpenMP regions whose threads,
    with other test processes on the cores, wait on each other (six rows
    at once on an 8-core x86-64 CPU: 790 s each at 8 threads, 4.7 s at
    one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_rows(monkeypatch):
    """The suite's rows at CPU sizes: each row's own arguments, but few
    items and queries."""
    rb, rs, rst = (benchmark.run_benchmark, benchmark.run_serve_row,
                   benchmark.run_streaming_row)

    def run_benchmark(**kw):
        kw.update(num_items=min(kw["num_items"], 5000), num_queries=16,
                  backend=kw.get("backend", "certified"))
        return rb(**kw)

    monkeypatch.setattr(benchmark, "run_benchmark", run_benchmark)
    monkeypatch.setattr(benchmark, "run_serve_row", functools.partial(
        rs, num_items=3000, n_clients=4, reqs_each=2, max_queue=8))
    monkeypatch.setattr(benchmark, "run_streaming_row", functools.partial(
        rst, num_items=20000, num_queries=8, window=4096))


def test_suite_records_skipped_rows_under_a_zero_budget(small_rows, capsys):
    r = benchmark.run_benchmark_suite(time_budget_s=0.0, device="cpu")
    assert r.details["skipped_rows"] == ["10M", "quality", "serve",
                                         "streaming", "64dim", "bf16"]
    head = capsys.readouterr().out.splitlines()
    assert len(head) == 1 and json.loads(head[0])["metric"] == r.metric


def test_suite_runs_every_row(small_rows, one_thread, capsys):
    r = benchmark.run_benchmark_suite(time_budget_s=600.0, device="cpu")
    d = r.details
    assert "skipped_rows" not in d
    for key in ("exact_10M_qps", "exact_10M_batch_ms", "exact_10M_stream_GBps",
                "exact_10M_B1_latency_ms", "exact_10M_B1_stream_GBps",
                "serve_req_per_s", "serve_p50_ms", "serve_p95_ms",
                "serve_p99_ms", "serve_errors", "serve_burst_requests",
                "serve_burst_rejected_429", "streaming_qps", "streaming_GBps",
                "hostlink_GBps", "streaming_link_efficiency",
                "exact_1M_64dim_qps", "approx_bf16_1M_qps",
                "mf_als_recall_at_10", "mf_als_ndcg_at_10",
                "two_tower_recall_at_10", "two_tower_ndcg_at_10"):
        assert key in d, key
    assert d["serve_errors"] == 0
    assert 0 <= d["serve_burst_rejected_429"] <= d["serve_burst_requests"]


def test_a_failing_row_raises(small_rows, one_thread, monkeypatch):
    def broken(**kw):
        raise RuntimeError("serve row broke")

    monkeypatch.setattr(benchmark, "run_serve_row", broken)
    with pytest.raises(RuntimeError, match="serve row broke"):
        benchmark.run_benchmark_suite(time_budget_s=600.0, device="cpu")


def test_main_prints_the_headline_then_the_suite_line(small_rows, capsys):
    assert benchmark.main(["--device", "cpu", "--time-budget", "0"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    first, last = map(json.loads, lines)
    assert first["metric"] == last["metric"]
    assert "skipped_rows" not in first["details"]
    assert last["details"]["skipped_rows"][0] == "10M"


def test_main_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main([])


@pytest.mark.parametrize("backend", ["bf16", "certified"])
def test_cli_benchmark(backend, capsys):
    rc = cli.main(["--device", "cpu", "benchmark", "--items", "3000",
                   "--queries", "8", "--backend", backend])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    kind = "approx" if backend == "bf16" else "exact"
    assert json.loads(out)["metric"] == (
        f"queries/sec/chip {kind} top-10 over 3000 items")


# the JAX subcommands the port lacked before the MF path: the one still
# missing exits 1 as not ported; the MF and two-tower ones exit 1, with one
# line, where they refuse their input (a mesh: as not ported)
STILL_EXIT_1 = {
    "autotune": [], "train-two-tower": ["--mesh", "data=2"],
    "evaluate-two-tower": ["inter.csv", "--two-tower", "tt.npz",
                           "--catalog", "cat.npz"],
    "train-mf": ["inter.csv", "--mesh", "catalog=2"],
    "evaluate-mf": ["inter.csv", "--mf", "small.npz"],
    "recommend-user": ["--mf", "small.npz", "--user", "40"],
    "embed-catalog": ["--mf", "small.npz", "--catalog", "cat.npz"],
}


@pytest.mark.parametrize("command", list(STILL_EXIT_1))
def test_unported_subcommands_still_exit_1(command, capsys, tmp_path,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "inter.csv").write_text(
        "user_id,item_id,count\n" + "".join(f"{u},{u % 7},1\n" for u in range(60)))
    np.savez(tmp_path / "small.npz", user_factors=np.ones((30, 4), np.float32),
             item_factors=np.ones((7, 4), np.float32))
    # a 3-row catalog: the 7 MF items and the interactions' 7 items exceed it
    benchmark._serve_catalog(np.ones((3, 12), np.float32)).save(
        str(tmp_path / "cat.npz"))
    cfg = TwoTowerConfig(embedding_dim=4, hidden_dims=(8,))
    two_tower.save_model(str(tmp_path / "tt.npz"), two_tower.init_params(
        cfg, 12, torch.Generator().manual_seed(0)), cfg)
    assert (command in cli.NOT_PORTED) == (not STILL_EXIT_1[command])
    assert cli.main(["--device", "cpu", command, *STILL_EXIT_1[command]]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: ") and err.count("\n") == 1
    if command in cli.NOT_PORTED or "--mesh" in STILL_EXIT_1[command]:
        assert "not ported" in err


def test_quality_row_equals_jax_train_and_eval(one_thread):
    """The MF keys of `run_quality_row` equal the JAX package's
    `train_als` + `evaluate_ranking_arrays` called with the row's own
    arguments; the row has the JAX row's keys (its two-tower keys are held
    to the JAX row in tests/test_torch_two_tower.py)."""
    from spotify_recommender_tpu.core.config import MFConfig
    from spotify_recommender_tpu.models import mf as jmf

    row = benchmark.run_quality_row(device="cpu")
    assert sorted(row) == ["mf_als_ndcg_at_10", "mf_als_recall_at_10",
                           "two_tower_ndcg_at_10", "two_tower_recall_at_10"]
    inter, _, _ = jmf.synthetic_interactions(
        num_users=2000, num_items=1000, latent_dim=8, seed=0)
    train_i, held_idx, held_mask, seen_idx, seen_mask = (
        jmf.split_leave_k_out_arrays(inter, k=1, seed=0))
    users, items = jmf.train_als(train_i, MFConfig(
        embedding_dim=16, num_iterations=6, reg=0.05, alpha=10.0, seed=0))
    el = np.nonzero(held_mask.any(axis=1))[0]
    m = jmf.evaluate_ranking_arrays(
        users, items, el, held_idx[el], held_mask[el], k=10,
        seen_idx=seen_idx[el], seen_mask=seen_mask[el])
    mf_keys = {k: row[k] for k in ("mf_als_recall_at_10", "mf_als_ndcg_at_10")}
    assert mf_keys == {"mf_als_recall_at_10": round(m["recall@k"], 4),
                       "mf_als_ndcg_at_10": round(m["ndcg@k"], 4)}
    assert mf_keys == {"mf_als_recall_at_10": 0.5916, "mf_als_ndcg_at_10": 0.4064}


def test_quality_data_digests_cover_the_jax_packages_data():
    """The digests replay the quality row's draws; their last two steps
    digest the JAX package's interactions and split for the same seed."""
    import hashlib

    from spotify_recommender_tpu.models import mf as jmf

    def digest(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:12]

    d = benchmark.quality_data_digests()
    assert list(d) == ["normal", "logits", "weights", "p", "choice", "counts",
                       "interactions", "split"]
    inter, _, _ = jmf.synthetic_interactions(2000, 1000, 8, seed=0)
    split = jmf.split_leave_k_out_arrays(inter, k=1, seed=0)
    assert d["interactions"] == digest(inter.item_idx, inter.confidence,
                                       inter.mask)
    assert d["split"] == digest(split[0].item_idx, split[0].confidence,
                                split[0].mask, *split[1:])
    assert benchmark.quality_data_digests(seed=1)["normal"] != d["normal"]


def test_quality_row_runs_on_the_card_by_default():
    import inspect

    assert inspect.signature(benchmark.run_quality_row).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmark.run_quality_row()
