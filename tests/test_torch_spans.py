"""The span recorder (core/timing.Spans) and the spans the port records
with it on the CPU: the recorder's parents, batch ids, self times and
totals, on one thread and from two at once; the certified batch's phases
(`Retriever.record_spans`), which change no answer and, under a profiler
session, alone show up as ranges; the coalescer's spans and the service's
`/metrics`.

Every join, wait and HTTP call has a timeout, and servers bind port 0."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from spotify_recommender_tpu_torch import cli
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.core.timing import SpanRecord, Spans, span
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever
from spotify_recommender_tpu_torch.serve.server import (
    RecommenderService,
    make_server,
)

TIMEOUT = 60          # seconds: every join, wait and HTTP call
W = 128               # the default bin width of the certified layout

# the certified batch's phases: the spans without children
PHASES = {"entry.to_host", "cert.inputs", "cert.prologue", "cert.scan",
          "cert.rerank", "cert.oracle", "cert.sync", "cert.rescan",
          "cert.fallback"}
PARENTS = {
    "entry.batch": None, "entry.to_host": "entry.batch",
    "cert.start": "entry.batch", "cert.finish": "entry.batch",
    "cert.inputs": "cert.start", "cert.prologue": "cert.start",
    "cert.scan": "cert.start", "cert.rerank": "cert.start",
    "cert.oracle": "cert.start", "cert.sync": "cert.finish",
    "cert.rescan": "cert.finish", "cert.fallback": "cert.finish",
}


def _catalog(feats: np.ndarray) -> Catalog:
    n, f = feats.shape
    ids = np.array([f"t{j}" for j in range(n)])
    return Catalog(
        features=feats, norms=None, track_ids=ids,
        track_names=np.array([f"Song {j}" for j in range(n)]), artists=ids,
        genre_ids=np.zeros(n, np.int32), genre_names=["genre"],
        min_vals=np.zeros(f - 1, np.float32),
        max_vals=np.ones(f - 1, np.float32),
    )


def _one_bin_catalog(seed: int, num_hot: int, gap: float):
    """The top `num_hot` rows of one query in one scan bin (columns 13,
    13 + W, ...), cosines 1, 1 - gap, ...; the filler rows score far
    lower (tests/test_torch_certified.py's case)."""
    rng = np.random.default_rng(seed)
    n, f = 8192, 12
    feats = 0.01 * rng.standard_normal((n, f)).astype(np.float32)
    target = rng.random(f).astype(np.float32) + 1.0
    v = rng.standard_normal(f).astype(np.float32)
    v -= (v @ target) / (target @ target) * target
    v /= np.linalg.norm(v)
    tu = target / np.linalg.norm(target)
    for rank in range(num_hot):
        feats[13 + rank * W] = tu + np.float32(np.sqrt(2.0 * gap * rank)) * v
    return feats, target[None, :]


@pytest.fixture(scope="module")
def forced():
    """A retriever and a batch whose first query is rescanned and then
    served by the oracle (depth 2, escalation 3, six rows in one bin),
    the rest certified at once."""
    feats, target = _one_bin_catalog(15, 6, 5e-4)
    rng = np.random.default_rng(3)
    q = np.concatenate([target, feats[rng.integers(0, len(feats), 7)]])
    excl = np.concatenate([[-1], rng.integers(0, len(feats), 7)])
    cfg = RetrievalConfig(scan_depth=2, scan_escalate=3)
    return Retriever(_catalog(feats), cfg, "cpu"), q, excl


# ----------------------------------------------------------- the recorder

def test_parent_batch_self_time_and_totals_on_one_thread():
    sp = Spans()
    with sp("root"):
        with sp("a", phase=True):
            time.sleep(0.002)
        with sp("b", phase=True):
            time.sleep(0.001)
    with sp("root"):
        with sp("a"):
            pass
    recs = sp.records()
    assert all(isinstance(r, SpanRecord) for r in recs)
    assert [(r.name, r.parent) for r in recs] == [
        ("a", "root"), ("b", "root"), ("root", None), ("a", "root"),
        ("root", None)]
    first, second = recs[2].batch, recs[4].batch
    assert first != second
    assert [r.batch for r in recs] == [first] * 3 + [second] * 2
    assert all(r.end_ns >= r.start_ns for r in recs)

    def ns(r):
        return r.end_ns - r.start_ns

    tot = sp.totals()
    assert {n: t["count"] for n, t in tot.items()} == {
        "root": 2, "a": 2, "b": 1}
    assert tot["a"]["s"] == pytest.approx((ns(recs[0]) + ns(recs[3])) * 1e-9)
    assert tot["a"]["s"] >= 0.002
    # self time: the roots' durations less their children's, exactly
    own = ns(recs[2]) - ns(recs[0]) - ns(recs[1]) + ns(recs[4]) - ns(recs[3])
    assert tot["root"]["self_s"] == pytest.approx(own * 1e-9)
    assert tot["root"]["s"] == pytest.approx(
        (ns(recs[2]) + ns(recs[4])) * 1e-9)
    assert tot["b"]["self_s"] == tot["b"]["s"]


def test_spans_of_two_threads_at_once_keep_their_own_parents():
    sp = Spans()
    barrier = threading.Barrier(2, timeout=TIMEOUT)
    errors = []

    def work(tag):
        try:
            with sp(f"root.{tag}"):
                barrier.wait()      # both roots open at once
                with sp(f"child.{tag}", phase=True):
                    barrier.wait()  # both children open at once
                    with sp(f"leaf.{tag}"):
                        pass
                barrier.wait()
        except Exception as e:      # reported below, not lost in a thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = {r.name: r for r in sp.records()}
    assert len(recs) == 6
    for tag in "xy":
        root = recs[f"root.{tag}"]
        assert root.parent is None
        assert recs[f"child.{tag}"].parent == f"root.{tag}"
        assert recs[f"leaf.{tag}"].parent == f"child.{tag}"
        assert (recs[f"child.{tag}"].batch == recs[f"leaf.{tag}"].batch
                == root.batch)
    assert recs["root.x"].batch != recs["root.y"].batch
    tot = sp.totals()
    for tag in "xy":
        child = recs[f"child.{tag}"]
        leaf = recs[f"leaf.{tag}"]
        assert tot[f"child.{tag}"]["self_s"] == pytest.approx(
            (child.end_ns - child.start_ns - leaf.end_ns + leaf.start_ns)
            * 1e-9)


def test_record_from_another_thread_and_a_given_batch():
    sp = Spans()
    bid = sp.new_batch()
    t0 = time.perf_counter_ns()
    done = threading.Event()
    th = threading.Thread(target=lambda: (
        sp.record("wait", t0, time.perf_counter_ns(), batch=bid),
        done.set()))
    th.start()
    assert done.wait(TIMEOUT)
    th.join(timeout=TIMEOUT)
    with sp("root", batch=bid):
        with sp("child"):
            pass
    with sp("other"):
        pass
    recs = {r.name: r for r in sp.records()}
    assert recs["wait"].batch == recs["root"].batch == recs["child"].batch \
        == bid
    assert recs["wait"].parent is None and recs["wait"].start_ns == t0
    assert recs["other"].batch != bid
    assert sp.totals()["wait"]["self_s"] == sp.totals()["wait"]["s"]


def test_the_ring_keeps_the_newest_and_the_totals_all():
    sp = Spans()
    for j in range(Spans.RING + 3):
        with sp(f"s{j % 5}"):
            pass
    recs = sp.records()
    assert len(recs) == Spans.RING
    assert [r.name for r in recs[:2]] == ["s3", "s4"]
    assert [r.batch for r in recs[:2]] == [3, 4]
    assert sum(t["count"] for t in sp.totals().values()) == Spans.RING + 3


def test_a_trainers_read_sums_per_name_and_clears():
    sp = Spans(torch.device("cpu"))
    for _ in range(2):
        with span(sp, "step"):
            time.sleep(0.001)
    ms = sp.read()
    assert set(ms) == {"step"} and ms["step"] >= 2.0
    assert sp.read() == {}
    assert sp.totals()["step"]["count"] == 2


def test_off_costs_one_check_and_records_nothing():
    assert span(None, "x") is span(None, "y", phase=True)
    with span(None, "x"):
        pass


# ----------------------------------------------------- the certified batch

def test_off_path_records_nothing(forced, monkeypatch):
    retriever, q, excl = forced
    fresh = Retriever(retriever.catalog, retriever.config, "cpu")
    assert fresh.spans is None and fresh.certified.spans is None

    def closed(*a, **kw):
        raise AssertionError("a span was recorded with recording off")

    monkeypatch.setattr(Spans, "_close", closed)
    monkeypatch.setattr(Spans, "__call__", closed)
    s, i = fresh.retrieve_host(q, k=6, exclude_rows=excl)
    assert s.shape == i.shape == (len(q), 6)


def test_answers_bitwise_the_same_with_recording_on(forced):
    retriever, q, excl = forced
    fresh = Retriever(retriever.catalog, retriever.config, "cpu")
    for k in (6, 300):            # the scan's path and k > depth x W
        s0, i0 = fresh.retrieve_host(q, k=k, exclude_rows=excl)
        t0, j0 = fresh.retrieve(q, k=k, exclude_rows=excl)
        sp = fresh.record_spans()
        assert fresh.record_spans() is sp and fresh.spans is sp
        assert fresh.certified.spans is sp
        s1, i1 = fresh.retrieve_host(q, k=k, exclude_rows=excl)
        t1, j1 = fresh.retrieve(q, k=k, exclude_rows=excl)
        np.testing.assert_array_equal(s0.view(np.uint32), s1.view(np.uint32))
        np.testing.assert_array_equal(i0, i1)
        assert torch.equal(t0.view(torch.int32), t1.view(torch.int32))
        assert torch.equal(j0, j1)
        fresh.spans = fresh.certified.spans = None   # off again


def _batches(sp):
    out = {}
    for r in sp.records():
        out.setdefault(r.batch, []).append(r)
    return list(out.values())


def test_a_batch_records_every_phase_of_the_tier(forced):
    retriever, q, excl = forced
    sp = Spans()
    assert retriever.record_spans(sp) is sp
    cert = retriever.certified
    esc, fb = cert.escalations, cert.fallbacks
    retriever.retrieve_host(q, k=6, exclude_rows=excl)
    assert cert.escalations == esc + 1 and cert.fallbacks == fb + 1
    [batch] = _batches(sp)
    names = [r.name for r in batch]
    assert sorted(names) == sorted([
        "entry.batch", "entry.to_host", "cert.start", "cert.inputs",
        "cert.prologue", "cert.scan", "cert.rerank", "cert.finish",
        "cert.sync", "cert.sync", "cert.rescan", "cert.fallback"])
    for r in batch:
        assert r.parent == PARENTS[r.name], r
    by = {r.name: r for r in batch}
    root = by["entry.batch"]
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
               for r in batch)
    # the phases run in this order, one after another
    order = ["cert.inputs", "cert.prologue", "cert.scan", "cert.rerank",
             "cert.sync", "cert.rescan", "cert.sync", "cert.fallback",
             "entry.to_host"]
    phases = sorted((r for r in batch if r.name in PHASES),
                    key=lambda r: r.start_ns)
    assert [r.name for r in phases] == order
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    tot = sp.totals()
    for parent in ("cert.start", "cert.finish"):
        kids = sum(tot[n]["s"] for n, p in PARENTS.items()
                   if p == parent and n in tot)
        assert tot[parent]["self_s"] == pytest.approx(
            tot[parent]["s"] - kids, abs=1e-9)
    # a batch of certified queries: no rescan, no fallback
    sp2 = retriever.record_spans(Spans())
    retriever.retrieve(q[1:], k=6, exclude_rows=excl[1:])
    [batch] = _batches(sp2)
    assert sorted(r.name for r in batch) == sorted([
        "entry.batch", "cert.start", "cert.inputs", "cert.prologue",
        "cert.scan", "cert.rerank", "cert.finish", "cert.sync"])


def test_k_beyond_the_scan_records_the_oracle(forced):
    retriever, q, excl = forced
    sp = retriever.record_spans(Spans())
    retriever.retrieve_host(q, k=300, exclude_rows=excl)   # > depth 2 x W
    [batch] = _batches(sp)
    assert sorted(r.name for r in batch) == sorted([
        "entry.batch", "entry.to_host", "cert.start", "cert.inputs",
        "cert.oracle", "cert.finish"])
    for r in batch:
        assert r.parent == PARENTS[r.name], r


def test_only_the_phases_are_ranges_of_a_profiler_session(forced):
    from torch.profiler import ProfilerActivity, profile

    retriever, q, excl = forced
    sp = retriever.record_spans(Spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        retriever.retrieve_host(q, k=6, exclude_rows=excl)
        retriever.retrieve_host(q, k=300, exclude_rows=excl)
    ours = [e.name for e in prof.events()
            if e.name.startswith(("cert.", "entry."))]
    recorded = [r.name for r in sp.records()]
    assert sorted(ours) == sorted(n for n in recorded if n in PHASES)
    assert set(ours) == PHASES
    # outside a session, no range is opened
    assert not torch.autograd.profiler._is_profiler_enabled


# ----------------------------------------------------------- the service

def _service(record_spans, window_ms=20.0):
    feats, _ = _one_bin_catalog(15, 6, 5e-4)
    return RecommenderService(_catalog(feats[:2048]), RetrievalConfig(),
                              coalesce_window_ms=window_ms, device="cpu",
                              record_spans=record_spans)


def test_a_coalesced_request_shares_its_batch_id():
    svc = _service(True)
    try:
        out = {}

        def ask(j):
            out[j] = svc.recommend(f"Song {j}", by_id=False, k=5)["status"]

        threads = [threading.Thread(target=ask, args=(j,)) for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert out == {j: 200 for j in range(4)}
        recs = svc.spans.records()
        assert svc.retriever.spans is svc.spans
        batches = {}
        for r in recs:
            batches.setdefault(r.batch, []).append(r)
        queued = [r for r in recs if r.name == "serve.queue"]
        assert len(queued) == 4
        for bid in {r.batch for r in queued}:
            names = {r.name for r in batches[bid]}
            assert {"serve.window", "serve.queue", "serve.gather",
                    "serve.batch", "serve.deliver", "entry.batch",
                    "cert.scan", "entry.to_host"} <= names
            by = {r.name: r for r in batches[bid]}
            assert by["entry.batch"].parent == "serve.batch"
            assert by["serve.batch"].parent is None
            for r in batches[bid]:
                if r.name == "serve.queue":
                    assert r.end_ns <= by["serve.gather"].start_ns
        m = svc.metrics()["spans"]
        assert m["serve.queue"]["count"] == 4
        assert set(m["serve.batch"]) == {"count", "ms", "self_ms"}
        assert m["serve.batch"]["self_ms"] <= m["serve.batch"]["ms"]
    finally:
        svc.close()


def test_a_reloaded_retriever_keeps_recording(tmp_path):
    svc = _service(True, window_ms=0.0)
    try:
        path = tmp_path / "cat.npz"
        svc.retriever.catalog.save(str(path))
        assert svc.reload(str(path))["status"] == 200
        assert svc.retriever.spans is svc.spans
        assert svc.recommend("Song 1", by_id=False, k=3)["status"] == 200
        assert svc.metrics()["spans"]["entry.batch"]["count"] == 1
    finally:
        svc.close()


@pytest.mark.parametrize("record_spans", [False, True])
def test_metrics_show_spans_only_when_recording(record_spans):
    feats, _ = _one_bin_catalog(15, 6, 5e-4)
    srv = make_server(_catalog(feats[:1024]), "127.0.0.1", 0,
                      RetrievalConfig(), coalesce_window_ms=0.0,
                      device="cpu", record_spans=record_spans)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{base}/recommend?song=Song%202&n=3",
                                    timeout=TIMEOUT) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/metrics", timeout=TIMEOUT) as r:
            body = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_service.close()
        srv.server_close()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert ("spans" in body) == record_spans
    if record_spans:
        assert body["spans"]["serve.batch"]["count"] == 1
        assert body["spans"]["entry.batch"]["count"] == 1


def test_serve_takes_record_spans(monkeypatch):
    seen = {}

    def fake_serve(path, host, port, device, record_spans):
        seen.update(path=path, record_spans=record_spans)
        return 0

    monkeypatch.setattr("spotify_recommender_tpu_torch.serve.server.serve",
                        fake_serve)
    assert cli.main(["--device", "cpu", "serve", "--catalog", "c.npz",
                     "--record-spans"]) == 0
    assert seen == {"path": "c.npz", "record_spans": True}
    assert cli.main(["--device", "cpu", "serve", "--catalog", "c.npz"]) == 0
    assert seen["record_spans"] is False

