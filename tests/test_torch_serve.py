"""The port's HTTP service on the CPU: every case of tests/test_serve.py
against the port's service, with its answers held to the JAX service's on
the same catalog (the JAX cases use the oracle backend on both sides: rows
equal wherever neighbouring scores are more than 2e-6 apart, scores within
1e-6), plus the port's own cases: concurrent callers against serial calls,
the certified tier's `certificate_fallbacks`, the approx tier, the CLI.

Every join, wait and HTTP call has a timeout, servers bind port 0, and
each fixture closes what it opened in `finally`.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from conftest import make_songs_csv

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.data.catalog import from_raw_table as jax_from_raw
from spotify_recommender_tpu.data.csv_ingest import ingest_csv as jax_ingest
from spotify_recommender_tpu.serve.server import (
    RecommenderService as JaxService,
)
from spotify_recommender_tpu_torch import cli
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.data.catalog import from_raw_table
from spotify_recommender_tpu_torch.data.csv_ingest import ingest_csv
from spotify_recommender_tpu_torch.ops import fused_topk
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever
from spotify_recommender_tpu_torch.serve import server as srv_mod
from spotify_recommender_tpu_torch.serve.server import (
    RecommenderService,
    ServiceOverloaded,
    make_server,
)

TIMEOUT = 60          # seconds: every HTTP call, join and wait
ORACLE = RetrievalConfig(use_pallas=False)
SCORE_ATOL, SEP = 1e-6, 2e-6


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    return make_songs_csv(tmp_path_factory.mktemp("serve") / "songs.csv",
                          n_rows=100)


@pytest.fixture(scope="module")
def catalog(csv_path):
    return from_raw_table(ingest_csv(str(csv_path)))


@pytest.fixture(scope="module")
def jax_service(csv_path):
    svc = JaxService(jax_from_raw(jax_ingest(str(csv_path), use_native=False)),
                     JConfig(use_pallas=False))
    try:
        yield svc
    finally:
        svc.close()


def make_service(catalog, config=ORACLE, **kw):
    return RecommenderService(catalog, config, device="cpu", **kw)


@pytest.fixture(scope="module")
def service(catalog):
    svc = make_service(catalog)
    try:
        yield svc
    finally:
        svc.close()


def assert_same_answer(rows, scores, jrows, jscores):
    """Rows equal wherever the JAX scores' neighbours are > SEP apart,
    scores within SCORE_ATOL."""
    rows, jrows = np.atleast_2d(rows), np.atleast_2d(jrows)
    scores, jscores = np.atleast_2d(scores), np.atleast_2d(jscores)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=SCORE_ATOL)
    gap = np.diff(jscores, axis=1) < -SEP
    edge = np.ones((len(jscores), 1), bool)
    sep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
    np.testing.assert_array_equal(rows[sep], jrows[sep])


def assert_same_recommendation(out, jout):
    assert out["status"] == jout["status"]
    assert out["query"] == jout["query"]
    assert_same_answer([r["row"] for r in out["results"]],
                       [r["score"] for r in out["results"]],
                       [r["row"] for r in jout["results"]],
                       [r["score"] for r in jout["results"]])


def status_of(url, data=None, headers=None, method=None):
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def post(url, body):
    return status_of(url, json.dumps(body).encode(),
                     {"Content-Type": "application/json"}, "POST")


def run_threads(target, args_list):
    threads = [threading.Thread(target=target, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


@pytest.fixture(scope="class")
def http_server(request):
    """A live server over the module's catalog on port 0 (its URL)."""
    cat = request.getfixturevalue("catalog")
    srv = make_server(cat, "127.0.0.1", 0, ORACLE, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_service.close()
        srv.server_close()
        t.join(timeout=TIMEOUT)


class TestService:
    def test_recommend_by_name(self, service, jax_service):
        out = service.recommend("Song 5", by_id=False, k=3)
        assert out["status"] == 200
        assert len(out["results"]) == 3
        assert out["query"]["track_name"] == "Song 5"
        assert_same_recommendation(
            out, jax_service.recommend("Song 5", by_id=False, k=3))

    def test_recommend_missing(self, service, jax_service):
        out = service.recommend("zzz", by_id=False, k=3)
        assert out["status"] == 404
        assert out == jax_service.recommend("zzz", by_id=False, k=3)

    def test_retrieve_batched(self, service, jax_service, catalog):
        out = service.retrieve(catalog.features[:4].tolist(), k=5)
        assert out["status"] == 200
        assert np.asarray(out["rows"]).shape == (4, 5)
        jout = jax_service.retrieve(catalog.features[:4].tolist(), k=5)
        assert_same_answer(out["rows"], out["scores"], jout["rows"],
                           jout["scores"])

    def test_retrieve_bad_shape(self, service, jax_service):
        out = service.retrieve([[1.0, 2.0]], k=5)
        assert out["status"] == 400
        assert out == jax_service.retrieve([[1.0, 2.0]], k=5)

    def test_health(self, service, jax_service):
        h = service.health()
        assert h["status"] == "ok" and h["num_items"] == 100
        assert h["backend"] == "oracle"
        assert jax_service.health()["num_items"] == 100


class TestHTTPServer:
    def test_healthz(self, http_server):
        code, body = status_of(f"{http_server}/healthz")
        assert code == 200 and body["num_items"] == 100

    def test_recommend_roundtrip(self, http_server, jax_service):
        code, body = status_of(f"{http_server}/recommend?song=Song%207&n=4")
        assert code == 200 and len(body["results"]) == 4
        assert all(x["track_name"] != "Song 7" for x in body["results"])
        body["status"] = 200
        assert_same_recommendation(
            body, jax_service.recommend("Song 7", by_id=False, k=4))

    def test_recommend_404(self, http_server):
        code, body = status_of(f"{http_server}/recommend?song=zzz-none")
        assert code == 404 and "not found" in body["error"]

    def test_post_retrieve(self, http_server, jax_service, catalog):
        code, body = post(f"{http_server}/retrieve",
                          {"queries": catalog.features[:2].tolist(), "k": 3})
        assert code == 200 and np.asarray(body["rows"]).shape == (2, 3)
        jout = jax_service.retrieve(catalog.features[:2].tolist(), k=3)
        assert_same_answer(body["rows"], body["scores"], jout["rows"],
                           jout["scores"])

    def test_song_endpoint(self, http_server, jax_service):
        code, body = status_of(f"{http_server}/song/3")
        assert code == 200 and body["song"]["row"] == 3
        assert body["song"] == jax_service.song(3)["song"]


class TestMetrics:
    def test_metrics_accumulate(self, catalog):
        svc = make_service(catalog)
        try:
            svc.recommend("Song 1", by_id=False, k=2)
            svc.recommend("zzz-missing", by_id=False, k=2)
            m = svc.metrics()
            assert m["requests"] == 2
            assert m["errors"] == 1
            assert m["mean_latency_ms"] >= 0
        finally:
            svc.close()

    def test_metrics_endpoint(self, http_server):
        code, _ = status_of(f"{http_server}/recommend?song=Song%202&n=2")
        assert code == 200
        code, body = status_of(f"{http_server}/metrics")
        assert code == 200 and body["requests"] >= 1 and body["errors"] >= 0
        assert body["backend"] == "oracle"
        assert "certificate_fallbacks" not in body   # no certified tier


class TestCoalescer:
    def test_concurrent_requests_coalesce(self, catalog):
        """Concurrent /recommend traffic shares batches: with a generous
        window, 8 simultaneous requests land in fewer than 8 batches."""
        svc = make_service(catalog, coalesce_window_ms=100.0)
        try:
            results = [None] * 8

            def hit(i):
                results[i] = svc.recommend(f"Song {i}", by_id=False, k=3)

            run_threads(hit, [(i,) for i in range(8)])
            assert all(r["status"] == 200 for r in results)
            st = svc.coalescer.stats
            assert st["batched_requests"] == 8
            assert st["max_batch_size"] >= 2, st
            assert st["batches"] < 8, st
        finally:
            svc.close()

    def test_coalesced_results_match_direct(self, catalog, jax_service):
        """Batch-sliced results equal a direct retrieval."""
        svc = make_service(catalog, coalesce_window_ms=0.0)
        try:
            direct = Retriever(catalog, ORACLE, "cpu")
            out = svc.recommend("Song 7", by_id=False, k=4)
            want = direct.recommend_by_name("Song 7", 4)
            assert [r["row"] for r in out["results"]] == [w.row for w in want]
            assert_same_recommendation(
                out, jax_service.recommend("Song 7", by_id=False, k=4))
        finally:
            svc.close()

    def test_mixed_k_in_one_batch(self, catalog):
        svc = make_service(catalog, coalesce_window_ms=100.0)
        try:
            results = {}

            def hit(name, k):
                results[k] = svc.recommend(name, by_id=False, k=k)

            run_threads(hit, [("Song 1", 2), ("Song 2", 7)])
            assert len(results[2]["results"]) == 2
            assert len(results[7]["results"]) == 7
            # each slice equals its own direct call
            direct = Retriever(catalog, ORACLE, "cpu")
            for name, k in (("Song 1", 2), ("Song 2", 7)):
                assert [r["row"] for r in results[k]["results"]] == [
                    w.row for w in direct.recommend_by_name(name, k)]
        finally:
            svc.close()


class TestHardening:
    def test_bad_n_returns_400(self, http_server):
        assert status_of(f"{http_server}/recommend?song=Song+1&n=abc")[0] == 400

    def test_bad_song_row_returns_400(self, http_server):
        assert status_of(f"{http_server}/song/notanumber")[0] == 400

    def test_oversized_body_rejected(self, http_server):
        req = urllib.request.Request(
            f"{http_server}/retrieve", data=b"{}",
            headers={"Content-Length": str(10**9)}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        except (urllib.error.URLError, ConnectionError):
            code = 413  # the client may abort on the mismatched length
        assert code == 413

    def test_hot_reload(self, http_server, catalog, tmp_path):
        p = tmp_path / "cat2.npz"
        catalog.save(str(p))
        code, out = post(f"{http_server}/reload", {"catalog": str(p)})
        assert code == 200 and out["num_items"] == 100
        # the service still answers after the swap
        code, body = status_of(f"{http_server}/healthz")
        assert code == 200 and body["status"] == "ok"

    def test_reload_missing_file_400(self, http_server):
        code, out = post(f"{http_server}/reload",
                         {"catalog": "/nonexistent/x.npz"})
        assert code == 400 and "reload failed" in out["error"]


class TestWarmup:
    def test_warmup_compiles_buckets(self, catalog):
        svc = make_service(catalog)
        try:
            dt = svc.warmup(k=5, max_batch=32)
            assert dt >= 0
            # post-warmup requests still correct
            out = svc.recommend("Song 9", by_id=False, k=3)
            assert out["status"] == 200
        finally:
            svc.close()


class TestBackpressure:
    def test_queue_overflow_returns_429(self, catalog):
        """A burst past the coalescer's queue cap is shed with 429 at
        enqueue time, not discovered via the submit timeout."""
        svc = make_service(catalog, coalesce_window_ms=200.0, max_queue=2)
        try:
            q = np.asarray(catalog.features[0], np.float32)
            results = []

            def worker():
                try:
                    svc.coalescer.submit(q, 0, 2, timeout_s=TIMEOUT)
                    results.append(200)
                except ServiceOverloaded:
                    results.append(429)

            run_threads(worker, [()] * 6)
            assert results.count(429) >= 1, results
            assert results.count(200) >= 2, results
            assert svc.coalescer.stats["rejected"] >= 1
        finally:
            svc.close()

    def test_held_dispatcher_sheds_exactly_the_overflow(self, catalog):
        """While the dispatcher is held inside a batch, the queue takes
        `max_queue` requests and sheds every later one at enqueue time;
        once released, each accepted request gets a direct call's answer
        (the certified tier's, bitwise at any batch size)."""
        svc = make_service(catalog, None)
        gate, entered = threading.Event(), threading.Event()

        def held(queries, k, excl):
            entered.set()
            assert gate.wait(timeout=TIMEOUT)
            return svc._retrieve_batch(queries, k, excl)

        co = srv_mod.BatchCoalescer(held, window_ms=0.0, max_queue=4)
        feats = np.asarray(catalog.features, np.float32)
        got = {}

        def worker(i):
            got[i] = co.submit(feats[i], i, 3, timeout_s=TIMEOUT)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
        try:
            threads[0].start()
            assert entered.wait(timeout=TIMEOUT)    # request 0 holds it
            for t in threads[1:]:
                t.start()
            deadline = time.monotonic() + TIMEOUT
            while len(co._pending) < 4 and time.monotonic() < deadline:
                time.sleep(0.001)
            assert len(co._pending) == 4
            for i in range(5, 8):
                with pytest.raises(ServiceOverloaded):
                    co.submit(feats[i], i, 3, timeout_s=TIMEOUT)
            assert co.stats["rejected"] == 3
        finally:
            gate.set()
            for t in threads:
                if t.ident is not None:             # started
                    t.join(timeout=TIMEOUT)
            co.close()
            svc.close()
        assert not any(t.is_alive() for t in threads)
        for i in range(5):
            s, r = svc.retriever.retrieve_host(feats[i:i + 1], k=3,
                                               exclude_rows=np.array([i]))
            np.testing.assert_array_equal(got[i][1], r[0])
            np.testing.assert_array_equal(got[i][0], s[0])

    def test_latency_percentiles_in_metrics(self, catalog):
        svc = make_service(catalog)
        try:
            for _ in range(5):
                svc.recommend("Song 1", by_id=False, k=2)
            m = svc.metrics()
            assert m["p50_latency_ms"] > 0
            assert m["p99_latency_ms"] >= m["p50_latency_ms"]
            assert m["p95_latency_ms"] >= m["p50_latency_ms"]
        finally:
            svc.close()

    def test_recommend_maps_overload_to_429(self, catalog, monkeypatch):
        svc = make_service(catalog)
        try:
            def boom(*a, **kw):
                raise srv_mod.ServiceOverloaded("pending queue full")

            monkeypatch.setattr(svc.coalescer, "submit", boom)
            out = svc.recommend("Song 1", by_id=False, k=2)
            assert out["status"] == 429
        finally:
            svc.close()


# ---------------------------------------------------------------- the port's


class TestConcurrency:
    def test_concurrent_retrieve_equals_serial(self, catalog):
        """16 threads call one certified retriever at once (the service
        takes no lock around it), with a short switch interval: each answer
        equals the serial call's, bit for bit."""
        svc = make_service(catalog, RetrievalConfig())
        feats = catalog.features
        batches = [feats[(np.arange(4) * 7 + t) % len(feats)] for t in range(16)]
        serial = [svc.retrieve(b.tolist(), k=5) for b in batches]
        got = [[None] * 3 for _ in range(16)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def hit(t):
                for r in range(3):
                    got[t][r] = svc.retrieve(batches[t].tolist(), k=5)

            run_threads(hit, [(t,) for t in range(16)])
        finally:
            sys.setswitchinterval(old)
            svc.close()
        for t in range(16):
            for r in range(3):
                assert got[t][r] == serial[t]

    def test_fallback_counter_loses_no_update(self, catalog, monkeypatch):
        """Every query fails its certificate (an impossible margin), so the
        oracle serves it; 16 threads at once must count every fallback."""
        monkeypatch.setattr(fused_topk, "BF16X2_EPS", 10.0)
        svc = make_service(catalog, RetrievalConfig(scan_escalate=0))
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def hit(t):
                for _ in range(5):
                    svc.retrieve(catalog.features[t:t + 3].tolist(), k=4)

            run_threads(hit, [(t,) for t in range(16)])
        finally:
            sys.setswitchinterval(old)
            svc.close()
        assert svc.metrics()["certificate_fallbacks"] == 16 * 5 * 3


class TestPortBackends:
    def test_metrics_report_certificate_fallbacks(self, catalog, jax_service):
        """The certified backend (the default config) reports its oracle
        fallbacks; its answers are exact, so they equal the JAX oracle's."""
        svc = make_service(catalog, None)
        try:
            out = svc.recommend("Song 5", by_id=False, k=3)
            assert_same_recommendation(
                out, jax_service.recommend("Song 5", by_id=False, k=3))
            m = svc.metrics()
            assert m["backend"] == "certified"
            assert m["certificate_fallbacks"] == 0
        finally:
            svc.close()

    def test_approx_backend_serves(self, catalog):
        svc = make_service(catalog, RetrievalConfig(dtype="bfloat16"))
        try:
            assert svc.health()["backend"] == "approx"
            out = svc.recommend("Song 5", by_id=False, k=3)
            direct = Retriever(catalog, RetrievalConfig(dtype="bfloat16"), "cpu")
            assert [r["row"] for r in out["results"]] == [
                w.row for w in direct.recommend_by_name("Song 5", 3)]
            assert "certificate_fallbacks" not in svc.metrics()
        finally:
            svc.close()

    def test_retrieve_sends_unfilled_approx_slots_as_null(self, catalog):
        """k = 104 over the catalog's 100 rows leaves 4 approx slots of
        each query unfilled (the pad columns never enter the scan's bins,
        so an anti-aligned query fills the rest with real rows): POST
        /retrieve gives them as null in both lists, in a body a strict JSON
        parser takes, and the filled slots are a direct call's."""
        cfg = RetrievalConfig(dtype="bfloat16")
        srv = make_server(catalog, "127.0.0.1", 0, cfg, device="cpu")
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        q = -np.asarray(catalog.features[:2], np.float32)
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/retrieve"
            req = urllib.request.Request(
                url, json.dumps({"queries": q.tolist(), "k": 104}).encode(),
                {"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                body = r.read()
        finally:
            srv.shutdown()
            srv.server_service.close()
            srv.server_close()
            t.join(timeout=TIMEOUT)

        def reject(name):
            raise ValueError(f"not JSON: {name}")

        out = json.loads(body, parse_constant=reject)
        ws, wi = Retriever(catalog, cfg, "cpu").retrieve_host(q, k=104)
        assert len(catalog) == 100 and ((wi == -1).sum(axis=1) == 4).all()
        for rows, scores, w_rows, w_scores in zip(out["rows"], out["scores"],
                                                  wi, ws):
            assert [r is None for r in rows] == [s is None for s in scores]
            assert [r is None for r in rows] == list(w_rows == -1)
            filled = w_rows >= 0
            assert [r for r in rows if r is not None] == w_rows[filled].tolist()
            np.testing.assert_array_equal(
                np.asarray([s for s in scores if s is not None], np.float32),
                w_scores[filled])

    def test_retrieve_rejects_nonpositive_k(self, http_server):
        code, out = post(f"{http_server}/retrieve",
                         {"queries": [[0.5] * 12], "k": 0})
        assert code == 400 and "k must be positive" in out["error"]

    def test_serve_warms_up_and_closes(self, catalog, tmp_path, monkeypatch):
        """`serve` loads the catalog, warms up, serves until interrupted,
        then closes the coalescer and the socket."""
        p = tmp_path / "c.npz"
        catalog.save(str(p))
        seen = {}

        def interrupt(self, *a, **kw):
            seen["service"] = self.server_service
            raise KeyboardInterrupt

        monkeypatch.setattr(srv_mod.ThreadingHTTPServer, "serve_forever",
                            interrupt)
        assert srv_mod.serve(str(p), port=0, device="cpu") == 0
        svc = seen["service"]
        assert svc.coalescer.stats["batches"] == 0     # warmup bypasses it
        assert not svc.coalescer._thread.is_alive()
        assert svc.retriever.device.type == "cpu"

    def test_cli_serve_takes_the_global_device(self, monkeypatch):
        calls = []
        monkeypatch.setattr(srv_mod, "serve",
                            lambda *a, **kw: calls.append((a, kw)) or 0)
        rc = cli.main(["--device", "cpu", "serve", "--catalog", "c.npz",
                       "--host", "0.0.0.0", "--port", "9123"])
        assert rc == 0
        assert calls == [(("c.npz",), {"host": "0.0.0.0", "port": 9123,
                                       "device": "cpu",
                                       "record_spans": False})]
