"""HTTP retrieval service: the port of spotify_recommender_tpu/serve/server.py.

The reference is batch-CLI only (one process per query, reloading the
catalog and re-initializing the device every time, reference
main.cpp:46-63).  This service keeps one Retriever on the device and
serves queries over HTTP with no per-request setup:

  GET  /healthz                          → {"status": "ok", ...}
  GET  /metrics                          → counters, latency percentiles
                                           (and span totals, `spans`, when
                                           the service records them)
  GET  /recommend?song=<name>&n=10       → ranked results by name
  GET  /recommend?id=<track_id>&n=10     → ranked results by track id
  GET  /song/<row>                       → one catalog entry
  POST /retrieve {"queries": [[...]], "k": 10}
                                         → batched raw-vector retrieval
  POST /reload {"catalog": "path.npz"}   → hot-swap the catalog

Routes, status codes and JSON keys are the JAX service's; two additions:
`/retrieve` answers 400 for k <= 0, as `/recommend` does for n, and gives
a slot the approx tier left unfilled as null in "rows" and "scores".

Concurrency: requests call the retriever with no lock.  Each call builds
its own tensors; on a card every kernel launches on the calling thread's
current stream, which is the device's default stream for every thread
here, so the card runs each call's work in its order; the certified
tier's counters take their own lock.  `tests/test_torch_serve.py` holds
16 concurrent callers' answers to serial calls.  Single-query /recommend
traffic also flows through a micro-batch coalescer: concurrent requests
arriving within a short window are stacked into one batch (the kernels
are batch-optimized; B = 1 calls waste them), then sliced back per
request.  The batch is not padded: the JAX service pads to a power of two
so that XLA compiles few shapes, and the CUDA kernels compile no shape.

stdlib http.server (threaded) keeps the service free of a framework.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.core.timing import Spans, span
from spotify_recommender_tpu_torch.data.catalog import load_catalog
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

log = get_logger(__name__)

# POST bodies larger than this are rejected with 413 (a (B, F) query
# payload at the default cap is ~64 MB of JSON, far beyond any sane batch).
MAX_BODY_BYTES = 64 * 1024 * 1024


class ServiceOverloaded(RuntimeError):
    """Raised by the coalescer when its pending queue is full; mapped to
    HTTP 429 so clients shed load early instead of queueing toward the
    submit timeout."""


class BatchCoalescer:
    """Stacks concurrent single-query retrievals into one batch.

    Callers block in `submit` until the dispatcher thread has run their
    batch; the dispatcher waits `window_ms` after the first enqueue so
    concurrent requests coalesce, then dispatches up to `max_batch` at
    once.  Per-request k values are served from one top-max(k) retrieval.

    With a span recorder (`spans`), each dispatch records, under one batch
    id: "serve.window" (the coalescing sleep), "serve.queue" per request
    (from its enqueue to the dispatcher taking it up), "serve.gather" (the
    stack of the batch), "serve.batch" (the retrieval, under which the
    retriever's own spans nest) and "serve.deliver" (the slots set).
    """

    def __init__(
        self,
        retrieve_fn,             # (queries (B,F), k, exclude (B,)) -> (s, r)
        max_batch: int = 256,
        window_ms: float = 2.0,
        max_queue: int = 2048,
        spans: Optional[Spans] = None,
    ) -> None:
        self._retrieve = retrieve_fn
        self.spans = spans
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        # backpressure: a burst past device throughput is shed with 429s
        # at enqueue time, not discovered through the submit timeout
        self.max_queue = max_queue
        self._cv = threading.Condition()
        self._pending: list = []
        self._stop = False
        self.stats = {
            "batches": 0, "batched_requests": 0, "max_batch_size": 0,
            "rejected": 0,
        }
        self._thread = threading.Thread(
            target=self._run, name="batch-coalescer", daemon=True
        )
        self._thread.start()

    def submit(
        self, query: np.ndarray, exclude_row: int, k: int,
        timeout_s: float = 300.0,
    ):
        """Enqueue one query; blocks until its batch has run.
        Returns (scores (k,), rows (k,)) or raises the batch's error.
        A wedged device raises TimeoutError instead of hanging the HTTP
        worker thread forever."""
        slot: dict = {}
        ev = threading.Event()
        with self._cv:
            if self._stop:
                raise RuntimeError("coalescer closed")
            if len(self._pending) >= self.max_queue:
                self.stats["rejected"] += 1
                raise ServiceOverloaded(
                    f"pending queue full ({self.max_queue} requests)"
                )
            self._pending.append((query, exclude_row, k, slot, ev,
                                  time.perf_counter_ns()))
            self._cv.notify()
        if not ev.wait(timeout=timeout_s):
            raise TimeoutError(
                f"retrieval batch did not complete within {timeout_s}s"
            )
        if "error" in slot:
            raise slot["error"]
        return slot["scores"], slot["rows"]

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
            sp = self.spans
            bid = None if sp is None else sp.new_batch()
            # coalescing window: let concurrent requests pile up
            with span(sp, "serve.window", True, bid):
                if self.window_s > 0:
                    time.sleep(self.window_s)
            with self._cv:
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
            if not batch:
                continue
            if sp is not None:
                taken = time.perf_counter_ns()
                for e in batch:
                    sp.record("serve.queue", e[5], taken, batch=bid)
            with span(sp, "serve.gather", True, bid):
                queries = np.stack([np.asarray(e[0], np.float32)
                                    for e in batch])
                excl = np.asarray([e[1] for e in batch], np.int64)
                kmax = max(e[2] for e in batch)
            try:
                with span(sp, "serve.batch", batch=bid):
                    scores, rows = self._retrieve(queries, kmax, excl)
                with span(sp, "serve.deliver", True, bid):
                    for i, (_, _, k, slot, ev, _) in enumerate(batch):
                        slot["scores"] = scores[i, :k]
                        slot["rows"] = rows[i, :k]
                        ev.set()
            except Exception as e:  # deliver the failure to every waiter
                log.exception("coalesced batch of %d failed", len(batch))
                for _, _, _, slot, ev, _ in batch:
                    slot["error"] = e
                    ev.set()
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(batch)
            self.stats["max_batch_size"] = max(
                self.stats["max_batch_size"], len(batch)
            )

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


class RecommenderService:
    """Catalog + retriever + coalescer: the request-handling core, apart
    from HTTP for testability.  Retrieval runs on `device` (the card
    unless the caller names the CPU).  The lock guards only the stats and
    catalog swaps, not the retriever (see the module docstring).

    `record_spans=True` gives the coalescer and the retriever (a reloaded
    one too) one span recorder, `spans` (core/timing.Spans), and
    `/metrics` its totals; off by default."""

    def __init__(
        self,
        catalog,
        config: Optional[RetrievalConfig] = None,
        coalesce_window_ms: float = 2.0,
        max_batch: int = 256,
        max_queue: int = 2048,
        device: Union[str, torch.device] = "cuda",
        record_spans: bool = False,
    ):
        self._config = config
        self._device = device
        self.retriever = Retriever(catalog, config, device)
        self.spans: Optional[Spans] = (
            self.retriever.record_spans() if record_spans else None)
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "errors": 0, "total_latency_s": 0.0}
        # bounded latency ring for p50/p99 (last 8192 requests)
        self._lat_ring = np.zeros(8192, np.float64)
        self._lat_n = 0
        self.coalescer = BatchCoalescer(
            self._retrieve_batch,
            max_batch=max_batch,
            window_ms=coalesce_window_ms,
            max_queue=max_queue,
            spans=self.spans,
        )

    def warmup(self, k: int = 10, max_batch: Optional[int] = None) -> float:
        """Run the coalescer's batch sizes 8, 16, ... up to its cap before
        traffic lands.  The first call builds the kernel library if this
        checkout has not built it yet (nvcc, tens of seconds), which the
        first unlucky requests would otherwise pay; serve() calls this at
        startup.  Returns seconds spent."""
        t0 = time.perf_counter()
        feats = self.retriever.catalog.features
        cap = min(max_batch or self.coalescer.max_batch, 256)
        b = 8
        while True:
            q = np.asarray(feats[:1], np.float32).repeat(min(b, cap), axis=0)
            self.retriever.retrieve_host(
                q, k=k, exclude_rows=np.full(len(q), -1, np.int64)
            )
            if b >= cap:
                break
            b *= 2
        dt = time.perf_counter() - t0
        log.info("serve warmup: batches up to %d run in %.1fs", cap, dt)
        return dt

    def _retrieve_batch(self, queries, k, exclude_rows):
        # the retriever reference is re-read per call → hot reload swaps in
        return self.retriever.retrieve_host(
            queries, k=k, exclude_rows=exclude_rows
        )

    def _record(self, t0: float, ok: bool) -> None:
        dt = time.perf_counter() - t0
        with self._lock:
            self._stats["requests"] += 1
            if not ok:
                self._stats["errors"] += 1
            self._stats["total_latency_s"] += dt
            self._lat_ring[self._lat_n % len(self._lat_ring)] = dt
            self._lat_n += 1

    def reset_latency_stats(self) -> None:
        """Drop recorded latencies/counters (e.g. after a warm-up round,
        so percentiles describe only the measured traffic)."""
        with self._lock:
            self._stats = {
                "requests": 0, "errors": 0, "total_latency_s": 0.0
            }
            self._lat_n = 0

    def latency_percentiles(self) -> dict:
        """p50/p95/p99 over the last <=8192 recorded request latencies."""
        with self._lock:
            n = min(self._lat_n, len(self._lat_ring))
            if n == 0:
                return {}
            window = self._lat_ring[:n].copy()
        p50, p95, p99 = np.percentile(window, [50, 95, 99])
        return {
            "p50_latency_ms": round(1e3 * float(p50), 3),
            "p95_latency_ms": round(1e3 * float(p95), 3),
            "p99_latency_ms": round(1e3 * float(p99), 3),
        }

    def metrics(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        n = max(1, s["requests"])
        retriever = self.retriever
        out = {
            "requests": s["requests"],
            "errors": s["errors"],
            "mean_latency_ms": round(1e3 * s["total_latency_s"] / n, 3),
            **self.latency_percentiles(),
            "num_items": len(retriever.catalog),
            "backend": retriever.backend,
            "coalescer": dict(self.coalescer.stats),
        }
        if retriever.certified is not None:
            # certified tier observability: how many queries needed the
            # oracle fallback (provably-ambiguous near-ties)
            out["certificate_fallbacks"] = retriever.certified.fallbacks
        if self.spans is not None:
            out["spans"] = {
                name: {"count": t["count"], "ms": round(1e3 * t["s"], 3),
                       "self_ms": round(1e3 * t["self_s"], 3)}
                for name, t in self.spans.totals().items()
            }
        return out

    def recommend(self, query: str, by_id: bool, k: int) -> dict:
        t0 = time.perf_counter()
        retriever = self.retriever
        try:
            if by_id:
                row = retriever.index.find_by_track_id(query)
                if row is None:
                    raise KeyError(f"Song with track_id '{query}' not found")
            else:
                row = retriever.index.find_by_name(query)
                if row is None:
                    raise KeyError(f"Song with name '{query}' not found")
            kk = min(k, len(retriever.catalog) - 1)
            scores, rows = self.coalescer.submit(
                np.asarray(retriever.catalog.features[row], np.float32),
                row,
                kk,
            )
            recs = retriever._materialize(rows, scores)
        except ServiceOverloaded as e:
            self._record(t0, ok=False)
            return {"error": str(e), "status": 429}
        except (KeyError, IndexError) as e:
            self._record(t0, ok=False)
            return {"error": e.args[0] if e.args else str(e), "status": 404}
        self._record(t0, ok=True)
        return {
            "query": dataclasses.asdict(retriever.lookup(row)),
            "results": [dataclasses.asdict(r) for r in recs],
            "status": 200,
        }

    def song(self, row: int) -> dict:
        if row < 0 or row >= len(self.retriever.catalog):
            return {"error": f"row {row} out of range", "status": 404}
        return {"song": dataclasses.asdict(self.retriever.lookup(row)), "status": 200}

    def retrieve(self, queries, k: int) -> dict:
        t0 = time.perf_counter()
        retriever = self.retriever
        q = np.asarray(queries, np.float32)
        f = retriever.catalog.features.shape[1]
        if q.ndim != 2 or q.shape[1] != f:
            self._record(t0, ok=False)
            return {"error": f"queries must be (B, {f})", "status": 400}
        if k <= 0:
            self._record(t0, ok=False)
            return {"error": "k must be positive", "status": 400}
        # batched traffic calls the retriever directly (no lock, see the
        # module docstring)
        scores, rows = retriever.retrieve_host(q, k=k)
        self._record(t0, ok=True)
        # a slot the approx tier could not fill (row -1, score -inf) goes
        # out as null in both lists: -Infinity is not JSON
        filled = rows >= 0
        return {
            "scores": [[float(s) if f else None for s, f in zip(rs, fs)]
                       for rs, fs in zip(scores, filled)],
            "rows": [[int(r) if f else None for r, f in zip(rr, fs)]
                     for rr, fs in zip(rows, filled)],
            "status": 200,
        }

    def reload(self, catalog_path: str) -> dict:
        """Hot-swap the catalog: build the new retriever off to the side,
        then atomically replace the reference (in-flight requests finish
        on the old one)."""
        try:
            cat = load_catalog(catalog_path)
            new_retriever = Retriever(cat, self._config, self._device)
        except Exception as e:
            return {"error": f"reload failed: {e}", "status": 400}
        if self.spans is not None:
            new_retriever.record_spans(self.spans)
        with self._lock:
            self.retriever = new_retriever
        log.info("catalog hot-reloaded: %s (%d items)", catalog_path, len(cat))
        return {
            "status": 200,
            "reloaded": catalog_path,
            "num_items": len(cat),
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "num_items": len(self.retriever.catalog),
            "backend": self.retriever.backend,
        }

    def close(self) -> None:
        self.coalescer.close()


def _make_handler(service: RecommenderService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, payload: dict) -> None:
            code = payload.get("status", 200)
            if isinstance(code, int):
                payload.pop("status", None)
            else:
                code = 200  # payload-level status strings (e.g. healthz "ok")
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            try:
                if url.path == "/healthz":
                    self._send(self.server_service.health())
                elif url.path == "/metrics":
                    self._send(self.server_service.metrics())
                elif url.path == "/recommend":
                    try:
                        k = int(qs.get("n", ["10"])[0])
                    except ValueError:
                        self._send({"error": "n must be an integer", "status": 400})
                        return
                    if k <= 0:
                        self._send({"error": "n must be positive", "status": 400})
                    elif "id" in qs:
                        self._send(
                            self.server_service.recommend(qs["id"][0], True, k)
                        )
                    elif "song" in qs:
                        self._send(
                            self.server_service.recommend(qs["song"][0], False, k)
                        )
                    else:
                        self._send({"error": "need ?song= or ?id=", "status": 400})
                elif url.path.startswith("/song/"):
                    try:
                        row = int(url.path[6:])
                    except ValueError:
                        self._send(
                            {"error": "song row must be an integer", "status": 400}
                        )
                        return
                    self._send(self.server_service.song(row))
                else:
                    self._send({"error": "not found", "status": 404})
            except Exception as e:  # the handler thread must answer
                log.exception("GET %s failed", self.path)
                self._send({"error": str(e), "status": 500})

        def do_POST(self) -> None:  # noqa: N802
            url = urlparse(self.path)
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._send(
                        {"error": f"body exceeds {MAX_BODY_BYTES} bytes",
                         "status": 413}
                    )
                    return
                body = json.loads(self.rfile.read(n) or b"{}")
                if url.path == "/retrieve":
                    self._send(
                        self.server_service.retrieve(
                            body.get("queries", []), int(body.get("k", 10))
                        )
                    )
                elif url.path == "/reload":
                    path = body.get("catalog")
                    if not path:
                        self._send(
                            {"error": "need {'catalog': path}", "status": 400}
                        )
                    else:
                        self._send(self.server_service.reload(str(path)))
                else:
                    self._send({"error": "not found", "status": 404})
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._send({"error": f"bad request: {e}", "status": 400})

        def log_message(self, fmt, *args):  # route to our logger
            log.info("http %s", fmt % args)

    return Handler


def make_server(
    catalog, host: str = "127.0.0.1", port: int = 8000,
    config: Optional[RetrievalConfig] = None,
    coalesce_window_ms: float = 2.0,
    device: Union[str, torch.device] = "cuda",
    record_spans: bool = False,
) -> ThreadingHTTPServer:
    service = RecommenderService(
        catalog, config, coalesce_window_ms=coalesce_window_ms, device=device,
        record_spans=record_spans,
    )
    handler = _make_handler(service)
    srv = ThreadingHTTPServer((host, port), handler)
    srv.server_service = service  # type: ignore[attr-defined]
    handler.server_service = service  # type: ignore[attr-defined]
    return srv


def serve(
    catalog_path: str, host: str = "127.0.0.1", port: int = 8000,
    device: Union[str, torch.device] = "cuda",
    record_spans: bool = False,
) -> int:
    cat = load_catalog(catalog_path)
    srv = make_server(cat, host, port, device=device,
                      record_spans=record_spans)
    try:
        dt = srv.server_service.warmup()  # type: ignore[attr-defined]
        log.info("serving %d items on http://%s:%d (warmup %.1f s)",
                 len(cat), host, srv.server_address[1], dt)
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_service.close()  # type: ignore[attr-defined]
        srv.server_close()
    return 0
