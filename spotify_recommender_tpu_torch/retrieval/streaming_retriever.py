"""Host-streaming exact retrieval for catalogs beyond device memory.

The port of spotify_recommender_tpu/retrieval/streaming_retriever.py: the
feature rows stay on the host (ideally a memory-mapped catalog directory,
`Catalog.load_dir`, so they need not fit host RAM either) and pass through
the device in fixed-size windows, with the running top-k merged on the
device.  Per window, kernel 3 (`ops/fused_topk.prepare_and_call`,
exact=True) scores the rows with the reference's math and keeps the
window's top-k; ascending windows and `merge_topk` favouring the earlier
list keep the lowest index first on ties, so results equal the oracle's.

Double buffering, on a CUDA device: two pinned host buffers and two device
buffers alternate.  The host copies window i+1 from the (memory-mapped)
rows into its pinned buffer while the card uploads and scores window i.
The upload is a `non_blocking` copy on a side stream, the compute stream
waits on that copy's event before the kernel reads the rows, the copy
stream waits on the event of the kernel that last read a device buffer,
and the host waits on the event of the upload that last read a pinned
buffer before refilling it.  (A prefetch thread for the host copy, as the
JAX tier has, measured no faster on the H100's hosts: the copy itself is
the critical path.)  Rows are uploaded as they are, (W, F) row-major, and
the kernel reads them through a `.t()` view: no host transpose, no device
transpose.  Windows are not padded; the last one is just shorter.

Throughput is bound by the host side (the memmap copy and the per-window
launches) and the host-device link by construction: this is the capacity
tier, not the speed tier.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.fused_topk import (
    prepare_and_call,
    query_inputs,
)
from spotify_recommender_tpu_torch.ops.topk import merge_topk, topk_stable

log = get_logger(__name__)

NEG_INF = float("-inf")


def _window_merge(best_s, best_i, queries, rows, norms, offset, excl, k, eps):
    """The plain window step (`use_fused=False`): oracle scores of the
    window's rows, exclusion, top-k, merge."""
    scores = similarity.cosine_scores_batched(queries, rows, norms, eps)
    cols = offset + torch.arange(rows.shape[0], device=rows.device)
    scores = scores.masked_fill(cols[None, :] == excl[:, None], NEG_INF)
    w_s, w_pos = topk_stable(scores, min(k, rows.shape[0]))
    w_i = torch.where(w_s == NEG_INF, -1, w_pos + offset)
    return merge_topk(best_s, best_i, w_s, w_i, k)


def host_tensor(rows) -> torch.Tensor:
    """A CPU tensor over host rows without a copy.  Read-only memmaps are
    only read here, so torch's warning about non-writable arrays does not
    apply."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(rows, np.float32))


class StreamingRetriever:
    """Exact top-k over a host-resident (possibly memory-mapped) catalog.

    `features` may be any (N, F) array-like that slices into numpy rows;
    an np.memmap from `Catalog.load_dir` streams windows from the page
    cache to the device, so neither device memory nor host RAM bounds the
    catalog size.
    """

    def __init__(
        self,
        features,                       # (N, F) host array / memmap
        norms: Optional[np.ndarray],
        config: Optional[RetrievalConfig],
        device: torch.device,
        window: int = 1 << 20,          # rows per device slab (48 MB at F=12)
        use_fused: Optional[bool] = None,
        prefetch: bool = True,
    ) -> None:
        self.config = config or RetrievalConfig()
        self.device = torch.device(device)
        self.features = features
        n, f = features.shape
        self.num_items = n
        self.feature_dim = f
        self.window = max(1, min(window, n))
        # None: kernel 3 on every device (its plain version on the CPU)
        self.use_fused = True if use_fused is None else use_fused
        self.prefetch = prefetch
        if norms is None:
            # windowed norm computation: never materialize all rows
            norms = np.empty(n, np.float32)
            for s in range(0, n, self.window):
                e = min(s + self.window, n)
                norms[s:e] = np.linalg.norm(
                    np.asarray(features[s:e], np.float32), axis=1
                )
        self.norms = np.asarray(norms, np.float32)
        self._staging = None     # CUDA: pinned + device buffers, streams
        log.info("streaming retriever: %d items x %d dims, window %d rows",
                 n, f, self.window)

    # ------------------------------------------------------------ staging

    def _cuda_staging(self):
        if self._staging is None:
            w, f, dev = self.window, self.feature_dim, self.device
            nbuf = 2 if self.prefetch else 1
            self._staging = {
                "host": [torch.empty((w, f), pin_memory=True)
                         for _ in range(nbuf)],
                "host_n": [torch.empty((w,), pin_memory=True)
                           for _ in range(nbuf)],
                "dev": [torch.empty((w, f), device=dev) for _ in range(nbuf)],
                "dev_n": [torch.empty((w,), device=dev) for _ in range(nbuf)],
                # uploaded[j]: the copy into dev[j] (and out of host[j]) is
                # done; consumed[j]: the kernel that read dev[j] is done
                "uploaded": [None] * nbuf,
                "consumed": [None] * nbuf,
                "copy_stream": (torch.cuda.Stream(device=dev)
                                if self.prefetch else None),
            }
        return self._staging

    def _stage(self, j: int, s: int, e: int) -> None:
        """Host side of window [s, e): once the upload that last read
        pinned buffer j is done, copy the rows and norms out of the
        (memory-mapped) catalog into it (torch's copy runs on the
        intra-op threads)."""
        st = self._staging
        if st["uploaded"][j] is not None:
            st["uploaded"][j].synchronize()
        st["host"][j][:e - s].copy_(host_tensor(self.features[s:e]))
        st["host_n"][j][:e - s].copy_(host_tensor(self.norms[s:e]))

    def _upload(self, j: int, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Start the upload of staged buffer j into device buffer j;
        returns the device views, ready on the current stream."""
        st = self._staging
        compute = torch.cuda.current_stream(self.device)
        copy = st["copy_stream"] or compute
        with torch.cuda.stream(copy):
            if st["consumed"][j] is not None:
                copy.wait_event(st["consumed"][j])   # dev[j] is free
            rows = st["dev"][j][:m]
            nrm = st["dev_n"][j][:m]
            rows.copy_(st["host"][j][:m], non_blocking=True)
            nrm.copy_(st["host_n"][j][:m], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy)
        st["uploaded"][j] = ev
        compute.wait_event(ev)
        if copy is not compute:
            # written on the copy stream: the allocator must not hand the
            # buffers out again before that stream is done with them
            st["dev"][j].record_stream(copy)
            st["dev_n"][j].record_stream(copy)
        return rows, nrm

    def _windows(self):
        """(start, end, rows, norms) of each window in ascending order, the
        tensors on the retriever's device.  On a CUDA device the host
        copy of window i+1 runs while the card works on window i: the
        caller must have queued its work on a window before it asks for
        the next."""
        spans = [(s, min(s + self.window, self.num_items))
                 for s in range(0, self.num_items, self.window)]
        if self.device.type != "cuda":
            for s, e in spans:
                yield (s, e, host_tensor(self.features[s:e]),
                       host_tensor(self.norms[s:e]))
            return
        st = self._cuda_staging()
        nbuf = len(st["dev"])
        for i, (s, e) in enumerate(spans):
            j = i % nbuf
            self._stage(j, s, e)
            rows, nrm = self._upload(j, e - s)
            yield s, e, rows, nrm
            # the caller's kernel on dev[j] is queued: mark its end
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            st["consumed"][j] = ev

    # ------------------------------------------------------------- query

    def __call__(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F) queries -> (scores (B, k) fp32, rows (B, k) int64) on the
        retriever's device; exclusions are global rows (-1 = none)."""
        q, excl = query_inputs(queries, exclude_rows, self.device,
                               self.feature_dim)
        b = q.shape[0]
        eps = self.config.eps
        best_s = torch.full((b, k), NEG_INF, device=self.device)
        best_i = torch.full((b, k), -1, dtype=torch.int64, device=self.device)
        for s, e, rows, nrm in self._windows():
            if self.use_fused:
                # the kernel sees window-local columns
                local = torch.where((excl >= s) & (excl < e), excl - s, -1)
                w_s, w_i = prepare_and_call(
                    q, local, rows.t(), nrm, e - s, k=k, eps=eps, exact=True,
                )
                # keep the -1 sentinel of unfilled slots: a window with
                # fewer than k rows must not add index s - 1 to the merge
                w_i = torch.where(w_i < 0, -1, w_i + s)
                best_s, best_i = merge_topk(best_s, best_i, w_s, w_i, k)
            else:
                best_s, best_i = _window_merge(
                    best_s, best_i, q, rows, nrm, s, excl, k, eps)
        return best_s, best_i

    def retrieve(self, queries, k: Optional[int] = None, exclude_rows=None):
        """`Retriever.retrieve`'s signature: top-k as device tensors."""
        k = self.config.top_k if k is None else k
        return self(queries, k, exclude_rows)
