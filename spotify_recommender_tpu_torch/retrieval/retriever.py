"""Retriever: the public retrieval API.

Equivalent of the reference's `Recommender` class
(reference Recommender.h:28-130) and of the JAX package's Retriever:

- constructing a Retriever from a Catalog puts features and norms on the
  caller's device once (the reference's one-time H2D copy,
  Recommender.cu:162-170);
- `recommend_by_id / recommend_by_name / recommend_by_index`
  (reference Recommender.cu:356-372, :275-318) return ranked
  `Recommendation` records;
- `retrieve()` is batched many-query retrieval.

Four backends, chosen from the config as the JAX package chooses them
(its `_select_backend`); the device is the caller's.  The kernel tiers
launch the hand-written kernels on a CUDA device and run their plain torch
versions on the CPU.

- "certified" (default): the certified exact tier
  (ops/fused_topk.CertifiedRetriever), with the v3 bin scan or, under
  `RetrievalConfig(scan="v2")`, the v2 scan.
- "approx" (a `dtype` that starts with "bfloat16"): the v3 bin scan alone,
  no rerank (ops/fused_topk.ApproxRetriever); scores within BF16X2_EPS,
  recall below 1, and a slot it cannot fill is row -1.
- "pallas" (`RetrievalConfig(exact_scores=False)`): the fused score +
  top-k kernel over prenormalized fp32 rows (ops/fused_topk.FusedRetriever),
  the JAX package's backend of the same name.
- "oracle" (`RetrievalConfig(use_pallas=False)`): the plain exact oracle.
- "sharded" (a `mesh` whose "catalog" axis is > 1, core/mesh.py): the
  catalog row-sharded over the mesh (parallel/sharding.ShardedCatalog), as
  the JAX Retriever builds it: the certified tier per shard where the
  config is the exact fp32 one on CUDA devices (the JAX package's "on a
  TPU"), kernel 3 per shard for the other configs on CUDA, the oracle per
  shard on the CPU or under `use_pallas=False`.

There is no silent fallback: a CUDA device without a card, a missing
nvcc or a failed kernel raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.core.timing import Spans, span
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.fused_topk import (
    ApproxRetriever,
    CertifiedRetriever,
    FusedRetriever,
)
from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog
from spotify_recommender_tpu_torch.retrieval.index import CatalogIndex

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class Recommendation:
    """One ranked result (reference Recommender.h:12-22 + display fields
    main.cpp:117-122)."""

    row: int
    score: float
    track_id: str
    track_name: str
    artists: str
    genre: str


class Retriever:
    def __init__(
        self,
        catalog: Catalog,
        config: Optional[RetrievalConfig],
        device: torch.device,
        mesh=None,
    ) -> None:
        if len(catalog) == 0:
            raise ValueError("Empty song database")
        config = config or RetrievalConfig()
        self.catalog = catalog
        self.config = config
        self.device = resolve_device(device)
        self.index = CatalogIndex(catalog.track_ids, catalog.track_names)
        similarity.disable_tf32()
        # the certified tier, or None on the other backends
        self.certified: Optional[CertifiedRetriever] = None
        # the fused kernel's retriever on the "pallas" backend
        self.fused: Optional[FusedRetriever] = None
        # the bin scan alone on the "approx" backend
        self.approx: Optional[ApproxRetriever] = None
        # the row-sharded catalog on the "sharded" backend
        self.sharded: Optional[ShardedCatalog] = None
        if mesh is not None and mesh.shape.get("catalog", 1) > 1:
            self._backend = "sharded"
            on_cuda = mesh.devices.flat[0].type == "cuda"
            self.sharded = ShardedCatalog(
                catalog.features, catalog.norms, mesh,
                use_certified=(config.use_pallas and on_cuda
                               and config.exact_scores
                               and config.dtype == "float32"),
                use_pallas=config.use_pallas and on_cuda, config=config,
            )
        elif config.use_pallas and config.dtype.startswith("bfloat16"):
            self._backend = "approx"
            self.approx = ApproxRetriever(
                catalog.features, catalog.norms, config, self.device
            )
        elif (config.use_pallas and config.exact_scores
              and config.dtype == "float32"):
            self._backend = "certified"
            self.certified = CertifiedRetriever(
                catalog.features, catalog.norms, config, self.device
            )
        elif config.use_pallas:
            self._backend = "pallas"
            self.fused = FusedRetriever(
                catalog.features, catalog.norms, config, self.device
            )
        else:
            self._backend = "oracle"
            self._features = torch.from_numpy(catalog.features).to(self.device)
            self._norms = torch.from_numpy(
                np.asarray(catalog.norms, np.float32)
            ).to(self.device)
        # the span recorder, None while recording is off (`record_spans`)
        self.spans: Optional[Spans] = None
        log.info(
            "retriever ready: %d items, backend=%s, device=%s, mesh=%s",
            len(catalog), self._backend, self.device,
            mesh.shape if mesh is not None else None,
        )

    @property
    def backend(self) -> str:
        return self._backend

    def record_spans(self, spans: Optional[Spans] = None) -> Spans:
        """Turn span recording on (idempotent) and return the recorder,
        which `spans` then holds: `spans` if given (a service shares one
        with its coalescer), else the one already on, else a new
        `core/timing.Spans`.  Each batch is then an "entry.batch" span (the
        root, unless the caller's span is open on this thread), with the
        certified tier's phases (`CertifiedRetriever.finish`) and, in
        `retrieve_host`, "entry.to_host" (the answers' copies to the host
        and the wait for the device's queued work) under it."""
        if spans is None:
            spans = self.spans or Spans()
        self.spans = spans
        if self.certified is not None:
            self.certified.spans = spans
        return spans

    def retrieve(
        self,
        queries,
        k: Optional[int] = None,
        exclude_rows=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k: queries (B, F) → (scores (B, k), rows (B, k)) as
        tensors on the retriever's device (exact but on the "approx"
        backend, where an unfilled slot is (-inf, -1)).

        `exclude_rows` masks one catalog row per query (self-exclusion);
        -1 disables masking for that query.
        """
        with span(self.spans, "entry.batch"):
            return self._retrieve(queries, k, exclude_rows)

    def _retrieve(self, queries, k, exclude_rows):
        k = self.config.top_k if k is None else k
        if self._backend == "sharded":
            return self.sharded.retrieve(queries, k, exclude_rows)
        if self._backend == "certified":
            return self.certified(queries, k, exclude_rows)
        if self._backend == "approx":
            return self.approx(queries, k, exclude_rows)
        if self._backend == "pallas":
            return self.fused(queries, k, exclude_rows)
        queries = torch.atleast_2d(
            torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        )
        if exclude_rows is not None:
            exclude_rows = torch.as_tensor(exclude_rows, device=self.device)
        return similarity.exact_topk_chunked(
            queries, self._features, self._norms,
            exclude_rows=exclude_rows, k=k, eps=self.config.eps,
        )

    def retrieve_host(
        self, queries, k: Optional[int] = None, exclude_rows=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`retrieve` with the results on the host as numpy arrays."""
        sp = self.spans
        with span(sp, "entry.batch"):
            s, i = self._retrieve(queries, k, exclude_rows)
            with span(sp, "entry.to_host", phase=True):
                return s.cpu().numpy(), i.cpu().numpy()

    # ----------------------------------------------------- reference API

    def recommend_by_index(
        self, row: int, k: Optional[int] = None
    ) -> List[Recommendation]:
        """Top-k similar items to catalog row `row`, excluding itself
        (reference Recommender.cu:275-318)."""
        k = self.config.top_k if k is None else k
        if row < 0 or row >= len(self.catalog):
            raise IndexError(f"Invalid song index: {row}")
        k = min(k, len(self.catalog) - 1)
        scores, rows = self.retrieve_host(
            self.catalog.features[row][None, :], k=k,
            exclude_rows=np.asarray([row]),
        )
        return self._materialize(rows[0], scores[0])

    def recommend_by_id(
        self, track_id: str, k: Optional[int] = None
    ) -> List[Recommendation]:
        row = self.index.find_by_track_id(track_id)
        if row is None:
            raise KeyError(f"Song with track_id '{track_id}' not found")
        return self.recommend_by_index(row, k)

    def recommend_by_name(
        self, name: str, k: Optional[int] = None
    ) -> List[Recommendation]:
        row = self.index.find_by_name(name)
        if row is None:
            raise KeyError(f"Song with name '{name}' not found")
        return self.recommend_by_index(row, k)

    def lookup(self, row: int) -> Recommendation:
        """Describe one catalog row (the reference's query-song display,
        main.cpp:104-112)."""
        return self._materialize([row], [1.0])[0]

    def _materialize(
        self, rows: Sequence[int], scores: Sequence[float]
    ) -> List[Recommendation]:
        """Records of the rows in order; a -1 row (a slot the approx tier
        could not fill) is dropped, not read as the last song."""
        cat = self.catalog
        out = []
        for r, s in zip(rows, scores):
            r = int(r)
            if r < 0:
                continue
            out.append(
                Recommendation(
                    row=r,
                    score=float(s),
                    track_id=str(cat.track_ids[r]),
                    track_name=str(cat.track_names[r]),
                    artists=str(cat.artists[r]),
                    genre=cat.genre_of(r),
                )
            )
        return out
