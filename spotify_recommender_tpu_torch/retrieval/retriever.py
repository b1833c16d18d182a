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

Two backends, chosen from the config and the device the caller passes:

- "certified" (default): the certified exact tier
  (ops/fused_topk.CertifiedRetriever).  On a CUDA device it launches the
  hand-written kernels; on the CPU it runs their plain torch versions.
- "oracle" (`RetrievalConfig(use_pallas=False)`): the plain exact oracle.

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
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.fused_topk import CertifiedRetriever
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
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (sharded catalog) is not ported yet "
                "(ROADMAP queue 1, multi-GPU)"
            )
        if config.dtype != "float32" or not config.exact_scores:
            raise NotImplementedError(
                f"dtype={config.dtype!r}, exact_scores={config.exact_scores}: "
                "only the exact fp32 tiers are ported (the approx tier and "
                "the fused kernel are ROADMAP queue 1 items 7 and 13)"
            )
        self.catalog = catalog
        self.config = config
        self.device = resolve_device(device)
        self.index = CatalogIndex(catalog.track_ids, catalog.track_names)
        similarity.disable_tf32()
        # the certified tier, or None on the oracle backend
        self.certified: Optional[CertifiedRetriever] = None
        if config.use_pallas:
            self._backend = "certified"
            self.certified = CertifiedRetriever(
                catalog.features, catalog.norms, config, self.device
            )
        else:
            self._backend = "oracle"
            self._features = torch.from_numpy(catalog.features).to(self.device)
            self._norms = torch.from_numpy(
                np.asarray(catalog.norms, np.float32)
            ).to(self.device)
        log.info(
            "retriever ready: %d items, backend=%s, device=%s",
            len(catalog), self._backend, self.device,
        )

    @property
    def backend(self) -> str:
        return self._backend

    def retrieve(
        self,
        queries,
        k: Optional[int] = None,
        exclude_rows=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched exact top-k: queries (B, F) → (scores (B, k), rows (B, k))
        as tensors on the retriever's device.

        `exclude_rows` masks one catalog row per query (self-exclusion);
        -1 disables masking for that query.
        """
        k = self.config.top_k if k is None else k
        if self._backend == "certified":
            return self.certified(queries, k, exclude_rows)
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
        s, i = self.retrieve(queries, k=k, exclude_rows=exclude_rows)
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
        cat = self.catalog
        out = []
        for r, s in zip(rows, scores):
            r = int(r)
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
