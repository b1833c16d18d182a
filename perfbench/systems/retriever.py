"""The system under test for retrieval cells: the port's `Retriever` over a
`Catalog` of the configuration's rows, on its default certified tier with
the configuration's `RetrievalConfig`, answering host arrays through
`retrieve_host`, the path the batch endpoint takes."""

from __future__ import annotations

import numpy as np
import torch


def build(config: dict, features: np.ndarray, device: torch.device):
    """A Retriever over `features` (N, F) float32 on the host."""
    from spotify_recommender_tpu_torch.core.config import RetrievalConfig
    from spotify_recommender_tpu_torch.data.catalog import Catalog
    from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

    n, f = features.shape
    ids = np.arange(n).astype(str)
    catalog = Catalog(
        features=features, norms=None, track_ids=ids, track_names=ids,
        artists=ids, genre_ids=np.zeros(n, np.int32), genre_names=["genre"],
        min_vals=np.zeros(f - 1, np.float32),
        max_vals=np.ones(f - 1, np.float32),
    )
    return Retriever(catalog, RetrievalConfig(**config["retrieval"]), device)


def call(system, queries: np.ndarray, exclude: np.ndarray, k: int):
    """One batch: (scores (B, k), rows (B, k)) as host arrays."""
    return system.retrieve_host(queries, k=k, exclude_rows=exclude)
