"""Catalog index, the Retriever API and the streaming capacity tier."""

from spotify_recommender_tpu_torch.retrieval.streaming_retriever import (
    StreamingRetriever,
)

__all__ = ["StreamingRetriever"]
