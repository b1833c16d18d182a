"""spotify_recommender_tpu_torch — the PyTorch and CUDA port of
spotify_recommender_tpu.

The JAX package beside it is the reference this port is held against.
This package imports torch and numpy, never jax.  Its certified exact
retrieval path runs two hand-written CUDA kernels for Hopper (sm_90a)
on a CUDA device, and their plain torch versions on the CPU.

Layer map:

- ``core``      — config dataclasses, device resolution, logging
- ``data``      — feature schema, CSV ingest, normalization, catalog artifact
- ``ops``       — torch oracle, top-k merges, the certified tier
    ``cuda``    — kernel wrappers and the nvcc build (sources in ``csrc/``)
- ``retrieval`` — catalog index (id/name), Retriever API
- ``cli``       — reference-style flags, `preprocess`, `recommend`
"""

from spotify_recommender_tpu_torch.version import __version__

__all__ = [
    "__version__",
    "Catalog",
    "Retriever",
    "RetrievalConfig",
    "preprocess_csv",
]


def __getattr__(name):
    # lazy re-exports keep `import spotify_recommender_tpu_torch` cheap
    if name in ("Catalog", "preprocess_csv"):
        from spotify_recommender_tpu_torch.data import catalog

        return getattr(catalog, name)
    if name == "Retriever":
        from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

        return Retriever
    if name == "RetrievalConfig":
        from spotify_recommender_tpu_torch.core.config import RetrievalConfig

        return RetrievalConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
