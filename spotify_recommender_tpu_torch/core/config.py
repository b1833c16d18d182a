"""Typed configuration for the retrieval and training paths.

The reference exposes its knobs as hardcoded constants and argv flags
(reference main.cpp:144-180, Song.h:12, DataManager.cpp:168,292,
Recommender.cu:68,232).  Here every knob is an explicit dataclass field so the
CLI, tests, and library callers share one source of truth.

The fields are those of the JAX package's `core/config.py`, so one config
drives both packages.  TPU tile knobs (`query_tile`, `catalog_tile`,
`split_planes`) stay as fields; the port reads only those that apply to it
(see `ops/fused_topk.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# The 12-feature contract of the reference data model (reference Song.h:12-19):
# 11 numeric audio features + ordinally-encoded genre as feature[11]
# (reference DataManager.cpp:299).
FEATURE_COUNT = 12

# Numeric guards lifted from the reference math (cited per field below).
COSINE_EPS = 1e-8          # zero-norm guard   (reference Recommender.cu:68)
MINMAX_RANGE_FLOOR = 1e-4  # constant-feature floor (reference DataManager.cpp:292)
CONSTANT_FEATURE_VALUE = 0.5  # value for constant features (DataManager.cpp:295)


@dataclasses.dataclass(frozen=True)
class CatalogConfig:
    """Catalog artifact + preprocessing knobs.

    Mirrors the reference preprocessing contract
    (reference DataManager.cpp:94-361).
    """

    feature_count: int = FEATURE_COUNT
    range_floor: float = MINMAX_RANGE_FLOOR
    constant_feature_value: float = CONSTANT_FEATURE_VALUE
    # dtype of the device-resident feature matrix. fp32 preserves exact parity
    # with the reference math; bf16 halves HBM traffic for large catalogs.
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (core/mesh.make_mesh).

    axis "data"    — data parallelism over the query batch
    axis "catalog" — catalog rows sharded over devices (row-sharded items)
    """

    data: int = 1
    catalog: int = 1
    axis_names: Sequence[str] = ("data", "catalog")

    @property
    def num_devices(self) -> int:
        return self.data * self.catalog


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Retrieval knobs (reference defaults: top-10, main.cpp:166)."""

    top_k: int = 10
    # TPU kernel tiling (JAX package); the port's CUDA kernels pick their own
    # tiles.  `catalog_tile` still sets the padded catalog length, so both
    # packages build the same certified layout.
    query_tile: int = 256
    catalog_tile: int = 8192
    # guard used when normalizing by the product of norms
    eps: float = COSINE_EPS
    # True: the certified tier (hand-written kernels); False: the oracle.
    use_pallas: bool = True
    # Catalog storage dtype. "float32" (default) keeps the certified
    # exact tier.  FusedRetriever also stores "bfloat16" or "bfloat16x2"
    # (with exact_scores=False); for the Retriever, any "bfloat16..."
    # selects the approx tier (ops/fused_topk.ApproxRetriever).
    dtype: str = "float32"
    # True: reproduce the reference's division-form cosine epilogue
    # (dot / (|x||q|) with the 1e-8 product guard) bit-faithfully.
    exact_scores: bool = True
    # CertifiedRetriever: candidates kept by the bf16x2 prefilter before
    # the exact fp32 rerank; larger = fewer certificate fallbacks.
    prefilter: int = 32
    # Certified scan kernel: "v3" (epilogue-free bin scan, kernel 1) or
    # "v2" (cosine epilogue and masks inside, depth 3, W = 512; kernel 4).
    scan: str = "v3"
    # v3 bin depth: each bin keeps its top-`scan_depth` candidates plus a
    # (depth+1)-th-best coverage bound.  Default: depth 2 with a depth-3
    # escalation rescan of the queries whose certificate fails.
    scan_depth: int = 2
    # v3 bin count W (0 = auto: 128), a multiple of 128; halved until it
    # divides the catalog tile.  The CUDA scans take any such W and depth.
    scan_bins: int = 0
    # Depth-escalation rescan (0 = disabled): certificate-failing queries
    # are re-scanned at THIS deeper bin depth before any oracle fallback.
    scan_escalate: int = 3
    # bf16x2 catalog layout of the JAX package: 4 planes [hi,lo,hi,lo] or
    # 2 planes [hi,lo].  The port always builds 2 planes (its kernel reads
    # only [hi; lo]); see ops/fused_topk.build_certified_layout.
    split_planes: int = 4
    # Proven |approx - exact| bound for the bf16x2 split-plane dot
    # (see ops/fused_topk.py BF16X2_EPS derivation); the certified
    # tier's exactness certificate uses this margin.
    certify_eps: float = 2e-5


@dataclasses.dataclass(frozen=True)
class MFConfig:
    """Matrix-factorization trainer (ALS + SGD variants)."""

    embedding_dim: int = 64
    reg: float = 0.01          # L2 regularization lambda
    alpha: float = 40.0        # implicit-feedback confidence scale (iALS)
    num_iterations: int = 10   # ALS sweeps
    learning_rate: float = 0.05  # SGD variant
    batch_size: int = 8192
    seed: int = 0



@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """Two-tower retrieval model with in-batch softmax negatives."""

    embedding_dim: int = 64
    hidden_dims: Sequence[int] = (256, 128)
    temperature: float = 0.05
    learning_rate: float = 1e-3
    batch_size: int = 1024
    num_steps: int = 1000
    seed: int = 0
    # "bfloat16" runs the tower matmuls, bias adds and activations in bf16
    # while the parameters, the L2-normalize epilogue, the loss and the
    # optimizer state stay fp32; "float32" = full precision
    compute_dtype: str = "float32"
    # False: the ITEM tower skips L2 normalization so embedding magnitude
    # can encode popularity (the query side stays unit-norm); True (the
    # default) keeps unit-norm items for cosine serving
    normalize_items: bool = True
