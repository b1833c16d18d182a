"""Feature normalization: the min-max pipeline.

Replacement for the reference's OpenMP normalize pass
(reference DataManager.cpp:270-301).  Exact behavioral contract:

- per-feature min/max over *valid* rows only (DataManager.cpp:273-280);
- normalized = (raw - min) / range when range > 1e-4, else the constant
  0.5 (DataManager.cpp:291-295), computed in fp32;
- feature[11] = genre_id / max(1, num_genres - 1) (DataManager.cpp:299).

`build_feature_matrix` is the host (numpy) pipeline that preprocessing
runs; `minmax_normalize` and `encode_genre_feature` are the same math as
torch functions, for re-featurization on the device of their inputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import (
    CONSTANT_FEATURE_VALUE,
    MINMAX_RANGE_FLOOR,
)


def minmax_normalize(
    raw: torch.Tensor,
    min_vals: torch.Tensor,
    max_vals: torch.Tensor,
    range_floor: float = MINMAX_RANGE_FLOOR,
    constant_value: float = CONSTANT_FEATURE_VALUE,
) -> torch.Tensor:
    """(raw - min) / range with the constant-feature rule, fp32.

    Matches reference DataManager.cpp:290-296: the comparison is
    `range > 1e-4f` on the fp32 range, and all math stays in fp32.
    """
    raw = raw.to(torch.float32)
    min_vals = min_vals.to(torch.float32)
    rng = max_vals.to(torch.float32) - min_vals
    scaled = (raw - min_vals[None, :]) / rng[None, :]
    return torch.where(
        rng[None, :] > torch.tensor(range_floor, dtype=torch.float32),
        scaled,
        torch.tensor(constant_value, dtype=torch.float32),
    )


def encode_genre_feature(genre_ids: torch.Tensor, num_genres: int) -> torch.Tensor:
    """Ordinal genre encoding: id / max(1, G-1) in fp32
    (reference DataManager.cpp:299)."""
    denom = float(max(1, int(num_genres) - 1))
    return genre_ids.to(torch.float32) / torch.tensor(denom, dtype=torch.float32)


def build_feature_matrix(
    raw_features: np.ndarray, genre_ids: np.ndarray, num_genres: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full featurization: 11 normalized audio features + genre feature.

    Returns (features (N, 12) fp32, min_vals (11,), max_vals (11,)).
    """
    if raw_features.shape[0] == 0:
        f = np.zeros((0, raw_features.shape[1] + 1), dtype=np.float32)
        z = np.zeros((raw_features.shape[1],), dtype=np.float32)
        return f, z, z
    raw = np.ascontiguousarray(raw_features, dtype=np.float32)
    min_vals = raw.min(axis=0)
    max_vals = raw.max(axis=0)
    rng = max_vals - min_vals
    with np.errstate(divide="ignore", invalid="ignore"):
        scaled = (raw - min_vals[None, :]) / rng[None, :]
    audio = np.where(
        rng[None, :] > np.float32(MINMAX_RANGE_FLOOR),
        scaled,
        np.float32(CONSTANT_FEATURE_VALUE),
    ).astype(np.float32)
    denom = np.float32(max(1, int(num_genres) - 1))
    genre = genre_ids.astype(np.float32) / denom
    feats = np.concatenate([audio, genre[:, None]], axis=1)
    return feats.astype(np.float32), min_vals, max_vals
