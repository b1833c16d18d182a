"""Catalog rows drawn uniformly from [0, 1): the 12 min-max normalized
audio features of the recommender's schema, one call on the device."""

from __future__ import annotations

import torch


def make(config: dict, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """(rows, features) float32 on `device`."""
    return torch.rand((config["rows"], config["features"]), generator=gen,
                      device=device)
