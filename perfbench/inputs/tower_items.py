"""A two-tower item catalog: uniform [0, 1) feature rows, as `uniform`
makes them, through the benchmark's own frozen item tower
(reference/tower.py) at the configuration's widths.  The embeddings are
the catalog: an input the benchmark makes, not something the program
derives."""

from __future__ import annotations

import torch

from perfbench.reference import tower


def make(config: dict, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """(rows, tower widths[-1]) unit-norm float32 on `device`."""
    dims = config["tower"]["widths"]
    x = torch.rand((config["rows"], dims[0]), generator=gen, device=device)
    layers = tower.draw_weights(dims, gen, device)
    return tower.embed(x, layers)
