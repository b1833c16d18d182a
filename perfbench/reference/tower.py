"""A frozen plain-torch item tower: the MLP that turns a song's feature row
into the embedding a two-tower catalog serves.

    x -> Linear -> ReLU -> ... -> Linear -> x / max(|x|, 1e-8)

Weights are drawn from a generator on the device in one call per layer:
a normal of standard deviation sqrt(1 / fan_in), clipped at two standard
deviations; biases are zero (an untrained tower).  Products in float32
with TF32 off.  Imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def draw_weights(dims: Sequence[int], gen: torch.Generator,
                 device: torch.device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(weight (out, in), bias (out,)), ...] for the widths `dims`."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((b, a), generator=gen, device=device)
        w.clamp_(-2.0, 2.0).mul_((1.0 / a) ** 0.5)
        layers.append((w, torch.zeros(b, device=device)))
    return layers


def embed(x: torch.Tensor, layers, block: int = 262144) -> torch.Tensor:
    """(N, in) float32 rows -> (N, out) unit-norm float32 embeddings, in
    blocks of rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for s in range(0, x.shape[0], block):
        h = x[s:s + block]
        for j, (w, b) in enumerate(layers):
            h = h @ w.T + b
            if j < len(layers) - 1:
                h = torch.relu(h)
        n = torch.linalg.vector_norm(h, dim=1, keepdim=True)
        out.append(h / n.clamp_min(1e-8))
    return torch.cat(out)
