"""The port's own lower-precision path, as a control: the `Retriever` of
systems/retriever.py with a `bfloat16x2` catalog, which selects its
"approx" tier (kernel 1 alone: bf16x2 scores, no fp32 rerank, no
certificate, no fallback).  No cell runs it; tools/readings.py and the
fault tests put it in the program's place.

Where k is over the configuration's depth x W, the approx tier cannot
answer, so W is raised to the least multiple of 128 whose depth x W holds
the k + 8 candidates the tier selects."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.systems import retriever


def approx_config(config: dict, k: int) -> dict:
    """`config` with the approx tier's dtype and a W that holds k."""
    rc = dict(config["retrieval"], dtype="bfloat16x2")
    depth = rc["scan_depth"]
    need = -(-(k + 8) // (depth * 128)) * 128
    rc["scan_bins"] = max(rc["scan_bins"] or 128, need)
    return dict(config, retrieval=rc)


def build(config: dict, features: np.ndarray, device: torch.device, k: int):
    """The approx tier over `features` (N, F) float32 on the host, able to
    answer k."""
    system = retriever.build(approx_config(config, k), features, device)
    if system.backend != "approx":
        raise RuntimeError(f"expected the approx tier, built {system.backend}")
    return system


call = retriever.call
