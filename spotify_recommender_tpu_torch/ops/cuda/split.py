"""Kernel 2 of the certified path: the faithful bf16x2 split.

`split_bf16x2(x)` returns hi = bf16(x) and lo = bf16(x - hi), both rounded
to nearest even.  On a CUDA tensor it launches the hand-written kernel
(`csrc/split_bf16x2.cu`, replacing the TPU kernel `_split_bf16x2`,
spotify_recommender_tpu/ops/pallas/fused_topk.py:244); on a CPU tensor it
runs `split_bf16x2_plain`, the same arithmetic in torch ops.  The two are
bitwise equal on finite inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spotify_recommender_tpu_torch.ops.cuda import _build


def split_bf16x2_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def split_bf16x2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, d) fp32 -> two (m, d) bf16 tensors on x's device."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x2 takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return split_bf16x2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"split_bf16x2: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("split_bf16x2 takes a contiguous tensor")
    hi = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lo = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().srt_split_bf16x2(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "split_bf16x2")
    split_bf16x2.launches += 1
    return hi, lo


split_bf16x2.launches = 0   # kernel launches (CUDA tensors only)
