"""Device resolution and description.

Counterpart of the JAX package's `core/mesh.py::device_info`.  The port
never guesses a device: callers name one (`"cuda"`, `"cuda:0"`, `"cpu"`),
and asking for CUDA where no card is visible raises instead of running on
the CPU.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str                 # "gpu" or "cpu"
    num_devices: int
    device_kind: str              # torch.cuda.get_device_name, or "cpu"
    cuda_version: Optional[str]   # torch.version.cuda
    power_limit: Optional[str]    # nvidia-smi power.limit, e.g. "700.00 W"


def resolve_device(spec: Union[str, torch.device]) -> torch.device:
    """`spec` as a torch.device; raises when it names CUDA and no card is
    visible."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {spec!r} requested but torch sees no CUDA device"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {spec!r} (use cuda or cpu)")
    return device


def nvidia_smi(query: str = "name,power.limit") -> Optional[str]:
    """`nvidia-smi --query-gpu=<query> --format=csv,noheader`, or None
    where the tool is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    )
    return out.stdout.strip()


def device_info(device: torch.device) -> DeviceInfo:
    if device.type != "cuda":
        return DeviceInfo("cpu", 1, "cpu", None, None)
    index = device.index if device.index is not None else 0
    smi = nvidia_smi("power.limit")
    return DeviceInfo(
        platform="gpu",
        num_devices=torch.cuda.device_count(),
        device_kind=torch.cuda.get_device_name(index),
        cuda_version=torch.version.cuda,
        power_limit=smi.splitlines()[index] if smi else None,
    )
