"""Device mesh: a (data, catalog) grid of torch devices.

The port of the JAX package's `core/mesh.py`.  JAX builds a
`jax.sharding.Mesh` over its devices; torch has no such object, so `Mesh`
here is the port's own: the axis names, a (data, catalog) grid of
`torch.device`s, and the process that owns each cell.  `shape` is a dict
of axis sizes, as `jax.sharding.Mesh.shape` is, so code reads
`mesh.shape["catalog"]` in both packages.

An explicit `devices` list may name one device more than once, e.g.
`[torch.device("cuda:0")] * 4` or `[torch.device("cpu")] * 8`: S shards
of one catalog then run on one device, one after another.  That is the
port's counterpart of the JAX package's virtual 8-device CPU mesh
(`jax_num_cpu_devices=8`), and how one card runs the sharded path.

A mesh from `make_mesh` lives in one process; `parallel/distributed.
global_mesh` builds one whose cells span the processes of a
`torch.distributed` group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import MeshConfig
from spotify_recommender_tpu_torch.core.device import (  # noqa: F401
    DeviceInfo,
    device_info,
)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, catalog) grid of devices.

    `devices[d, c]` is the torch device of cell (d, c) as its owning
    process names it, `process_ids[d, c]` that process's rank, and
    `process_index` the rank of this process (0 outside a process
    group)."""

    devices: np.ndarray          # (data, catalog) object array of torch.device
    axis_names: tuple
    process_ids: np.ndarray      # (data, catalog) int
    process_index: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        """True where some cell belongs to another process."""
        return bool((self.process_ids != self.process_index).any())

    def is_local(self, d: int, c: int) -> bool:
        return int(self.process_ids[d, c]) == self.process_index


def _grid(items: Sequence, config: MeshConfig) -> np.ndarray:
    grid = np.empty(len(items), dtype=object)
    grid[:] = list(items)
    return grid.reshape(config.data, config.catalog)


def make_mesh(config: Optional[MeshConfig] = None, devices=None) -> Mesh:
    """A 2-D ("data", "catalog") mesh in this process.

    By default the mesh spans all visible CUDA devices on the "catalog"
    axis (the row-sharded catalog); `devices` names them instead (a device
    may repeat, see the module docstring).  A config that wants more
    devices than there are raises ValueError."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if config is None:
        config = MeshConfig(data=1, catalog=len(devices))
    n = config.num_devices
    if n < 1 or n > len(devices):
        raise ValueError(
            f"MeshConfig wants {n} devices but only {len(devices)} are visible"
        )
    return Mesh(
        devices=_grid(devices[:n], config),
        axis_names=tuple(config.axis_names),
        process_ids=np.zeros((config.data, config.catalog), np.int64),
    )
