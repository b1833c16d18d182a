"""Row-sharded embedding tables with cross-shard lookup.

The port of the JAX package's `parallel/embedding.py` (BASELINE config 4:
"row-sharded item embedding table + all-to-all lookup"): a (V, D) table
too large for one card is split into S equal row blocks over the mesh's
"catalog" axis, shard c owning rows [c * V/S, (c + 1) * V/S).

Exchange: every shard gathers the requested rows it owns and contributes
zeros for the rest; the sum over the shards assembles the (..., D)
result.  Each row of that sum has exactly one non-zero term, so a lookup
is bitwise the dense `table[ids]`, whatever the order of the sum.

- `local_lookup`: replicated ids -> replicated rows (JAX: masked local
  gather + `psum`).  Inside one process the sum runs over the shards in
  shard order, on the first shard's device; where the mesh spans the
  processes of a `torch.distributed` group it is an `all_reduce`.  The
  result is replicated, so its gradient is too: each shard takes the
  upstream gradient as it is (the transpose JAX gives the psum of a
  replicated output), and the gradient reaches only the owners' rows.
- `sharded_ids_lookup`: ids row-sharded over the same axis as the table
  (sharded-table ALS: each shard solves its rows and needs neighbour rows
  of every shard).  JAX: all_gather(ids) -> masked gather ->
  `psum_scatter`.  Inside one process: for each target shard, the sum over
  the owners of the masked gathers of that shard's ids (never the
  (S, N, md, D) stack); across processes: `all_gather_into_tensor` of the
  ids, the local owners' masked gathers of all of them, and
  `reduce_scatter_tensor` back to the targets (forward only).

A mesh may repeat a device (`[cuda:0] * 4`, `[cpu] * 8`; core/mesh.py):
S shards of one table then live on one device and are gathered one after
another.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.core.mesh import Mesh

log = get_logger(__name__)


def _masked_gather(shard: torch.Tensor, ids: torch.Tensor,
                   offset: int) -> torch.Tensor:
    """`shard`'s rows for the global `ids` it owns, zeros elsewhere:
    ids.shape + (D,) on the shard's device."""
    rows = shard.shape[0]
    local = ids.to(shard.device, torch.int64) - offset
    mine = (local >= 0) & (local < rows)
    # the other shards' ids read some row of this one and are zeroed: a
    # remainder spreads them over the rows (a clamp would send them all to
    # the first and last, where the backward's scatter-add serializes)
    gathered = shard[local.remainder(rows)]
    return torch.where(mine[..., None], gathered, 0.0)


class _ReplicatedSum(torch.autograd.Function):
    """`all_reduce` (sum) of a partial result whose sum every process
    holds; the backward passes the (replicated) gradient through as it
    is."""

    @staticmethod
    def forward(ctx, part):
        import torch.distributed as dist

        out = part.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def local_lookup(
    shards: Sequence[torch.Tensor],
    ids: torch.Tensor,
    shard_ids: Optional[Sequence[int]] = None,
    across_processes: bool = False,
) -> torch.Tensor:
    """Rows of the global `ids` (any leading shape) from a row-sharded
    table: ids.shape + (D,) on the first shard's device.

    `shards` are this process's shards (equal row counts), `shard_ids`
    their global shard indices (by default 0, 1, ...).  Out-of-range ids,
    the zero-padded tail rows included, give zero rows; callers that want
    them refused use `ShardedEmbeddingTable.lookup`.  Differentiable."""
    if shard_ids is None:
        shard_ids = range(len(shards))
    home = shards[0].device
    rows = shards[0].shape[0]
    out = None
    for shard, c in zip(shards, shard_ids):
        part = _masked_gather(shard, ids, c * rows).to(home)
        out = part if out is None else out + part
    if across_processes:
        out = _ReplicatedSum.apply(out)
    return out


def sharded_ids_lookup(
    shards: Sequence[torch.Tensor],
    ids_shards: Sequence[torch.Tensor],
    shard_ids: Optional[Sequence[int]] = None,
    across_processes: bool = False,
) -> List[torch.Tensor]:
    """Rows for ids row-sharded over the same shards as the table: one
    ids tensor per local shard (equal shapes), one ids.shape + (D,)
    result per local shard, on that shard's device.

    Inside one process (differentiable) each target's rows are the sum
    over the owners of their masked gathers.  Across processes (forward
    only) the ids are all-gathered, every local owner gathers its rows of
    all of them, and a reduce-scatter returns each target its rows."""
    if shard_ids is None:
        shard_ids = range(len(shards))
    rows = shards[0].shape[0]
    if not across_processes:
        out = []
        for ids in ids_shards:
            dev = ids.device
            acc = None
            for shard, c in zip(shards, shard_ids):
                part = _masked_gather(shard, ids, c * rows).to(dev)
                acc = part if acc is None else acc + part
            out.append(acc)
        return out

    import torch.distributed as dist

    home = shards[0].device
    mine = torch.stack([i.to(home) for i in ids_shards])   # (s, n, ...)
    world = dist.get_world_size()
    with warnings.catch_warnings():   # renamed *_single in torch 2.13
        warnings.simplefilter("ignore", FutureWarning)
        every = mine.new_empty((world * mine.shape[0], *mine.shape[1:]))
        dist.all_gather_into_tensor(every, mine.contiguous())
        contrib = None
        for shard, c in zip(shards, shard_ids):
            part = _masked_gather(shard, every, c * rows).to(home)
            contrib = part if contrib is None else contrib + part
        got = contrib.new_empty((mine.shape[0], *contrib.shape[1:]))
        dist.reduce_scatter_tensor(got, contrib.contiguous())
    return [g.to(i.device) for g, i in zip(got, ids_shards)]


def local_shards(mesh: Mesh, axis_name: str = "catalog"):
    """This process's cells of the mesh's first row along `axis_name`, as
    (global shard index, device) pairs in shard order, and the device the
    process assembles results on (its first cell's where it holds none of
    that row)."""
    if axis_name != mesh.axis_names[1]:
        raise ValueError(f"shards run along the mesh's {mesh.axis_names[1]!r}"
                         f" axis, not {axis_name!r}")
    cells = [(c, mesh.devices[0, c]) for c in range(mesh.shape[axis_name])
             if mesh.is_local(0, c)]
    if cells:
        return cells, cells[0][1]
    d, c = np.argwhere(mesh.process_ids == mesh.process_index)[0]
    return cells, mesh.devices[d, c]


class ShardedEmbeddingTable:
    """A (V, D) table row-sharded over the mesh's `axis_name`; lookups
    take replicated ids and return replicated rows.

    The vocabulary is zero-padded to a multiple of the shard count
    (`padded_vocab`).  `shards` holds this process's row blocks, each on
    its cell's device: views of `table` where it already lies there and
    needs no padding, else copies."""

    def __init__(self, table, mesh: Mesh, axis_name: str = "catalog") -> None:
        self.mesh = mesh
        self.axis_name = axis_name
        table = torch.as_tensor(table)
        self.vocab, self.dim = table.shape
        n_shards = mesh.shape[axis_name]
        pad = (-self.vocab) % n_shards
        if pad:
            table = torch.cat([table, table.new_zeros((pad, self.dim))])
        self.padded_vocab = table.shape[0]
        rows = self.padded_vocab // n_shards
        cells, self.home = local_shards(mesh, axis_name)
        self.shard_ids = [c for c, _ in cells]
        self.shards = [table[c * rows:(c + 1) * rows].to(dev)
                       for c, dev in cells]
        log.info("sharded embedding table: %dx%d over %d shards",
                 self.vocab, self.dim, n_shards)

    def lookup(self, ids, validate: bool = True) -> torch.Tensor:
        """Rows for the global `ids` (any leading shape), on the first
        local shard's device.

        With `validate` (default) the ids are range-checked on the host
        against the true vocabulary: an out-of-range id, a zero-padded
        tail row's included, raises IndexError instead of returning a
        zero row."""
        ids = torch.as_tensor(ids)
        if validate and ids.numel():
            lo, hi = int(ids.min()), int(ids.max())
            if lo < 0 or hi >= self.vocab:
                raise IndexError(
                    f"embedding ids out of range [0, {self.vocab}): "
                    f"min={lo} max={hi}")
        if not self.shards:          # a process that holds no shard
            part = torch.zeros((*ids.shape, self.dim), device=self.home)
            return _ReplicatedSum.apply(part)
        return local_lookup(self.shards, ids, self.shard_ids,
                            self.mesh.spans_processes)
