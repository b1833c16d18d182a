"""Sharded-catalog retrieval: the item matrix row-sharded over a mesh.

The port of the JAX package's `parallel/sharding.py`.  The reference is
strictly single-device (`cudaSetDevice(0)`, reference Recommender.cu:124).
The scale-out plan:

- the catalog's N rows are split into S equal shards over the mesh's
  "catalog" axis (pad rows at the end, masked by each shard's valid count);
- each shard scores its rows and selects a **local** top-k, with its global
  exclusions translated to local columns and its local indices translated
  back to global rows: only k (score, index) pairs per query per shard
  leave a shard, never the (B, N) score matrix;
- one gather collects the per-shard candidates and
  `merge_topk_deterministic` selects the global top-k, ties to the lowest
  global index, so results do not depend on the shard layout;
- queries are replicated over "catalog" and, with `data_axis`, split over
  "data" (each data group runs the catalog-sharded retrieval on its slice
  of the batch).

Three backends, as in the JAX package:

- "xla" (default): the port's fixed-order oracle per shard
  (`similarity.exact_topk_chunked(fixed_order=True)`), the single-device
  port's oracle;
- "pallas" (`use_pallas=True`): kernel 3 per shard (`FusedRetriever` over
  the shard's columns of the JAX package's padded layout, :353-375);
- "certified" (`use_certified=True`): the certified tier per shard
  (`CertifiedRetriever`: kernels 2 and 1, rerank, certificate, depth-3
  rescan, oracle fallback) over the shard's slice of
  `build_certified_layout(n_shards=S)`, every shard given the GLOBAL
  minimum nonzero norm (a shard's own minimum could certify unsoundly),
  its valid count as kernel 1's `ncols`.  Each shard's own fallback keeps
  its local top-k exact, so the merge is exact: the JAX package's
  whole-batch oracle redo on a fallback overflow (:587-601) has no
  counterpart, because the port's certified tier has no fallback cap.

The gather is one function with two routes: inside a process the
candidates are concatenated on the mesh's first device in use; where the
mesh spans the processes of a `torch.distributed` group
(parallel/distributed.global_mesh) it is `all_gather_into_tensor` over the
group.  Every shard's work is issued before any result is read (the
certified tier's `start` / `finish`), so shards on distinct cards overlap;
shards that share one device run one after another.  The kernels launch on
CUDA devices and their plain versions run on the CPU, as everywhere in the
port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.core.mesh import Mesh
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.parallel.distributed import (
    all_gather_rows,
    all_reduce,
)
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2
from spotify_recommender_tpu_torch.ops.fused_topk import (
    CertifiedLayout,
    CertifiedRetriever,
    DeviceLayout,
    FusedRetriever,
    build_certified_layout,
)
from spotify_recommender_tpu_torch.ops.topk import merge_topk_deterministic

log = get_logger(__name__)

NEG_INF = float("-inf")
Cell = Tuple[int, int]          # (data index, catalog index) of the mesh


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _shard_layout(lay: CertifiedLayout, c: int, n_local: int) -> CertifiedLayout:
    """Shard `c`'s columns and rows of a layout built with n_shards."""
    sl = slice(c * n_local, (c + 1) * n_local)
    return dataclasses.replace(
        lay, np_pad=n_local, ft=lay.ft[:, sl], nrm_row=lay.nrm_row[:, sl],
        feats32=lay.feats32[sl], norms1d=lay.norms1d[sl],
    )


def gather_candidates(
    scores: torch.Tensor, rows: torch.Tensor, mesh: Mesh
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cells' candidates of every process: (cells, b, k) tensors of
    this process's cells in, the same stacked over the group's ranks out
    (rank 0's cells first).  Inside one process they are returned as they
    are."""
    return all_gather_rows(scores, mesh), all_gather_rows(rows, mesh)


class ShardedCatalog:
    """A row-sharded catalog on a mesh (see the module docstring).

    Backends: `use_certified=True` runs the certified exact tier per shard
    (the production sharded path); `use_pallas=True` kernel 3 per shard
    over fp32 rows, raw or, under `exact_scores=False`, prenormalized;
    otherwise the fixed-order oracle per shard.  The rest comes from
    `config` (its `eps`, and the tiers' knobs).  `fallbacks` and
    `escalations` count the certified tier's, summed over shards and,
    across processes, over the group."""

    def __init__(
        self,
        features: np.ndarray,
        norms: Optional[np.ndarray],
        mesh: Mesh,
        axis_name: str = "catalog",
        use_pallas: bool = False,
        use_certified: bool = False,
        data_axis: Optional[str] = None,
        config: Optional[RetrievalConfig] = None,
    ) -> None:
        config = config or RetrievalConfig()
        feats = np.asarray(features, np.float32)
        if norms is None:
            norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        nrm = np.asarray(norms, np.float32)
        n, f = feats.shape
        self._init_common(mesh, axis_name, data_axis, config, n, f)
        self.use_pallas = use_pallas and not use_certified
        self.use_certified = use_certified
        s = self.n_shards
        if use_certified:
            # the single-device tier's layout function, so both run the same
            # scan, depth and W from one RetrievalConfig
            lay = build_certified_layout(feats, nrm, config, n_shards=s)
            self.w, self.scan, self.depth = lay.w, lay.scan, lay.depth
            self.rn_min = lay.rn_min
            self.n_local = lay.np_pad // s

            def make(c, dev):
                return CertifiedRetriever.from_layout(
                    _shard_layout(lay, c, self.n_local), self._valid(c), f,
                    config, dev)
        elif use_pallas:
            # the JAX package's per-shard kernel layout: Np a multiple of
            # S x tc, so every shard's slice tiles evenly
            tc = min(config.catalog_tile, 128 * max(1, -(-n // (128 * s))))
            np_pad = _round_up(n, s * tc)
            self.n_local = np_pad // s
            exact = config.exact_scores
            rows = feats if exact else feats / np.maximum(nrm, 1e-30)[:, None]
            ft = np.zeros((f, np_pad), np.float32)
            ft[:, :n] = rows.T
            nrm_p = np.zeros(np_pad, np.float32)
            nrm_p[:n] = nrm
            # fp32 storage whatever `dtype` asks, as the JAX sharded kernel
            fcfg = dataclasses.replace(config, dtype="float32")

            def make(c, dev):
                sl = slice(c * self.n_local, (c + 1) * self.n_local)
                return FusedRetriever.from_layout(
                    ft[:, sl], nrm_p[sl], self._valid(c), fcfg, dev)
        else:
            self.n_local = _round_up(n, s) // s

            def make(c, dev):
                sl = slice(c * self.n_local, c * self.n_local + self._valid(c))
                return (torch.from_numpy(feats[sl]).to(dev),
                        torch.from_numpy(nrm[sl]).to(dev))
        self._build_shards(make)
        log.info(
            "sharded catalog: %d items over %d '%s' shards (backend=%s)",
            n, s, axis_name, self.backend,
        )

    def _init_common(self, mesh, axis_name, data_axis, config, n, f):
        self.config = config
        self.mesh = mesh
        self.axis_name = axis_name
        # 2-D data x catalog parallelism: with `data_axis` set (and the mesh
        # carrying that axis), each data group scores its slice of the batch
        # against the whole catalog, so the batch must divide that axis
        self.data_axis = data_axis if (
            data_axis is not None and mesh.shape.get(data_axis, 1) > 1
        ) else None
        self.num_items = n
        self.feature_dim = f
        self.n_shards = mesh.shape[axis_name]
        self.fallbacks = 0
        self.escalations = 0

    @property
    def backend(self) -> str:
        return ("certified" if self.use_certified
                else "pallas" if self.use_pallas else "xla")

    def _valid(self, c: int) -> int:
        """Real rows of shard c (the rest of its n_local are padding)."""
        return int(np.clip(self.num_items - c * self.n_local, 0, self.n_local))

    def _cells(self) -> List[Cell]:
        """The mesh cells in use, data-major: every data row under
        `data_axis`, else row 0 (the batch is replicated over "data")."""
        n_data = self.mesh.shape[self.data_axis] if self.data_axis else 1
        return [(d, c) for d in range(n_data) for c in range(self.n_shards)]

    def _build_shards(self, make) -> None:
        """One backend per (shard, device) among this process's cells in
        use; a shard without real rows gets none."""
        cells = self._cells()
        counts = {r: sum(int(self.mesh.process_ids[cell]) == r for cell in cells)
                  for r in np.unique(self.mesh.process_ids)}
        if len(set(counts.values())) > 1:
            raise ValueError(
                f"the mesh's cells in use are not spread evenly over its "
                f"processes ({counts}); shard the batch with data_axis='data'")
        self._local = [cell for cell in cells if self.mesh.is_local(*cell)]
        self._shards: Dict[Tuple[int, str], object] = {}
        for d, c in self._local:
            dev = self.mesh.devices[d, c]
            if self._valid(c) and (c, str(dev)) not in self._shards:
                self._shards[(c, str(dev))] = make(c, dev)
        self._home = self.mesh.devices[self._local[0]]

    @classmethod
    def from_artifact(
        cls,
        artifact,
        mesh: Mesh,
        axis_name: str = "catalog",
        data_axis: Optional[str] = None,
        config: Optional[RetrievalConfig] = None,
    ) -> "ShardedCatalog":
        """The certified sharded tier straight from a sharded artifact
        (data/sharded_catalog.load_sharded_catalog): each shard reads only
        its own rows and builds its layout on its device (the unit rows'
        split planes through kernel 2 on a card), so no process holds the
        whole matrix.  The global minimum nonzero norm is reduced over the
        shards and, across processes, over the group."""
        config = config or RetrievalConfig()
        self = cls.__new__(cls)
        n_shards = mesh.shape[axis_name]
        rows, f = artifact.padded_rows, artifact.feature_dim
        if rows % n_shards:
            raise ValueError(
                f"artifact rows {rows} not divisible by mesh axis "
                f"{axis_name}={n_shards}"
            )
        n_local = rows // n_shards
        if n_local % 512:
            raise ValueError(
                f"per-shard rows {n_local} must be a multiple of 512; re-save "
                f"the artifact with shard_multiple a multiple of "
                f"{512 * n_shards}"
            )
        self._init_common(mesh, axis_name, data_axis, config,
                          artifact.num_items, f)
        self.use_pallas, self.use_certified = False, True
        self.n_local = n_local
        # the JAX package's tile: the largest power of two <= catalog_tile
        # dividing the shard; W is halved until it divides the tile
        tc = next((t for t in (8192, 4096, 2048, 1024, 512)
                   if t <= config.catalog_tile and n_local % t == 0), 512)
        self.scan = config.scan
        self.depth = config.scan_depth if config.scan == "v3" else 3
        nw = max(1, config.scan_bins // 128) if config.scan_bins else (
            1 if config.scan == "v3" else 4)
        while nw > 1 and (tc // 128) % nw:
            nw //= 2
        self.w = 128 * nw
        cells = [cell for cell in self._cells() if mesh.is_local(*cell)]
        # this process's shards' rows (memmap views), and no other rows
        shard_rows = {c: artifact.shard(c, n_shards)
                      for c in sorted({c for _, c in cells})}
        nz = np.concatenate([nrm[nrm > 0] for _, nrm in shard_rows.values()])
        rn_min = torch.tensor(float(nz.min()) if nz.size else np.inf,
                              dtype=torch.float64, device=mesh.devices[cells[0]])
        rn_min = float(all_reduce(rn_min, mesh, "MIN"))
        self.rn_min = rn_min if np.isfinite(rn_min) else float(
            np.finfo(np.float32).max)

        def make(c, dev):
            feats_c, norms_c = shard_rows[c]
            feats = torch.from_numpy(np.array(feats_c, np.float32)).to(dev)
            nrm = torch.from_numpy(np.array(norms_c, np.float32)).to(dev)
            # build_certified_layout's math on the device: unit rows
            # (IEEE fp32 division, as numpy's), split into [hi; lo] planes
            hi, lo = split_bf16x2(feats / nrm.clamp_min(1e-30)[:, None])
            dl = DeviceLayout(
                w=self.w, depth=self.depth, scan=self.scan,
                ft=torch.cat([hi.T, lo.T]).contiguous(), nrm_row=nrm,
                feats32=feats, norms1d=nrm, rn_min=self.rn_min,
            )
            return CertifiedRetriever.from_layout(dl, self._valid(c), f, config,
                                                  dev)

        self._build_shards(make)
        log.info(
            "sharded catalog from artifact: %d items over %d '%s' shards "
            "(certified, scan=%s depth=%d W=%d)", self.num_items, n_shards,
            axis_name, self.scan, self.depth, self.w,
        )
        return self

    def retrieve(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F) queries -> (scores (B, k) fp32, rows (B, k) int64) on the
        mesh's first device in use; `exclude_rows` (B,) global rows, -1 =
        none.  Unfilled slots (fewer than k rows) are (-inf, -1)."""
        q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32))
        b = q.shape[0]
        excl = (torch.full((b,), -1, dtype=torch.int64) if exclude_rows is None
                else torch.as_tensor(exclude_rows).long().reshape(b))
        n_data = self.mesh.shape[self.data_axis] if self.data_axis else 1
        if b % n_data:
            raise ValueError(
                f"batch {b} must divide the '{self.data_axis}' axis "
                f"size {n_data}"
            )
        b_local, k_local = b // n_data, min(k, self.n_local)
        before = self._counts()
        inputs = {}
        started = []
        for d, c in self._local:          # issue every shard's work first
            dev = self.mesh.devices[d, c]
            if (d, str(dev)) not in inputs:
                sl = slice(d * b_local, (d + 1) * b_local)
                inputs[(d, str(dev))] = (q[sl].to(dev), excl[sl].to(dev))
            qd, ed = inputs[(d, str(dev))]
            off = c * self.n_local
            # global exclusions in this shard's frame (-1 elsewhere)
            el = torch.where((ed >= off) & (ed < off + self.n_local),
                             ed - off, -1)
            started.append((off, self._start(c, dev, qd, el, k_local)))
        parts_s, parts_i = [], []
        for off, work in started:
            s, i = self._finish(work, b_local, k_local)
            parts_s.append(s.to(self._home))
            parts_i.append(torch.where(i >= 0, i + off, -1).to(self._home))
        cand_s, cand_i = gather_candidates(torch.stack(parts_s),
                                           torch.stack(parts_i), self.mesh)
        if self.use_certified:
            delta = torch.tensor(self._counts(), dtype=torch.int64,
                                 device=self._home) - torch.tensor(
                                     before, dtype=torch.int64,
                                     device=self._home)
            delta = all_reduce(delta, self.mesh, "SUM").tolist()
            self.fallbacks += delta[0]
            self.escalations += delta[1]
        # the gathered cells in the ranks' order -> the global top-k per
        # data group, ties to the lowest global index
        order = [cell for r in range(int(self.mesh.process_ids.max()) + 1)
                 for cell in self._cells()
                 if int(self.mesh.process_ids[cell]) == r]
        out_s, out_i = [], []
        for d in range(n_data):
            pos = [j for j, (dd, _) in enumerate(order) if dd == d]
            ms, mi = merge_topk_deterministic(
                torch.cat(list(cand_s[pos]), dim=1),
                torch.cat(list(cand_i[pos]), dim=1), k)
            out_s.append(ms)
            out_i.append(mi)
        return torch.cat(out_s), torch.cat(out_i)

    def _start(self, c, dev, q, excl, k):
        shard = self._shards.get((c, str(dev)))
        if shard is None:            # a shard of padding only
            return None
        if self.use_certified:
            return shard, shard.start(q, k, excl)
        if self.use_pallas:
            return shard(q, k, excl)
        feats, nrm = shard
        return similarity.exact_topk_chunked(
            q, feats, nrm, exclude_rows=excl, k=k, eps=self.config.eps,
            fixed_order=True)

    def _finish(self, work, b: int, k: int):
        if work is None:
            return (torch.full((b, k), NEG_INF, device=self._home),
                    torch.full((b, k), -1, dtype=torch.int64,
                               device=self._home))
        if self.use_certified:
            shard, batch = work
            return shard.finish(batch)
        return work

    def _counts(self) -> Tuple[int, int]:
        if not self.use_certified:
            return (0, 0)
        shards = self._shards.values()
        return (sum(s.fallbacks for s in shards),
                sum(s.escalations for s in shards))
