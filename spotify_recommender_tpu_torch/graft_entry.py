"""The port's counterpart of the JAX repo's `__graft_entry__.py`: two
entry points that exercise the system end to end.

- ``entry()``: the flagship retrieval forward step, the certified exact
  pipeline (kernel 2's split, kernel 1's bin scan, top-C, exact fp32
  rerank, certificate, escalation, oracle fallback), and its example
  arguments.  On a card the kernels run; on the CPU their plain versions.
- ``dryrun_multichip(n)``: one step of every multi-device path over an
  n-cell mesh: the row-sharded catalog (the fixed-order oracle, the
  certified tier and kernel 3 per shard, a 2-D data x catalog mesh, the
  sharded artifact), the sharded-table ALS half-step, the row-sharded
  embedding table and the data-parallel two-tower step.  The mesh takes n
  cards where the process sees that many, else repeats one device n
  times (S shards one after another).

Both run on ``device="cuda"`` unless told ``"cpu"``; without a card they
raise.

    python -m spotify_recommender_tpu_torch.graft_entry [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Union

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.device import resolve_device

Device = Union[str, torch.device]


def entry(device: Device = "cuda"):
    """(forward, example_args): forward(queries, ft, nrm_row, feats32,
    norms1d, rn_min, excl, nvalid) -> (scores (B, 10), rows (B, 10)) is the
    certified tier over a prebuilt device layout (W = 256, top-C 32, as
    the JAX entry's), 4096 x 12 items and 64 catalog-row queries with
    self-exclusion.  The tier is built once, over the example layout that
    example_args carry."""
    from spotify_recommender_tpu_torch.core.config import RetrievalConfig
    from spotify_recommender_tpu_torch.ops.fused_topk import (
        CertifiedRetriever,
        build_certified_layout,
        layout_to_device,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, f = 4096, 12
    feats = rng.random((n, f), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    config = RetrievalConfig(scan_bins=256, prefilter=32)
    dl = layout_to_device(build_certified_layout(feats, norms, config), dev)
    # built once: its set-up transposes the rows for the oracle
    tier = CertifiedRetriever.from_layout(dl, n, f, config, dev)

    def forward(q, ft, nrm_row, feats32, norms1d, rn_min, excl, nvalid):
        # the layout arguments, kept for the JAX entry's signature, are
        # the tier's own
        return tier(q, 10, excl)

    queries = torch.from_numpy(feats[:64]).to(dev)
    excl = torch.arange(64, device=dev)
    return forward, (queries, dl.ft, dl.nrm_row, dl.feats32, dl.norms1d,
                     dl.rn_min, excl, n)


def _check_rows(rows: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not torch.equal(rows.cpu(), want.cpu()):
        raise AssertionError(f"dryrun_multichip: {what} differs from the "
                             "fixed-order oracle")


def dryrun_multichip(n_devices: int, device: Device = "cuda") -> None:
    """Run one step of each multi-device path over an `n_devices`-cell
    mesh and hold the retrievals to the fixed-order oracle; raises on a
    mismatch."""
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh
    from spotify_recommender_tpu_torch.data.catalog import Catalog
    from spotify_recommender_tpu_torch.data.sharded_catalog import (
        load_sharded_catalog,
        save_sharded_catalog,
    )
    from spotify_recommender_tpu_torch.models import mf
    from spotify_recommender_tpu_torch.models.two_tower import dryrun_train_step
    from spotify_recommender_tpu_torch.ops import similarity
    from spotify_recommender_tpu_torch.parallel.embedding import (
        ShardedEmbeddingTable,
    )
    from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = make_mesh(MeshConfig(catalog=n_devices), devices)
    rng = np.random.default_rng(0)
    # deliberately uneven: the last shard carries 3 real rows and padding,
    # so the global-index translation and the pad masks are on the hook
    feats = rng.random((64 * n_devices + 3, 12), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    queries = torch.from_numpy(feats[:8]).to(devices[0])
    _, oracle = similarity.exact_topk_chunked(
        queries, torch.from_numpy(feats).to(devices[0]),
        torch.from_numpy(norms).to(devices[0]), k=5, fixed_order=True)
    for kw in ({}, {"use_certified": True}, {"use_pallas": True}):
        sc = ShardedCatalog(feats, norms, mesh, **kw)
        scores, rows = sc.retrieve(queries, k=5)
        if scores.shape != (8, 5):
            raise AssertionError(f"dryrun_multichip: shape {scores.shape}")
        _check_rows(rows, oracle, f"the {sc.backend} sharded catalog")
    # 2-D data x catalog: the batch split over "data"
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2d = make_mesh(MeshConfig(data=2, catalog=n_devices // 2),
                           devices)
        sc2 = ShardedCatalog(feats, norms, mesh2d, data_axis="data",
                             use_certified=True)
        _check_rows(sc2.retrieve(queries, k=5)[1], oracle, "the 2-D mesh")

    # the sharded artifact: save -> load on the mesh -> certified shards
    n_items = feats.shape[0]
    ids = np.asarray([f"t{i}" for i in range(n_items)], object)
    cat = Catalog(feats, norms, ids, ids, ids, np.zeros(n_items, np.int32),
                  ["g"], np.zeros(11, np.float32), np.ones(11, np.float32))
    with tempfile.TemporaryDirectory() as td:
        save_sharded_catalog(cat, td + "/cat", shard_multiple=512 * n_devices)
        art = load_sharded_catalog(td + "/cat", mesh)
        sca = ShardedCatalog.from_artifact(art, mesh)
        _check_rows(sca.retrieve(queries, k=5)[1], oracle, "from_artifact")

    # sharded-table ALS half-step: both factor tables row-sharded, the
    # neighbour rows exchanged through the sharded lookup
    rows_per = 8 * n_devices
    other = torch.from_numpy(rng.standard_normal((rows_per, 8)).astype(
        np.float32))
    idx = torch.from_numpy(rng.integers(0, rows_per, (rows_per, 3)))
    step = mf.make_sharded_table_half_step(mesh, reg=0.1, alpha=1.0)

    def split(t):
        return [t[c * 8:(c + 1) * 8].to(d) for c, d in enumerate(devices)]

    out = step(split(other), split(idx), split(torch.ones(idx.shape)),
               split(torch.ones(idx.shape, dtype=torch.bool)))
    if not all(bool(torch.isfinite(o).all()) for o in out):
        raise FloatingPointError("dryrun_multichip: sharded-table half-step")

    # the row-sharded embedding table and its cross-shard lookup
    dense = rng.standard_normal((16 * n_devices + 5, 8)).astype(np.float32)
    table = ShardedEmbeddingTable(dense, mesh)
    got = [0, 7, 16 * n_devices + 4]
    emb = table.lookup(got)
    if not torch.equal(emb.cpu(), torch.from_numpy(dense[got])):
        raise AssertionError("dryrun_multichip: embedding lookup")

    # the data-parallel two-tower step (all-gathered negatives)
    dryrun_train_step(mesh)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", type=int, default=8)
    a = p.parse_args()
    fn, args = entry(a.device)
    s, i = fn(*args)
    print("entry OK:", tuple(s.shape), tuple(i.shape))
    dryrun_multichip(a.devices, a.device)
    print("dryrun_multichip OK")
