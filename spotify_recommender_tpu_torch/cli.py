"""Command-line interface of the PyTorch port.

The reference CLI (reference main.cpp:13-31 usage, :144-186 dispatch), in
the JAX package's two calling styles:

- reference-parity flags, drop-in compatible:
    ``... --preprocess dataset.csv``
    ``... --song "Bohemian Rhapsody" -n 5``
    ``... --id "3ade68b8e" -n 10``
- subcommands: ``preprocess`` (formats npz, bin, the memory-mapped
  ``dir`` and the ``sharded`` artifact; ``--streaming`` ingests in bounded
  RAM into a ``dir``), ``recommend``, ``retrieve`` (batched query vectors
  -> top-k; ``--streaming`` streams a memory-mapped catalog directory
  through the device in windows, ``--mesh data=N,catalog=M`` row-shards
  the catalog over a device mesh, and a sharded artifact directory is
  served shard by shard),
  ``serve`` (the HTTP service, serve/server.py), ``benchmark`` (one
  benchmark row as a JSON line, benchmark.py), the matrix-factorization
  path (models/mf.py): ``train-mf`` (ALS, iALS++ ``--subspace``, SGD;
  ``--checkpoint-dir`` resumes), ``evaluate-mf``, ``recommend-user`` and
  ``embed-catalog --mf`` (the item factors as a catalog that ``recommend``,
  ``retrieve`` and ``serve`` take unchanged), and the two-tower model
  (models/two_tower.py): ``train-two-tower``, ``evaluate-two-tower`` and
  ``embed-catalog --two-tower`` (the item tower's embeddings as a
  catalog), and ``autotune`` (ops/autotune.py: the certified tier's
  candidates measured at a shape, the winner persisted for the
  benchmark).

A global ``--device`` flag (default ``cuda``) names the device retrieval
and training run on; ``--device cuda`` without a card raises.  A mesh
(``retrieve --mesh``, ``train-mf --mesh [--shard-tables]``,
``train-two-tower --mesh``) spans the visible cards, or under
``--device cpu`` that many cells on the CPU.

The default catalog artifact is ``songs_catalog.npz``, the same file the
JAX package writes and reads.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from spotify_recommender_tpu_torch.core.logging import get_logger

log = get_logger(__name__)

DEFAULT_CATALOG = "songs_catalog.npz"
DEFAULT_DEVICE = "cuda"

BANNER = """\
+------------------------------------------------+
|      Music Retrieval & Recommendation          |
|          PyTorch / CUDA (Hopper) engine        |
+------------------------------------------------+
"""

def _parse_mesh(spec: Optional[str], device: str):
    """``--mesh data=N,catalog=M`` -> core.mesh.Mesh (None when absent).

    Either axis may be omitted (defaults to 1).  On CUDA the mesh takes the
    visible cards and its size must not exceed their count (make_mesh
    checks); under ``--device cpu`` it runs its N x M cells on the CPU."""
    if not spec:
        return None
    import torch

    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.device import resolve_device
    from spotify_recommender_tpu_torch.core.mesh import make_mesh

    axes = {"data": 1, "catalog": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(
                f"--mesh expects axis=N pairs (e.g. data=8,catalog=1), got {part!r}"
            )
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in axes:
            raise SystemExit(
                f"--mesh axis must be 'data' or 'catalog', got {name!r}"
            )
        axes[name] = int(val)
    cfg = MeshConfig(data=axes["data"], catalog=axes["catalog"])
    dev = resolve_device(device)
    return make_mesh(cfg, None if dev.type == "cuda"
                     else [torch.device("cpu")] * cfg.num_devices)


def cmd_preprocess(
    csv_path: str,
    output: str,
    fmt: str = "npz",
    streaming: bool = False,
    chunk_rows: int = 200_000,
) -> int:
    from spotify_recommender_tpu_torch.data.catalog import preprocess_csv

    print("=== PREPROCESSING MODE ===")
    if streaming or fmt == "dir":
        from spotify_recommender_tpu_torch.data.streaming import (
            preprocess_csv_streaming,
        )

        out_dir = output[:-4] if output.endswith(".npz") else output
        cat = preprocess_csv_streaming(csv_path, out_dir, chunk_rows=chunk_rows)
        output = out_dir
    elif fmt == "bin":
        cat = preprocess_csv(csv_path, None)
        cat.save_reference_binary(output)
    elif fmt == "sharded":
        # the sharded artifact (data/sharded_catalog.py): per-shard row
        # blocks that `retrieve --catalog` serves shard by shard
        from spotify_recommender_tpu_torch.data.sharded_catalog import (
            save_sharded_catalog,
        )

        out_dir = output[:-4] if output.endswith(".npz") else output
        cat = preprocess_csv(csv_path, None)
        save_sharded_catalog(cat, out_dir)
        output = out_dir
    else:
        cat = preprocess_csv(csv_path, output)
    print(f"Valid songs: {len(cat)}")
    print(f"Unique genres: {cat.num_genres}")
    print("\nGenre Mapping:")
    for gid, name in enumerate(cat.genre_names):
        print(f"  ID {gid}: {name}")
    print(f"\nPreprocessing successful! Catalog saved to: {output}")
    return 0


def cmd_recommend(
    query: str, by_id: bool, top_n: int, catalog_path: str, device: str
) -> int:
    from spotify_recommender_tpu_torch.data.catalog import load_catalog
    from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

    print("=== RECOMMENDATION MODE ===")
    cat = load_catalog(catalog_path)
    retriever = Retriever(cat, None, device)

    kind = "track ID" if by_id else "song"
    print(f"\nSearching for {kind}: {query}")
    try:
        if by_id:
            row = retriever.index.find_by_track_id(query)
            recs = retriever.recommend_by_id(query, top_n)
        else:
            row = retriever.index.find_by_name(query)
            recs = retriever.recommend_by_name(query, top_n)
    except (KeyError, IndexError) as e:
        # str(KeyError) wraps the message in repr quotes; unwrap it
        msg = e.args[0] if e.args else str(e)
        print(f"Error: {msg}", file=sys.stderr)
        return 1

    if row is not None:
        q = retriever.lookup(row)
        # byte-parity with the reference's query-song card, including the
        # U+2501 rules (reference main.cpp:105-112)
        print("\n" + "━" * 46)
        print("Query Song:")
        print(f"  Title:   {q.track_name}")
        print(f"  Artist:  {q.artists}")
        print(f"  Genre:   {q.genre}")
        print(f"  ID:      {q.track_id}")
        print("━" * 46)

    print(f"\nTop {len(recs)} Recommendations:\n")
    for i, r in enumerate(recs):
        print(f'{i + 1}. "{r.track_name}"')
        print(f"   Artist: {r.artists}")
        print(f"   Genre:  {r.genre}")
        print(f"   ID:     {r.track_id}")
        print(f"   Score:  {r.score:.6f}")
        if i < len(recs) - 1:
            print()
    print("\n✓ Recommendation complete!")  # reference main.cpp:129
    return 0


def _print_retrieved(args, queries, scores, rows, track_ids) -> None:
    import json

    import numpy as np

    if args.output:
        np.savez_compressed(
            args.output,
            scores=scores,
            rows=rows,
            track_ids=track_ids[rows].astype(np.str_),
        )
        print(f"retrieved top-{args.k} for {len(queries)} queries -> {args.output}")
    else:
        for b in range(len(queries)):
            print(json.dumps({
                "query": b,
                "rows": rows[b].tolist(),
                "scores": [round(float(s), 6) for s in scores[b]],
                "track_ids": [str(t) for t in track_ids[rows[b]]],
            }))


def _retrieve_from_sharded_artifact(args, queries, device: str) -> int:
    """retrieve --catalog <sharded dir> [--mesh catalog=N] (JAX cli.py
    :170-224): open the artifact on the mesh (by default every visible
    card on "catalog", one CPU shard under --device cpu) and serve it with
    the certified tier per shard, each shard built from its own rows."""
    import numpy as np
    import torch

    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.device import resolve_device
    from spotify_recommender_tpu_torch.core.mesh import make_mesh
    from spotify_recommender_tpu_torch.data.sharded_catalog import (
        load_sharded_catalog,
    )
    from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog

    mesh = _parse_mesh(args.mesh, device)
    if mesh is None:
        dev = resolve_device(device)
        mesh = (make_mesh() if dev.type == "cuda"
                else make_mesh(MeshConfig(), [torch.device("cpu")]))
    try:
        art = load_sharded_catalog(args.catalog, mesh)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    sc = ShardedCatalog.from_artifact(art, mesh)
    scores, rows = sc.retrieve(np.asarray(queries, np.float32), args.k)
    _print_retrieved(args, queries, scores.cpu().numpy(), rows.cpu().numpy(),
                     art.host_column("track_ids"))
    return 0


def cmd_retrieve(args, device: str) -> int:
    """Batched retrieval from a query-vectors file (JAX cli.py:227-276).

    A catalog directory is dispatched on its ``meta.json`` ``layout``:
    ``dir-v1`` loads memory-mapped, ``npy-shards-v1`` (the port's sharded
    artifact) is served shard by shard, and the JAX package's orbax
    ``ocdbt-v1`` exits 1.  (The JAX CLI sends every directory with a
    ``meta.json`` to its sharded loader, which fails on ``dir-v1``.)"""
    import os

    import numpy as np

    from spotify_recommender_tpu_torch.data.catalog import (
        load_catalog,
        read_dir_meta,
    )
    from spotify_recommender_tpu_torch.retrieval.retriever import Retriever
    from spotify_recommender_tpu_torch.retrieval.streaming_retriever import (
        StreamingRetriever,
    )

    if args.queries.endswith(".npy"):
        queries = np.load(args.queries)
    else:
        with np.load(args.queries) as z:
            queries = z["queries"]
    if (os.path.isdir(args.catalog)
            and read_dir_meta(args.catalog).get("layout") != "dir-v1"):
        return _retrieve_from_sharded_artifact(args, queries, device)
    cat = load_catalog(args.catalog)
    if args.streaming:
        retriever = StreamingRetriever(cat.features, cat.norms, None, device)
    else:
        retriever = Retriever(cat, None, device,
                              mesh=_parse_mesh(args.mesh, device))
    scores, rows = retriever.retrieve(queries, k=args.k)
    _print_retrieved(args, queries, scores.cpu().numpy(), rows.cpu().numpy(),
                     np.asarray(cat.track_ids))
    return 0


def cmd_train_mf(args, device: str) -> int:
    from spotify_recommender_tpu_torch.core.config import MFConfig
    from spotify_recommender_tpu_torch.models import mf

    cfg = MFConfig(
        embedding_dim=args.dim,
        num_iterations=args.iterations,
        reg=args.reg,
        alpha=args.alpha,
        seed=args.seed,
    )
    return mf.train_from_cli(
        args.interactions, cfg, args.output, solver=args.solver,
        mesh=_parse_mesh(args.mesh, device), shard_tables=args.shard_tables,
        checkpoint_dir=args.checkpoint_dir, subspace=args.subspace,
        device=device,
    )


def cmd_train_two_tower(args, device: str) -> int:
    from spotify_recommender_tpu_torch.core.config import TwoTowerConfig
    from spotify_recommender_tpu_torch.models import two_tower

    cfg = TwoTowerConfig(
        embedding_dim=args.dim,
        num_steps=args.steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        seed=args.seed,
    )
    return two_tower.train_from_cli(
        args.catalog, cfg, args.output,
        mesh=_parse_mesh(args.mesh, device),
        checkpoint_dir=args.checkpoint_dir,
        interactions_path=args.interactions,
        device=device,
    )


def cmd_evaluate_mf(args, device: str) -> int:
    from spotify_recommender_tpu_torch.models import mf

    inter = mf.load_interactions(args.interactions)
    users, items = mf.load_model(args.mf)
    if users.shape[0] < inter.num_users or items.shape[0] < inter.num_items:
        print(
            f"Error: model covers {users.shape[0]} users x {items.shape[0]} "
            f"items but interactions reference {inter.num_users} x "
            f"{inter.num_items}",
            file=sys.stderr,
        )
        return 1
    _, heldout, seen = mf.split_leave_k_out(inter, k=args.holdout, seed=args.seed)
    m = mf.evaluate_ranking(users, items, heldout, k=args.k, train_mask=seen,
                            device=device)
    print(
        f"recall@{args.k}={m['recall@k']:.4f} ndcg@{args.k}={m['ndcg@k']:.4f} "
        f"({m['num_eval_users']} users)"
    )
    return 0


def cmd_recommend_user(args, device: str) -> int:
    import numpy as np

    from spotify_recommender_tpu_torch.data.catalog import load_catalog
    from spotify_recommender_tpu_torch.models import mf

    users, items = mf.load_model(args.mf)
    exclude = (
        np.asarray([int(x) for x in args.exclude.split(",")], np.int64)
        if args.exclude
        else None
    )
    try:
        scores, item_ids = mf.recommend_for_user(
            users, items, args.user, k=args.n, exclude_items=exclude,
            device=device,
        )
    except IndexError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    names = None
    if args.catalog:
        cat = load_catalog(args.catalog)
        if len(cat) == items.shape[0]:
            names = cat
    print(f"Top {len(item_ids)} items for user {args.user}:\n")
    for rank, (s, i) in enumerate(zip(scores, item_ids), 1):
        if names is not None:
            print(
                f'{rank}. item {i}: "{names.track_names[i]}" '
                f"({names.artists[i]})  score={s:.4f}"
            )
        else:
            print(f"{rank}. item {i}  score={s:.4f}")
    return 0


def cmd_embed_catalog(args, device: str) -> int:
    """The two-tower item embeddings or the MF item factors as the
    catalog's features."""
    import dataclasses

    import numpy as np

    from spotify_recommender_tpu_torch.data.catalog import load_catalog

    cat = load_catalog(args.catalog)
    if args.two_tower:
        from spotify_recommender_tpu_torch.models import two_tower

        params, cfg = two_tower.load_model(args.two_tower)
        emb = two_tower.embed_catalog(params, cat.features, cfg, device=device)
        source = f"two-tower {args.two_tower}"
    else:
        from spotify_recommender_tpu_torch.models import mf

        _, items = mf.load_model(args.mf)
        if items.shape[0] != len(cat):
            print(
                f"Error: MF model has {items.shape[0]} items but catalog has "
                f"{len(cat)} — they must be row-aligned",
                file=sys.stderr,
            )
            return 1
        emb = items.astype(np.float32)
        source = f"MF {args.mf}"
    out = dataclasses.replace(
        cat,
        features=emb,
        norms=np.linalg.norm(emb, axis=1).astype(np.float32),
        min_vals=np.zeros(emb.shape[1] - 1, np.float32),
        max_vals=np.ones(emb.shape[1] - 1, np.float32),
    )
    out.save(args.output)
    print(f"embedded catalog ({source}): {len(out)} items x {emb.shape[1]} dims")
    print(f"saved to: {args.output}")
    return 0


def cmd_evaluate_two_tower(args, device: str) -> int:
    from spotify_recommender_tpu_torch.data.catalog import load_catalog
    from spotify_recommender_tpu_torch.models import mf, two_tower

    cat = load_catalog(args.catalog)
    params, cfg = two_tower.load_model(args.two_tower)
    inter = mf.load_interactions(args.interactions)
    if inter.num_items > len(cat):
        print(
            f"Error: interactions reference item {inter.num_items - 1} but "
            f"the catalog has only {len(cat)} rows",
            file=sys.stderr,
        )
        return 1
    m = two_tower.evaluate_colisten(
        params, cfg, cat.features, inter,
        k=args.k, holdout=args.holdout, seed=args.seed, device=device,
    )
    print(
        f"recall@{args.k}={m['recall@k']:.4f} ndcg@{args.k}={m['ndcg@k']:.4f} "
        f"({m['num_eval_users']} users)"
    )
    return 0


def cmd_serve(args, device: str) -> int:
    from spotify_recommender_tpu_torch.serve.server import serve

    return serve(args.catalog, host=args.host, port=args.port, device=device,
                 record_spans=args.record_spans)


def cmd_benchmark(args, device: str) -> int:
    from spotify_recommender_tpu_torch import benchmark

    result = benchmark.run_benchmark(
        num_items=args.items,
        num_queries=args.queries,
        feature_dim=args.dim,
        k=args.k,
        backend=args.backend,
        device=device,
    )
    print(benchmark.to_json_line(result))
    return 0


def cmd_autotune(args, device: str) -> int:
    from spotify_recommender_tpu_torch.ops import autotune

    result = autotune.tune(n=args.items, b=args.queries, f=args.dim, k=args.k,
                           iters=args.iters, device=device)
    for cand in result.failed:
        print(f"candidate {cand['config']} failed: {cand['error']}",
              file=sys.stderr)
    cfg = result.config
    print(
        f"autotuned n={args.items} b={args.queries} f={args.dim} "
        f"k={args.k}: depth={cfg.scan_depth} esc={cfg.scan_escalate} "
        f"W={cfg.scan_bins} tq={cfg.query_tile} tc={cfg.catalog_tile} "
        f"({result.ms:.3f} ms; "
        + (f"saved to {result.path})" if result.saved
           else "not saved: fewer than 2 candidates succeeded)")
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    from spotify_recommender_tpu_torch.benchmark import BACKENDS

    p = argparse.ArgumentParser(
        prog="spotify_recommender_tpu_torch", description=__doc__
    )
    sub = p.add_subparsers(dest="command")

    sp = sub.add_parser("preprocess", help="CSV -> normalized catalog artifact")
    sp.add_argument("csv")
    sp.add_argument("-o", "--output", default=DEFAULT_CATALOG)
    sp.add_argument(
        "--format", dest="fmt", default="npz",
        choices=["npz", "dir", "bin", "sharded"],
        help="npz (compressed, default) | dir (memory-mapped directory, "
             "O(0) load for multi-GB catalogs) | bin (legacy reference "
             "songs_data.bin) | sharded (per-shard row blocks for retrieve "
             "--mesh)",
    )
    sp.add_argument(
        "--streaming", action="store_true",
        help="bounded-RAM chunked ingest (implies --format dir)",
    )
    sp.add_argument("--chunk-rows", type=int, default=200_000)

    sr = sub.add_parser("recommend", help="top-N similar songs")
    g = sr.add_mutually_exclusive_group(required=True)
    g.add_argument("--song", help="query by (case-insensitive) name")
    g.add_argument("--id", dest="track_id", help="query by exact track id")
    sr.add_argument("-n", type=int, default=10)
    sr.add_argument("--catalog", default=DEFAULT_CATALOG)

    sv = sub.add_parser(
        "retrieve", help="batched retrieval: query vectors file -> top-k"
    )
    sv.add_argument(
        "queries", help=".npz with a 'queries' (B, F) array, or .npy"
    )
    sv.add_argument("-k", type=int, default=10)
    sv.add_argument("--catalog", default=DEFAULT_CATALOG,
                    help=".npz, .bin, a dir-v1 catalog directory "
                         "(memory-mapped) or a sharded artifact directory")
    sv.add_argument("-o", "--output", default=None,
                    help="write results to .npz (default: print JSON)")
    sv.add_argument("--mesh", default=None,
                    help="device mesh, e.g. data=1,catalog=8 (row-sharded catalog)")
    sv.add_argument("--streaming", action="store_true",
                    help="host-stream the catalog through the device in "
                         "windows (capacity tier for catalogs beyond "
                         "device memory; pair with a memmap catalog dir)")

    sb = sub.add_parser("benchmark", help="retrieval throughput benchmark")
    sb.add_argument("--items", type=int, default=1_000_000)
    sb.add_argument("--queries", type=int, default=1024)
    sb.add_argument("--dim", type=int, default=12)
    sb.add_argument("--k", type=int, default=10)
    sb.add_argument("--backend", default="auto",
                    choices=BACKENDS,
                    help="auto: certified on a card, the oracle on the CPU; "
                         "xla: the oracle")

    sa = sub.add_parser(
        "autotune",
        help="measure the certified tier's tuning candidates on the device "
             "for a shape and persist the winner (ops/autotune)",
    )
    sa.add_argument("--items", type=int, default=1_000_000)
    sa.add_argument("--queries", type=int, default=1024)
    sa.add_argument("--dim", type=int, default=12)
    sa.add_argument("--k", type=int, default=10)
    sa.add_argument("--iters", type=int, default=4)

    ss = sub.add_parser("serve", help="HTTP retrieval service")
    ss.add_argument("--catalog", default=DEFAULT_CATALOG)
    ss.add_argument("--host", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=8000)
    ss.add_argument("--record-spans", action="store_true",
                    help="time each batch's phases (core/timing.Spans); "
                         "GET /metrics then adds their totals as 'spans'")

    sm = sub.add_parser("train-mf", help="ALS/SGD matrix factorization")
    sm.add_argument("interactions", help="CSV/npz of (user, item, count)")
    sm.add_argument("-o", "--output", default="mf_model.npz")
    sm.add_argument("--dim", type=int, default=64)
    sm.add_argument("--iterations", type=int, default=10)
    sm.add_argument("--reg", type=float, default=0.01)
    sm.add_argument("--alpha", type=float, default=40.0)
    sm.add_argument("--solver", default="als", choices=["als", "sgd"])
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--mesh", default=None,
                    help="device mesh, e.g. data=8 (SGD) or catalog=8 (ALS)")
    sm.add_argument("--shard-tables", action="store_true",
                    help="row-shard the factor tables over the mesh "
                         "(for tables beyond one card's memory)")
    sm.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint dir (resume from latest)")
    sm.add_argument("--subspace", type=int, default=0,
                    help="iALS++ block size (0 = full ALS solve; e.g. 16 "
                         "at --dim 64 for ~4x cheaper sweeps)")

    st = sub.add_parser("train-two-tower", help="two-tower retrieval model")
    st.add_argument("--catalog", default=DEFAULT_CATALOG)
    st.add_argument("-o", "--output", default="two_tower_model")
    st.add_argument("--dim", type=int, default=64)
    st.add_argument("--steps", type=int, default=1000)
    st.add_argument("--batch-size", type=int, default=1024)
    st.add_argument("--lr", type=float, default=1e-3)
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--mesh", default=None,
                    help="device mesh, e.g. data=8 (data-parallel batches)")
    st.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint dir (resume from latest)")
    st.add_argument("--interactions", default=None,
                    help="user_id,item_id,count CSV/npz: train on co-listen "
                         "pairs instead of same-genre self-supervision")

    sev = sub.add_parser(
        "evaluate-mf", help="recall@k / NDCG@k of an MF model on held-out data"
    )
    sev.add_argument("interactions", help="CSV/npz of (user, item, count)")
    sev.add_argument("--mf", required=True, help="MF model .npz")
    sev.add_argument("-k", type=int, default=10)
    sev.add_argument("--holdout", type=int, default=2,
                     help="interactions held out per user")
    sev.add_argument("--seed", type=int, default=0)

    su = sub.add_parser(
        "recommend-user", help="top-N items for a user from a trained MF model"
    )
    su.add_argument("--mf", required=True, help="MF model .npz")
    su.add_argument("--user", type=int, required=True)
    su.add_argument("-n", type=int, default=10)
    su.add_argument(
        "--catalog", default=None,
        help="optional catalog for item names (rows must align with MF items)",
    )
    su.add_argument(
        "--exclude", default=None,
        help="comma-separated item ids to exclude (e.g. already-consumed)",
    )

    se = sub.add_parser(
        "embed-catalog",
        help="re-embed a catalog with a trained model; output plugs into "
        "recommend/serve unchanged (learned and hand-crafted embeddings "
        "share one serving path)",
    )
    se.add_argument("--catalog", default=DEFAULT_CATALOG)
    g2 = se.add_mutually_exclusive_group(required=True)
    g2.add_argument("--two-tower",
                    help="two-tower model file (npz of flax-msgpack params)")
    g2.add_argument("--mf", help="MF model .npz (item factors)")
    se.add_argument("-o", "--output", default="embedded_catalog.npz")

    sv2 = sub.add_parser(
        "evaluate-two-tower",
        help="recall@k / NDCG@k of a two-tower model on held-out "
             "co-listen pairs",
    )
    sv2.add_argument("interactions", help="CSV/npz of (user_id,item_id,count)")
    sv2.add_argument("--two-tower", required=True, help="two-tower model file")
    sv2.add_argument("--catalog", default=DEFAULT_CATALOG)
    sv2.add_argument("-k", type=int, default=10)
    sv2.add_argument("--holdout", type=int, default=1)
    sv2.add_argument("--seed", type=int, default=0)
    return p


def _parse_reference_style(argv: List[str], device: str) -> Optional[int]:
    """Handle the reference's exact flag grammar (main.cpp:144-180)."""
    if not argv:
        return None
    mode = argv[0]
    if mode == "--preprocess":
        if len(argv) < 2:
            print("Error: CSV path required for preprocessing mode", file=sys.stderr)
            return 1
        return cmd_preprocess(argv[1], DEFAULT_CATALOG)
    if mode in ("--song", "--id"):
        if len(argv) < 2:
            print("Error: Song name or track ID required", file=sys.stderr)
            return 1
        query = argv[1]
        top_n = 10  # reference default (main.cpp:166)
        catalog = DEFAULT_CATALOG
        i = 2
        while i < len(argv) - 1:
            if argv[i] == "-n":
                try:
                    top_n = int(argv[i + 1])
                except ValueError:
                    top_n = 0
                if top_n <= 0:
                    print(
                        "Error: Invalid value for -n (must be positive)",
                        file=sys.stderr,
                    )
                    return 1
                i += 2
            elif argv[i] == "--catalog":
                catalog = argv[i + 1]
                i += 2
            else:
                i += 1
        return cmd_recommend(query, mode == "--id", top_n, catalog, device)
    return None


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # global --device <name>, taken out before either calling style parses
    device = DEFAULT_DEVICE
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("Error: --device needs a value (cuda or cpu)", file=sys.stderr)
            return 1
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    print(BANNER)
    ref = _parse_reference_style(argv, device)
    if ref is not None:
        return ref
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "preprocess":
        return cmd_preprocess(args.csv, args.output, fmt=args.fmt,
                              streaming=args.streaming,
                              chunk_rows=args.chunk_rows)
    if args.command == "recommend":
        query = args.track_id if args.track_id else args.song
        return cmd_recommend(
            query, args.track_id is not None, args.n, args.catalog, device
        )
    if args.command == "retrieve":
        return cmd_retrieve(args, device)
    if args.command == "benchmark":
        return cmd_benchmark(args, device)
    if args.command == "serve":
        return cmd_serve(args, device)
    if args.command == "autotune":
        return cmd_autotune(args, device)
    if args.command == "train-mf":
        return cmd_train_mf(args, device)
    if args.command == "evaluate-mf":
        return cmd_evaluate_mf(args, device)
    if args.command == "recommend-user":
        return cmd_recommend_user(args, device)
    if args.command == "embed-catalog":
        return cmd_embed_catalog(args, device)
    if args.command == "train-two-tower":
        return cmd_train_two_tower(args, device)
    if args.command == "evaluate-two-tower":
        return cmd_evaluate_two_tower(args, device)
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
