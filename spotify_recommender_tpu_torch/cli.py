"""Command-line interface of the PyTorch port.

The reference CLI (reference main.cpp:13-31 usage, :144-186 dispatch), in
the JAX package's two calling styles:

- reference-parity flags, drop-in compatible:
    ``... --preprocess dataset.csv``
    ``... --song "Bohemian Rhapsody" -n 5``
    ``... --id "3ade68b8e" -n 10``
- subcommands: ``preprocess`` (formats npz and bin) and ``recommend``.

A global ``--device`` flag (default ``cuda``) names the device retrieval
runs on; ``--device cuda`` without a card raises.  The JAX package's other
subcommands are not ported yet and exit 1.

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

# subcommands of the JAX package that this package does not have yet
NOT_PORTED = (
    "retrieve", "benchmark", "autotune", "train-mf", "train-two-tower",
    "evaluate-mf", "recommend-user", "embed-catalog", "evaluate-two-tower",
    "serve",
)


def _load_catalog(path: str):
    from spotify_recommender_tpu_torch.data.catalog import Catalog

    if path.endswith(".bin"):
        return Catalog.load_reference_binary(path)
    return Catalog.load(path)


def cmd_preprocess(csv_path: str, output: str, fmt: str = "npz") -> int:
    from spotify_recommender_tpu_torch.data.catalog import preprocess_csv

    print("=== PREPROCESSING MODE ===")
    if fmt == "bin":
        cat = preprocess_csv(csv_path, None)
        cat.save_reference_binary(output)
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
    from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

    print("=== RECOMMENDATION MODE ===")
    cat = _load_catalog(catalog_path)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spotify_recommender_tpu_torch", description=__doc__
    )
    sub = p.add_subparsers(dest="command")

    sp = sub.add_parser("preprocess", help="CSV -> normalized catalog artifact")
    sp.add_argument("csv")
    sp.add_argument("-o", "--output", default=DEFAULT_CATALOG)
    sp.add_argument(
        "--format", dest="fmt", default="npz", choices=["npz", "bin"],
        help="npz (compressed, default) | bin (legacy reference "
             "songs_data.bin)",
    )

    sr = sub.add_parser("recommend", help="top-N similar songs")
    g = sr.add_mutually_exclusive_group(required=True)
    g.add_argument("--song", help="query by (case-insensitive) name")
    g.add_argument("--id", dest="track_id", help="query by exact track id")
    sr.add_argument("-n", type=int, default=10)
    sr.add_argument("--catalog", default=DEFAULT_CATALOG)
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
    if argv and argv[0] in NOT_PORTED:
        print(
            f"Error: '{argv[0]}' is not ported to the PyTorch package yet "
            "(see ROADMAP.md)",
            file=sys.stderr,
        )
        return 1

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "preprocess":
        return cmd_preprocess(args.csv, args.output, fmt=args.fmt)
    if args.command == "recommend":
        query = args.track_id if args.track_id else args.song
        return cmd_recommend(
            query, args.track_id is not None, args.n, args.catalog, device
        )
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
