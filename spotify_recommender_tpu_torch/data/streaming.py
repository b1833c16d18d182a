"""Streaming (bounded-RAM) CSV preprocessing → memory-mapped catalog.

The port of the JAX package's `data/streaming.py`.  The reference slurps
the whole CSV into RAM and materializes every song before writing its
binary (DataManager.cpp:135-142, :304-344); this module bounds host memory
to O(chunk_rows):

pass 1  stream the CSV in `chunk_rows`-line chunks; parse + validate each
        chunk (the native C++ tokenizer, data/native_ingest.py, or under
        `use_native=False` the Python parse), carry the dense genre map
        across chunks (first-appearance order: the ids of a single-shot
        parse), accumulate global per-feature min/max over valid rows, and
        spill each chunk's validated columns to temporary .npz parts;
pass 2  with the global stats known, allocate the final memory-mapped
        arrays (np.lib.format.open_memmap) and fill them chunk by chunk:
        min-max normalize + genre feature (exact reference semantics,
        DataManager.cpp:287-301) + L2 norms.

The output is the ``dir-v1`` catalog directory (data/catalog.py
`Catalog.save_dir`), loaded back memory-mapped: no step holds more than
one chunk plus the output write window in RAM.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from spotify_recommender_tpu_torch.core.config import (
    CONSTANT_FEATURE_VALUE,
    MINMAX_RANGE_FLOOR,
)
from spotify_recommender_tpu_torch.core.logging import get_logger, PhaseTimer
from spotify_recommender_tpu_torch.data import csv_ingest
from spotify_recommender_tpu_torch.data.catalog import (
    CATALOG_FORMAT_VERSION,
    Catalog,
)
from spotify_recommender_tpu_torch.data.schema import FEATURE_COLUMNS

log = get_logger(__name__)


def iter_csv_chunks(
    csv_path: str, chunk_rows: int
) -> Iterator[Tuple[str, List[str]]]:
    """Yield (header_line, chunk_lines) with ≤ chunk_rows lines per chunk.

    Rows split on \\n ONLY (the reference's getline semantics, see
    csv_ingest.ingest_csv); ``newline=""`` disables Python's universal-
    newline translation so fields containing \\r/\\f/unicode separators
    survive intact, matching the single-shot parse byte for byte."""
    with open(csv_path, "r", encoding="utf-8", errors="replace",
              newline="") as f:
        header_parts: List[str] = []
        while True:
            piece = f.readline()
            header_parts.append(piece)
            if not piece or piece.endswith("\n"):
                break
        header = "".join(header_parts)
        if not header:
            raise ValueError(f"Empty CSV file: {csv_path}")
        chunk: List[str] = []
        buf: List[str] = []
        for piece in iter(f.readline, ""):
            buf.append(piece)
            if not piece.endswith("\n"):
                continue          # bare-\r "line": keep accumulating
            chunk.append("".join(buf).rstrip("\n"))
            buf = []
            if len(chunk) >= chunk_rows:
                yield header, chunk
                chunk = []
        if buf:
            chunk.append("".join(buf))
        if chunk:
            yield header, chunk


def _parse_chunk(header: str, lines: List[str],
                 genre_to_id: Dict[str, int], use_native: bool):
    """Parse one chunk, remapping genre ids onto the carried global map."""
    if not use_native:
        table = csv_ingest.parse_csv_rows(header, lines,
                                          genre_to_id=genre_to_id)
        return table, table.genre_ids
    from spotify_recommender_tpu_torch.data import native_ingest

    table = native_ingest.parse_csv_rows_native(header, lines)
    # chunk-local ids -> global first-appearance ids
    remap = np.empty(max(1, len(table.genre_names)), np.int32)
    for local_id, name in enumerate(table.genre_names):
        remap[local_id] = genre_to_id.setdefault(name, len(genre_to_id))
    gids = remap[table.genre_ids] if len(table.genre_ids) else table.genre_ids
    return table, gids


def preprocess_csv_streaming(
    csv_path: str,
    output_dir: str,
    chunk_rows: int = 200_000,
    use_native: bool = True,
    tmp_dir: Optional[str] = None,
) -> Catalog:
    """CSV → memory-mapped catalog directory with O(chunk_rows) host RAM.

    Returns the catalog loaded back memory-mapped.  Validation rules,
    genre-id order and the min-max + constant-feature + genre-feature math
    are bit-identical to data.catalog.preprocess_csv for any chunk_rows.
    """
    timer = PhaseTimer()
    nfeat = len(FEATURE_COLUMNS)
    genre_to_id: Dict[str, int] = {}
    work = tempfile.mkdtemp(prefix="catalog_chunks_", dir=tmp_dir)
    parts: List[dict] = []
    total_valid = 0
    total_input = 0
    gmin = np.full(nfeat, np.inf, np.float32)
    gmax = np.full(nfeat, -np.inf, np.float32)
    widths = {"track_ids": 1, "track_names": 1, "artists": 1}

    try:
        with timer.phase("pass1_parse"):
            for ci, (header, lines) in enumerate(
                iter_csv_chunks(csv_path, chunk_rows)
            ):
                table, gids = _parse_chunk(header, lines, genre_to_id,
                                           use_native)
                total_input += table.num_input_rows
                n = table.num_valid_rows
                if n:
                    gmin = np.minimum(
                        gmin, table.raw_features.min(axis=0)).astype(np.float32)
                    gmax = np.maximum(
                        gmax, table.raw_features.max(axis=0)).astype(np.float32)
                part = os.path.join(work, f"part{ci:06d}.npz")
                cols = {
                    "track_ids": np.asarray(table.track_ids, np.str_),
                    "track_names": np.asarray(table.track_names, np.str_),
                    "artists": np.asarray(table.artists, np.str_),
                }
                for name, arr in cols.items():
                    if n:
                        widths[name] = max(widths[name], arr.dtype.itemsize // 4)
                np.savez(
                    part,
                    raw_features=table.raw_features,
                    genre_ids=np.asarray(gids, np.int32),
                    **cols,
                )
                parts.append({"path": part, "rows": n, "offset": total_valid})
                total_valid += n

        if total_valid == 0:
            raise ValueError("No valid songs found in CSV")

        num_genres = len(genre_to_id)
        rng_ = gmax - gmin
        denom_genre = np.float32(max(1, num_genres - 1))

        with timer.phase("pass2_write"):
            os.makedirs(output_dir, exist_ok=True)

            def mm(name, dtype, shape):
                return np.lib.format.open_memmap(
                    os.path.join(output_dir, f"{name}.npy"),
                    mode="w+", dtype=dtype, shape=shape,
                )

            features = mm("features", np.float32, (total_valid, nfeat + 1))
            norms = mm("norms", np.float32, (total_valid,))
            genre_ids = mm("genre_ids", np.int32, (total_valid,))
            strings = {
                name: mm(name, np.dtype(f"<U{widths[name]}"), (total_valid,))
                for name in widths
            }
            for p in parts:
                n, off = p["rows"], p["offset"]
                if n == 0:
                    continue
                with np.load(p["path"], allow_pickle=False) as z:
                    raw = z["raw_features"].astype(np.float32)
                    gids = z["genre_ids"]
                    # exact reference math (DataManager.cpp:287-301)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        scaled = (raw - gmin[None, :]) / rng_[None, :]
                    audio = np.where(
                        rng_[None, :] > np.float32(MINMAX_RANGE_FLOOR),
                        scaled,
                        np.float32(CONSTANT_FEATURE_VALUE),
                    ).astype(np.float32)
                    gfeat = gids.astype(np.float32) / denom_genre
                    feats = np.concatenate([audio, gfeat[:, None]], axis=1)
                    sl = slice(off, off + n)
                    features[sl] = feats
                    norms[sl] = np.linalg.norm(feats, axis=1)
                    genre_ids[sl] = gids
                    for name, arr in strings.items():
                        arr[sl] = z[name]
            for arr in (features, norms, genre_ids, *strings.values()):
                arr.flush()
            del features, norms, genre_ids, strings
            np.save(os.path.join(output_dir, "min_vals.npy"), gmin)
            np.save(os.path.join(output_dir, "max_vals.npy"), gmax)
            meta = {
                "format_version": CATALOG_FORMAT_VERSION,
                "layout": "dir-v1",
                "feature_columns": list(FEATURE_COLUMNS) + ["genre"],
                "num_items": total_valid,
                "num_genres": num_genres,
                "genre_names": list(genre_to_id),
            }
            with open(os.path.join(output_dir, "meta.json"), "w") as f:
                json.dump(meta, f)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log.info(
        "streaming preprocess: %d/%d valid rows, %d genres, %d chunks (%s)",
        total_valid, total_input, len(genre_to_id), len(parts),
        timer.report(),
    )
    return Catalog.load_dir(output_dir)
