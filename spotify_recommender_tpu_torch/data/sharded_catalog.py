"""Sharded catalog artifact: per-shard ``.npy`` files for catalogs beyond
one device's (or one host's) memory.

The port of the JAX package's `data/sharded_catalog.py`.  The single-host
formats (data/catalog.py: npz, the ``dir-v1`` memmap directory, the
legacy ``songs_data.bin``) assume one process can hold or map the whole
feature matrix; a sharded artifact lets each process read only its row
shards.  The JAX package stores the numeric columns in orbax's OCDBT
TensorStore format (layout ``ocdbt-v1``), which this package does not
read; the port's layout ``npy-shards-v1`` stores each numeric column
(features, norms, genre_ids) as `files` equal row blocks, one ``.npy``
each (``features-00003.npy``), that load as read-only memmaps:
`load_sharded_catalog(path, mesh)` opens them, and `shard(c, S)` reads
only shard c's rows of them.  The sidecar is the JAX package's: a
``meta.json`` and the string columns (track ids / names / artists) and
min / max values as ``.npy``, host-side lookup data that never reaches a
device.

Rows are zero-padded at save time to a multiple of `shard_multiple`, so
any mesh axis dividing the padded row count shards it; ``num_items`` in
the sidecar is the true row count, and pad rows (zero features and norms)
are masked by each shard's valid count downstream.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from spotify_recommender_tpu_torch.core.logging import get_logger

log = get_logger(__name__)

SHARDED_FORMAT_VERSION = 1
LAYOUT = "npy-shards-v1"
_NUMERIC = {"features": np.float32, "norms": np.float32, "genre_ids": np.int32}
MAX_FILES = 8


def _file(path: str, name: str, j: int) -> str:
    return os.path.join(path, f"{name}-{j:05d}.npy")


def save_sharded_catalog(catalog, path: str, shard_multiple: int = 4096) -> None:
    """Write the sharded artifact and its sidecar.

    `catalog` is a data.catalog.Catalog.  The numeric columns are zero-
    padded to a multiple of `shard_multiple` rows and written as up to
    MAX_FILES equal row blocks per column; strings and scalars go to the
    sidecar."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    n = len(catalog)
    padded = -(-n // shard_multiple) * shard_multiple
    files = next(m for m in (MAX_FILES, 4, 2, 1) if padded % m == 0)
    block = padded // files
    for name, dtype in _NUMERIC.items():
        col = np.asarray(getattr(catalog, name), dtype)
        for j in range(files):
            part = col[j * block:min((j + 1) * block, n)]
            if part.shape[0] < block:
                part = np.concatenate([part, np.zeros(
                    (block - part.shape[0],) + col.shape[1:], dtype)])
            np.save(_file(path, name, j), part)
    for name in ("track_ids", "track_names", "artists"):
        np.save(os.path.join(path, f"{name}.npy"),
                np.asarray(getattr(catalog, name), dtype=np.str_))
    np.save(os.path.join(path, "min_vals.npy"), catalog.min_vals)
    np.save(os.path.join(path, "max_vals.npy"), catalog.max_vals)
    meta = {
        "format_version": SHARDED_FORMAT_VERSION,
        "layout": LAYOUT,
        "num_items": n,
        "padded_rows": padded,
        "feature_dim": int(catalog.features.shape[1]),
        "shard_multiple": shard_multiple,
        "files": files,
        "num_genres": catalog.num_genres,
        "genre_names": list(catalog.genre_names),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    log.info("sharded catalog saved: %s (%d items -> %d padded rows, %d "
             "files per column)", path, n, padded, files)


class ShardedCatalogArtifact:
    """An opened sharded artifact: the numeric columns as read-only
    memmaps of their row blocks (nothing read until a shard's rows are
    taken) and the host metadata.  `num_items` is the true row count
    (<= `padded_rows`)."""

    def __init__(self, meta: dict, path: str) -> None:
        self.meta = meta
        self.num_items = meta["num_items"]
        self.padded_rows = meta["padded_rows"]
        self.feature_dim = meta["feature_dim"]
        self.genre_names = [str(g) for g in meta["genre_names"]]
        self._path = path
        self._block = self.padded_rows // meta["files"]
        self._maps = {
            name: [np.load(_file(path, name, j), mmap_mode="r")
                   for j in range(meta["files"])]
            for name in _NUMERIC
        }

    def __len__(self) -> int:
        return self.num_items

    def rows(self, name: str, start: int, stop: int) -> np.ndarray:
        """Rows [start, stop) of a numeric column: a memmap view where one
        block holds them, else the blocks' pieces joined (a copy of those
        rows only)."""
        parts = []
        for j in range(start // self._block, -(-stop // self._block)):
            a = max(start, j * self._block) - j * self._block
            b = min(stop, (j + 1) * self._block) - j * self._block
            parts.append(self._maps[name][j][a:b])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def shard(self, c: int, n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
        """(features (rows/S, F), norms) of row shard c of S."""
        n_local = self.padded_rows // n_shards
        lo, hi = c * n_local, (c + 1) * n_local
        return self.rows("features", lo, hi), self.rows("norms", lo, hi)

    def host_column(self, name: str) -> np.ndarray:
        """A sidecar column (track_ids, track_names, artists, min_vals,
        max_vals), read on demand: query resolution and display only."""
        return np.load(os.path.join(self._path, f"{name}.npy"),
                       allow_pickle=False)


def load_sharded_catalog(path: str, mesh=None,
                         axis_name: str = "catalog") -> ShardedCatalogArtifact:
    """Open the artifact.  With a mesh, its axis must divide the padded
    rows; each process then reads only its shards' rows (`shard`).  The
    JAX package's ``ocdbt-v1`` artifact raises ValueError."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("layout") != LAYOUT:
        raise ValueError(
            f"{path}: catalog layout {meta.get('layout')!r} is not ported "
            f"(this package reads {LAYOUT!r}; write one with preprocess "
            "--format sharded)"
        )
    if meta["format_version"] > SHARDED_FORMAT_VERSION:
        raise ValueError(
            f"sharded catalog {path} has format v{meta['format_version']}, "
            f"this build reads <= v{SHARDED_FORMAT_VERSION}"
        )
    if mesh is not None:
        n_shards = mesh.shape[axis_name]
        if meta["padded_rows"] % n_shards:
            raise ValueError(
                f"padded rows {meta['padded_rows']} not divisible by mesh "
                f"axis {axis_name}={n_shards}; re-save with shard_multiple a "
                "multiple of it"
            )
    art = ShardedCatalogArtifact(meta, path)
    log.info("sharded catalog opened: %s (%d items%s)", path, len(art),
             f", {axis_name} x{mesh.shape[axis_name]}" if mesh is not None
             else "")
    return art
