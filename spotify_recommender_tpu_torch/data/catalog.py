"""Catalog artifact: the preprocessed item corpus.

Replacement for the reference's binary catalog
(reference DataManager.cpp:315-344 write, :363-409 read; per-song layout
Song.h:35-77).  The on-disk formats are the JAX package's, so artifacts
move freely between the two packages:

- versioned, endian-stable `.npz` container (format v1);
- L2 norms precomputed once at build time (the reference re-computed
  catalog norms on every query, Recommender.cu:228-252);
- the memory-mapped directory format ``dir-v1`` (one ``.npy`` per column
  + ``meta.json``), which loads in O(1) of the catalog size;
- readers/writers for the legacy ``songs_data.bin`` format.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from spotify_recommender_tpu_torch.core.logging import get_logger, PhaseTimer
from spotify_recommender_tpu_torch.data import csv_ingest
from spotify_recommender_tpu_torch.data.csv_ingest import RawTable
from spotify_recommender_tpu_torch.data.normalize import build_feature_matrix
from spotify_recommender_tpu_torch.data.schema import FEATURE_COLUMNS

log = get_logger(__name__)

CATALOG_FORMAT_VERSION = 1


@dataclasses.dataclass
class Catalog:
    """Item catalog on the host.

    ``features`` carries the exact reference feature semantics; ``norms``
    holds per-row L2 norms so cosine scoring never recomputes them.
    """

    features: np.ndarray      # (N, F) float32, reference-normalized features
    norms: np.ndarray         # (N,) float32 L2 norms of feature rows
    track_ids: np.ndarray     # (N,) str
    track_names: np.ndarray   # (N,) str
    artists: np.ndarray       # (N,) str
    genre_ids: np.ndarray     # (N,) int32
    genre_names: List[str]    # dense id → genre name
    min_vals: np.ndarray      # (F-1,) fp32 per-feature min (for re-featurizing)
    max_vals: np.ndarray      # (F-1,) fp32 per-feature max

    def __post_init__(self) -> None:
        f = self.features
        if not (isinstance(f, np.ndarray) and f.dtype == np.float32
                and f.flags["C_CONTIGUOUS"]):
            # conformant arrays, read-only memmaps of the directory format
            # among them, are kept as they are: no copy on load
            self.features = np.ascontiguousarray(f, dtype=np.float32)
        if self.norms is None or len(self.norms) != len(self.features):
            self.norms = np.linalg.norm(self.features, axis=1).astype(np.float32)

    def __len__(self) -> int:
        return self.features.shape[0]

    def validate(self, sample: Optional[int] = None) -> None:
        """Fail-fast artifact validation: structural integrity on load.

        With `sample`, the finite-values check reads only the first and
        last `sample` rows, so a memory-mapped catalog is not paged in
        whole on load."""
        n = len(self)
        problems = []
        for name in ("norms", "track_ids", "track_names", "artists", "genre_ids"):
            arr = getattr(self, name)
            if len(arr) != n:
                problems.append(f"{name} has {len(arr)} entries, expected {n}")
        if n:
            if sample is None or 2 * sample >= n:
                finite = np.isfinite(self.features).all()
            else:
                finite = (np.isfinite(self.features[:sample]).all()
                          and np.isfinite(self.features[-sample:]).all())
            if not finite:
                problems.append("features contain non-finite values")
        if n and self.genre_ids.size:
            gmax = int(self.genre_ids.max())
            if gmax >= len(self.genre_names):
                problems.append(
                    f"genre_id {gmax} out of range ({len(self.genre_names)} genres)"
                )
        if problems:
            raise ValueError("corrupt catalog: " + "; ".join(problems))

    @property
    def num_genres(self) -> int:
        return len(self.genre_names)

    def genre_of(self, row: int) -> str:
        return self.genre_names[int(self.genre_ids[row])]

    # ------------------------------------------------------------------ npz io

    def save(self, path: str) -> None:
        meta = {
            "format_version": CATALOG_FORMAT_VERSION,
            "feature_columns": list(FEATURE_COLUMNS) + ["genre"],
            "num_items": len(self),
            "num_genres": self.num_genres,
        }
        np.savez_compressed(
            path,
            features=self.features,
            norms=self.norms,
            track_ids=self.track_ids.astype(np.str_),
            track_names=self.track_names.astype(np.str_),
            artists=self.artists.astype(np.str_),
            genre_ids=self.genre_ids.astype(np.int32),
            genre_names=np.asarray(self.genre_names, dtype=np.str_),
            min_vals=self.min_vals,
            max_vals=self.max_vals,
            meta=np.asarray(json.dumps(meta)),
        )
        log.info("catalog saved: %s (%d items, %d genres)", path, len(self), self.num_genres)

    # --------------------------------------------- directory (memmap) io

    _DIR_ARRAYS = (
        "features", "norms", "track_ids", "track_names", "artists",
        "genre_ids", "min_vals", "max_vals",
    )

    def save_dir(self, path: str) -> None:
        """Write the memory-mappable directory format ``dir-v1``: one
        uncompressed ``.npy`` per column + ``meta.json``, the JAX package's
        layout byte for byte, so each package reads the other's."""
        os.makedirs(path, exist_ok=True)
        arrays = {
            "features": self.features,
            "norms": self.norms,
            "track_ids": np.asarray(self.track_ids, dtype=np.str_),
            "track_names": np.asarray(self.track_names, dtype=np.str_),
            "artists": np.asarray(self.artists, dtype=np.str_),
            "genre_ids": self.genre_ids.astype(np.int32),
            "min_vals": self.min_vals,
            "max_vals": self.max_vals,
        }
        for name in self._DIR_ARRAYS:
            np.save(os.path.join(path, f"{name}.npy"), arrays[name])
        meta = {
            "format_version": CATALOG_FORMAT_VERSION,
            "layout": "dir-v1",
            "feature_columns": list(FEATURE_COLUMNS) + ["genre"],
            "num_items": len(self),
            "num_genres": self.num_genres,
            "genre_names": list(self.genre_names),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        log.info("catalog saved (dir/memmap): %s (%d items, %d genres)",
                 path, len(self), self.num_genres)

    @classmethod
    def load_dir(cls, path: str, mmap: bool = True) -> "Catalog":
        """Load the directory format; with `mmap` (default) every array is
        memory-mapped read-only and validation samples rows, so nothing is
        read in bulk and catalogs larger than RAM load."""
        meta = read_dir_meta(path)
        if meta.get("layout") != "dir-v1":
            raise ValueError(
                f"{path}: layout {meta.get('layout')!r} is not a dir-v1 catalog"
            )
        _check_version(path, meta)
        arrays = {
            name: np.load(os.path.join(path, f"{name}.npy"),
                          mmap_mode="r" if mmap else None, allow_pickle=False)
            for name in cls._DIR_ARRAYS
        }
        cat = cls(genre_names=[str(g) for g in meta["genre_names"]], **arrays)
        cat.validate(sample=4096 if mmap else None)
        log.info("catalog loaded (dir%s): %s (%d items)",
                 "/memmap" if mmap else "", path, len(cat))
        return cat

    @classmethod
    def load(cls, path: str) -> "Catalog":
        if os.path.isdir(path):
            return cls.load_dir(path)
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            _check_version(path, meta)
            cat = cls(
                features=z["features"],
                norms=z["norms"],
                track_ids=z["track_ids"].astype(object),
                track_names=z["track_names"].astype(object),
                artists=z["artists"].astype(object),
                genre_ids=z["genre_ids"],
                genre_names=[str(g) for g in z["genre_names"]],
                min_vals=z["min_vals"],
                max_vals=z["max_vals"],
            )
        cat.validate()
        log.info("catalog loaded: %s (%d items)", path, len(cat))
        return cat

    # -------------------------------------------- legacy binary interop

    @classmethod
    def load_reference_binary(cls, path: str) -> "Catalog":
        """Read the reference's ``songs_data.bin``
        (layout: DataManager.cpp:315-344 + Song.h:35-54; platform size_t,
        which is 8-byte little-endian on the x86-64 the reference targets).
        """
        with open(path, "rb") as f:
            data = f.read()
        off = 0

        def u64() -> int:
            nonlocal off
            (v,) = struct.unpack_from("<Q", data, off)
            off += 8
            return v

        def i32() -> int:
            nonlocal off
            (v,) = struct.unpack_from("<i", data, off)
            off += 4
            return v

        def string(n: int) -> str:
            nonlocal off
            s = data[off : off + n].decode("utf-8", errors="replace")
            off += n
            return s

        num_songs = u64()
        num_genres = u64()
        genre_map: Dict[int, str] = {}
        for _ in range(num_genres):
            gid = i32()
            genre_map[gid] = string(u64())
        ids, names, artists = [], [], []
        genre_ids = np.empty(num_songs, dtype=np.int32)
        feats = np.empty((num_songs, 12), dtype=np.float32)
        for i in range(num_songs):
            ids.append(string(u64()))
            names.append(string(u64()))
            artists.append(string(u64()))
            genre_ids[i] = i32()
            feats[i] = np.frombuffer(data, dtype="<f4", count=12, offset=off)
            off += 48
        genre_names = [genre_map.get(i, "") for i in range(num_genres)]
        return cls(
            features=feats,
            norms=np.linalg.norm(feats, axis=1).astype(np.float32),
            track_ids=np.asarray(ids, dtype=object),
            track_names=np.asarray(names, dtype=object),
            artists=np.asarray(artists, dtype=object),
            genre_ids=genre_ids,
            genre_names=genre_names,
            min_vals=np.zeros(11, np.float32),
            max_vals=np.ones(11, np.float32),
        )

    def save_reference_binary(self, path: str) -> None:
        """Write the legacy format for consumers of the reference binary."""
        buf = io.BytesIO()
        buf.write(struct.pack("<Q", len(self)))
        buf.write(struct.pack("<Q", self.num_genres))
        for gid, name in enumerate(self.genre_names):
            b = name.encode("utf-8")
            buf.write(struct.pack("<i", gid))
            buf.write(struct.pack("<Q", len(b)))
            buf.write(b)
        for i in range(len(self)):
            for s in (self.track_ids[i], self.track_names[i], self.artists[i]):
                b = str(s).encode("utf-8")
                buf.write(struct.pack("<Q", len(b)))
                buf.write(b)
            buf.write(struct.pack("<i", int(self.genre_ids[i])))
            buf.write(self.features[i].astype("<f4").tobytes())
        with open(path, "wb") as f:
            f.write(buf.getvalue())


def load_catalog(path: str) -> Catalog:
    """A catalog artifact by its path: the reference's `.bin`, else what
    `Catalog.load` reads (npz or a catalog directory)."""
    if path.endswith(".bin"):
        return Catalog.load_reference_binary(path)
    return Catalog.load(path)


def read_dir_meta(path: str) -> dict:
    """``meta.json`` of a catalog directory: ``layout`` is ``dir-v1`` for
    this package's memory-mapped format, ``ocdbt-v1`` for the JAX package's
    sharded artifact."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _check_version(path: str, meta: dict) -> None:
    if meta["format_version"] > CATALOG_FORMAT_VERSION:
        raise ValueError(
            f"catalog {path} has format v{meta['format_version']}, "
            f"this build reads <= v{CATALOG_FORMAT_VERSION}"
        )


def from_raw_table(table: RawTable) -> Catalog:
    """RawTable (parsed CSV) → normalized Catalog."""
    feats, min_vals, max_vals = build_feature_matrix(
        table.raw_features, table.genre_ids, len(table.genre_names)
    )
    return Catalog(
        features=feats,
        norms=np.linalg.norm(feats, axis=1).astype(np.float32),
        track_ids=table.track_ids,
        track_names=table.track_names,
        artists=table.artists,
        genre_ids=table.genre_ids,
        genre_names=table.genre_names,
        min_vals=min_vals,
        max_vals=max_vals,
    )


def preprocess_csv(
    csv_path: str, output_path: Optional[str] = None, use_native: bool = True
) -> Catalog:
    """End-to-end preprocessing: CSV → validated rows → normalized catalog.

    Equivalent of reference ``DataManager::preprocessData``
    (DataManager.cpp:94-361); `use_native` picks the parse
    (`csv_ingest.ingest_csv`).
    """
    timer = PhaseTimer()
    with timer.phase("ingest"):
        table = csv_ingest.ingest_csv(csv_path, use_native=use_native)
    if table.num_valid_rows == 0:
        raise ValueError("No valid songs found in CSV")
    with timer.phase("normalize"):
        cat = from_raw_table(table)
    if output_path:
        with timer.phase("save"):
            cat.save(output_path)
    log.info("preprocess complete (%s)", timer.report())
    return cat
