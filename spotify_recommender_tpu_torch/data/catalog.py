"""Catalog artifact: the preprocessed item corpus.

Replacement for the reference's binary catalog
(reference DataManager.cpp:315-344 write, :363-409 read; per-song layout
Song.h:35-77).  The on-disk formats are the JAX package's, so artifacts
move freely between the two packages:

- versioned, endian-stable `.npz` container (format v1);
- L2 norms precomputed once at build time (the reference re-computed
  catalog norms on every query, Recommender.cu:228-252);
- readers/writers for the legacy ``songs_data.bin`` format.

The memory-mapped directory format is not ported yet (ROADMAP queue 1).
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
        self.features = np.ascontiguousarray(self.features, dtype=np.float32)
        if self.norms is None or len(self.norms) != len(self.features):
            self.norms = np.linalg.norm(self.features, axis=1).astype(np.float32)

    def __len__(self) -> int:
        return self.features.shape[0]

    def validate(self) -> None:
        """Fail-fast artifact validation: structural integrity on load."""
        n = len(self)
        problems = []
        for name in ("norms", "track_ids", "track_names", "artists", "genre_ids"):
            arr = getattr(self, name)
            if len(arr) != n:
                problems.append(f"{name} has {len(arr)} entries, expected {n}")
        if n and not np.isfinite(self.features).all():
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

    @classmethod
    def load(cls, path: str) -> "Catalog":
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is a catalog directory: the memory-mapped dir format "
                "is not ported yet (ROADMAP queue 1, data layer)"
            )
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta["format_version"] > CATALOG_FORMAT_VERSION:
                raise ValueError(
                    f"catalog {path} has format v{meta['format_version']}, "
                    f"this build reads <= v{CATALOG_FORMAT_VERSION}"
                )
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


def preprocess_csv(csv_path: str, output_path: Optional[str] = None) -> Catalog:
    """End-to-end preprocessing: CSV → validated rows → normalized catalog.

    Equivalent of reference ``DataManager::preprocessData``
    (DataManager.cpp:94-361).
    """
    timer = PhaseTimer()
    with timer.phase("ingest"):
        table = csv_ingest.ingest_csv(csv_path)
    if table.num_valid_rows == 0:
        raise ValueError("No valid songs found in CSV")
    with timer.phase("normalize"):
        cat = from_raw_table(table)
    if output_path:
        with timer.phase("save"):
            cat.save(output_path)
    log.info("preprocess complete (%s)", timer.report())
    return cat
