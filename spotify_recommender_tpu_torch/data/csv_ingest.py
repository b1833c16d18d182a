"""CSV ingest: quote-aware parsing + per-row validation.

Behavior-compatible rebuild of the reference's preprocessing front half
(reference DataManager.cpp:94-253):

- UTF-8 BOM stripped from the header (reference DataManager.cpp:14-22);
- quote-aware field splitting where `"` toggles quoting and is dropped from
  the field, fields trimmed of " \\t\\r\\n" (reference DataManager.cpp:72-92);
- rows with fewer fields than the header are skipped
  (reference DataManager.cpp:172-174);
- empty track_id / track_name invalidate the row (DataManager.cpp:184-186);
- key / mode accept symbolic or numeric values (DataManager.cpp:194-219);
- other features must be fully-parsable numbers (DataManager.cpp:222-227);
- empty genre invalidates the row (DataManager.cpp:232-234);
- genre string → dense int id in deterministic first-appearance order among
  valid rows (the reference assigns ids under an `omp critical`, so its ids
  depend on thread interleaving, DataManager.cpp:244-251).

This is the pure-Python parse path of the JAX package's module; the native
C++ tokenizer binding is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from spotify_recommender_tpu_torch.core.logging import get_logger, PhaseTimer
from spotify_recommender_tpu_torch.data.schema import (
    FEATURE_COLUMNS,
    GENRE_COLUMN,
    REQUIRED_COLUMNS,
    key_to_number,
    mode_to_number,
    parse_number,
)

log = get_logger(__name__)

_TRIM_CHARS = " \t\r\n"


def strip_bom(s: str) -> str:
    """Drop a UTF-8 BOM (reference DataManager.cpp:14-22)."""
    return s[1:] if s.startswith("﻿") else s


def parse_csv_line(line: str) -> List[str]:
    """Split one CSV line the way the reference does
    (reference DataManager.cpp:72-92): `"` toggles quoting and is removed;
    commas split only outside quotes; each field is trimmed.
    """
    if '"' not in line:
        return [f.strip(_TRIM_CHARS) for f in line.split(",")]
    fields: List[str] = []
    current: List[str] = []
    in_quotes = False
    for c in line:
        if c == '"':
            in_quotes = not in_quotes
        elif c == "," and not in_quotes:
            fields.append("".join(current).strip(_TRIM_CHARS))
            current = []
        else:
            current.append(c)
    fields.append("".join(current).strip(_TRIM_CHARS))
    return fields


@dataclasses.dataclass
class RawTable:
    """Validated, un-normalized rows (pre-normalization stage output)."""

    track_ids: np.ndarray      # (N,) unicode
    track_names: np.ndarray    # (N,) unicode
    artists: np.ndarray        # (N,) unicode
    raw_features: np.ndarray   # (N, 11) float32 — FEATURE_COLUMNS order
    genre_ids: np.ndarray      # (N,) int32
    genre_names: List[str]     # dense id → name, first-appearance order
    num_input_rows: int
    num_valid_rows: int


def _feature_value(col: str, value: str) -> Optional[float]:
    """Extract one feature with the reference's key/mode special-casing
    (reference DataManager.cpp:189-228)."""
    if col == "key":
        k = key_to_number(value)
        if k >= 0:
            return float(k)
        return parse_number(value)
    if col == "mode":
        m = mode_to_number(value)
        if m >= 0:
            return float(m)
        return parse_number(value)
    return parse_number(value)


def parse_csv_rows(
    header_line: str,
    data_lines: Sequence[str],
    genre_to_id: Optional[Dict[str, int]] = None,
) -> RawTable:
    """Parse + validate rows. Raises ValueError on missing required columns
    (reference DataManager.cpp:127-132).

    `genre_to_id` carries the dense genre map across streamed chunks
    (mutated in place); first-appearance order is then global across the
    whole stream, identical to a single-shot parse."""
    header = parse_csv_line(strip_bom(header_line))
    column_map: Dict[str, int] = {name: i for i, name in enumerate(header)}
    missing = [c for c in REQUIRED_COLUMNS if c not in column_map]
    if missing:
        raise ValueError(f"Required column(s) not found in CSV: {missing}")

    n_header = len(header)
    feat_idx = [column_map[c] for c in FEATURE_COLUMNS]
    id_idx = column_map["track_id"]
    name_idx = column_map["track_name"]
    artists_idx = column_map["artists"]
    genre_idx = column_map[GENRE_COLUMN]

    track_ids: List[str] = []
    track_names: List[str] = []
    artists: List[str] = []
    feats: List[List[float]] = []
    genres: List[str] = []

    n_input = 0
    for line in data_lines:
        if not line:
            continue  # reference skips empty lines pre-parse (DataManager.cpp:138)
        n_input += 1
        fields = parse_csv_line(line)
        if len(fields) < n_header:
            continue
        tid = fields[id_idx]
        tname = fields[name_idx]
        if not tid or not tname:
            continue
        row = []
        valid = True
        for col, fi in zip(FEATURE_COLUMNS, feat_idx):
            v = _feature_value(col, fields[fi])
            if v is None:
                valid = False
                break
            row.append(v)
        if not valid:
            continue
        genre = fields[genre_idx]
        if not genre:
            continue
        track_ids.append(tid)
        track_names.append(tname)
        artists.append(fields[artists_idx])
        feats.append(row)
        genres.append(genre)

    # Dense genre ids in deterministic first-appearance order.
    if genre_to_id is None:
        genre_to_id = {}
    genre_ids = np.empty(len(genres), dtype=np.int32)
    for i, g in enumerate(genres):
        gid = genre_to_id.get(g)
        if gid is None:
            gid = len(genre_to_id)
            genre_to_id[g] = gid
        genre_ids[i] = gid

    raw = (
        np.asarray(feats, dtype=np.float32)
        if feats
        else np.zeros((0, len(FEATURE_COLUMNS)), dtype=np.float32)
    )
    return RawTable(
        track_ids=np.asarray(track_ids, dtype=object),
        track_names=np.asarray(track_names, dtype=object),
        artists=np.asarray(artists, dtype=object),
        raw_features=raw,
        genre_ids=genre_ids,
        genre_names=list(genre_to_id),
        num_input_rows=n_input,
        num_valid_rows=len(track_ids),
    )


def ingest_csv(csv_path: str) -> RawTable:
    """Read + parse a CSV file end-to-end."""
    timer = PhaseTimer()
    with timer.phase("read"):
        with open(csv_path, "r", encoding="utf-8", errors="replace",
                  newline="") as f:
            content = f.read()
        if not content:
            raise ValueError(f"Empty CSV file: {csv_path}")
        # split on \n ONLY (the reference's getline semantics,
        # DataManager.cpp:135-142): str.splitlines()/readline would also
        # break rows at form feeds, unicode line separators, and bare \r,
        # silently truncating fields that legitimately contain those
        # characters; trailing \r from CRLF files is trimmed per field
        # (reference trim, :57-62)
        nl = content.find("\n")
        if nl < 0:
            header_line, lines = content, []
        else:
            header_line = content[:nl]
            lines = content[nl + 1 :].split("\n")
    with timer.phase("parse"):
        table = parse_csv_rows(header_line, lines)
    log.info(
        "ingest: %d/%d valid rows, %d genres (%s)",
        table.num_valid_rows,
        table.num_input_rows,
        len(table.genre_names),
        timer.report(),
    )
    return table
