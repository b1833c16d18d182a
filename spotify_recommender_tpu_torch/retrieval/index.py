"""Query resolution: track-id and name → catalog row.

Replaces the reference's per-query O(N) linear scans
(reference Recommender.cu:320-327 by id, :336-354 by name) with a hash map
for ids, a hash map for exact (lowercased) names, and a vectorized numpy
substring scan.  Semantics preserved exactly:

- id lookup: exact string match; first occurrence wins for duplicate ids
  (the reference scan returns the first hit);
- name lookup: case-insensitive exact match first, then substring match,
  each returning the lowest matching row (reference Recommender.cu:339-352).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class CatalogIndex:
    def __init__(self, track_ids: np.ndarray, track_names: np.ndarray) -> None:
        self._id_to_row: Dict[str, int] = {}
        # first occurrence wins, matching the reference's forward scan
        for i, tid in enumerate(track_ids):
            self._id_to_row.setdefault(str(tid), i)
        lower = [str(n).lower() for n in track_names]
        # exact-name hash map (first occurrence wins, like the id map)
        self._name_to_row: Dict[str, int] = {}
        for i, n in enumerate(lower):
            self._name_to_row.setdefault(n, i)
        # fixed-width unicode array: np.char.find vectorizes the substring
        # pass (C-speed scan instead of a Python loop per catalog row)
        self._lower_names = np.asarray(lower, dtype=np.str_)

    def find_by_track_id(self, track_id: str) -> Optional[int]:
        return self._id_to_row.get(track_id)

    def find_by_name(self, name: str) -> Optional[int]:
        q = name.lower()
        # pass 1: case-insensitive exact match (reference Recommender.cu:339-345)
        row = self._name_to_row.get(q)
        if row is not None:
            return row
        if not q:
            # empty query: exact pass missed only if no empty name exists;
            # substring "" matches everything → lowest row, i.e. row 0 if
            # the catalog is non-empty (mirrors the reference's strstr("")).
            return 0 if self._lower_names.size else None
        # pass 2: substring match, lowest row wins (reference :347-352)
        hits = np.char.find(self._lower_names, q) >= 0
        idx = np.argmax(hits)
        if hits[idx]:
            return int(idx)
        return None
