"""Feature schema: the 12-feature contract.

Re-states the reference data model (reference Song.h:12-19 and
DataManager.cpp:121-159) as data:

- 11 numeric audio features in a fixed order, min-max normalized;
- genre ordinally encoded as feature[11] = genre_id / max(1, G-1)
  (reference DataManager.cpp:299 — statistically dubious but part of the
  behavioral contract we reproduce for recall parity);
- musical-key and mode columns accept either symbolic or numeric encodings
  (reference DataManager.cpp:25-54).
"""

from __future__ import annotations

from typing import Optional

# Column order of the numeric features (reference DataManager.cpp:156-159).
FEATURE_COLUMNS = (
    "danceability",
    "energy",
    "key",
    "loudness",
    "mode",
    "speechiness",
    "acousticness",
    "instrumentalness",
    "liveness",
    "valence",
    "tempo",
)

# Required CSV columns (reference DataManager.cpp:121-125).
REQUIRED_COLUMNS = (
    "track_id",
    "track_name",
    "artists",
    *FEATURE_COLUMNS,
    "track_genre",
)

GENRE_COLUMN = "track_genre"

# Musical key notation → pitch class (reference DataManager.cpp:25-43).
_KEY_MAP = {
    "C": 0,
    "C#": 1, "DB": 1,
    "D": 2,
    "D#": 3, "EB": 3,
    "E": 4,
    "F": 5,
    "F#": 6, "GB": 6,
    "G": 7,
    "G#": 8, "AB": 8,
    "A": 9,
    "A#": 10, "BB": 10,
    "B": 11,
}


def key_to_number(key: str) -> int:
    """Symbolic musical key → 0-11, or -1 if not symbolic
    (reference DataManager.cpp:25-43)."""
    return _KEY_MAP.get(key.upper(), -1)


def mode_to_number(mode: str) -> int:
    """Mode string → Major=1 / Minor=0, or -1 (reference DataManager.cpp:46-54)."""
    m = mode.lower()
    if m in ("major", "1"):
        return 1
    if m in ("minor", "0"):
        return 0
    return -1


def parse_number(s: str) -> Optional[float]:
    """Emulate the reference's strtod-based full-string number check
    (reference DataManager.cpp:64-69): the whole string must parse.

    strtod accepts decimal/scientific notation, inf/nan, and C99 hex floats;
    Python's float() covers all but hex, which we handle explicitly.
    """
    if not s:
        return None
    # Python float() tolerates digit-group underscores and surrounding
    # whitespace; strtod with a full-consumption check does not.
    if "_" in s or s != s.strip():
        return None
    try:
        return float(s)
    except ValueError:
        pass
    t = s.strip()
    neg = t.startswith("-")
    if t.startswith(("+", "-")):
        t = t[1:]
    if t[:2].lower() == "0x":
        try:
            # strtod hex: optional binary exponent pN; float.fromhex requires
            # one, so append p0 when missing.
            if "p" not in t.lower():
                t += "p0"
            v = float.fromhex(t)
            return -v if neg else v
        except ValueError:
            return None
    return None
