"""The port's data layer against the JAX package: CSV ingest, normalization
and the catalog formats, on the same files."""

import numpy as np
import pytest
import torch

from conftest import make_messy_songs_csv, make_songs_csv

from spotify_recommender_tpu.data import catalog as jcat
from spotify_recommender_tpu.data import normalize as jnorm
from spotify_recommender_tpu_torch.data import catalog as tcat
from spotify_recommender_tpu_torch.data import normalize as tnorm


def _assert_same_catalog(a, b):
    # the same numpy pipeline on the same parsed rows: bitwise
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.norms, b.norms)
    np.testing.assert_array_equal(a.genre_ids, b.genre_ids)
    assert list(a.genre_names) == list(b.genre_names)
    for name in ("track_ids", "track_names", "artists"):
        assert [str(x) for x in getattr(a, name)] == [
            str(x) for x in getattr(b, name)
        ], name


@pytest.mark.parametrize("messy", [False, True])
def test_preprocess_csv_matches_jax(tmp_path, messy):
    path = tmp_path / "songs.csv"
    if messy:
        make_messy_songs_csv(path, n_clean=300)
    else:
        make_songs_csv(path, n_rows=300, n_genres=7, seed=3)
    _assert_same_catalog(
        tcat.preprocess_csv(str(path)), jcat.preprocess_csv(str(path))
    )


@pytest.fixture
def both(tmp_path):
    path = make_songs_csv(tmp_path / "songs.csv", n_rows=120, seed=9)
    return tcat.preprocess_csv(str(path)), jcat.preprocess_csv(str(path))


@pytest.mark.parametrize("fmt", ["npz", "bin"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_catalog_files_cross_load(tmp_path, both, fmt, writer):
    """A file written by either package loads in the other."""
    t, j = both
    path = str(tmp_path / f"cat.{fmt}")
    src = t if writer == "torch" else j
    if fmt == "npz":
        src.save(path)
        loaded = [tcat.Catalog.load(path), jcat.Catalog.load(path)]
    else:
        src.save_reference_binary(path)
        loaded = [
            tcat.Catalog.load_reference_binary(path),
            jcat.Catalog.load_reference_binary(path),
        ]
    for cat in loaded:
        _assert_same_catalog(cat, src)


def test_catalog_dir_format_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcat.Catalog.load(str(tmp_path))


def _ulp_diff(a, b):
    """Distance in fp32 units in the last place (same-sign finite values)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def test_minmax_normalize_within_one_ulp():
    rng = np.random.default_rng(1)
    raw = (rng.random((500, 11)) * [1, 1, 11, 60, 1, 1, 1, 1, 1, 1, 180]).astype(
        np.float32
    )
    raw[:, 4] = 1.0                                  # constant feature -> 0.5
    mn, mx = raw.min(axis=0), raw.max(axis=0)
    got = tnorm.minmax_normalize(
        torch.from_numpy(raw), torch.from_numpy(mn), torch.from_numpy(mx)
    ).numpy()
    want = np.asarray(jnorm.minmax_normalize(raw, mn, mx))
    # XLA may lower the division as reciprocal-multiply: 1 ulp
    assert _ulp_diff(got, want).max() <= 1
    np.testing.assert_array_equal(got[:, 4], 0.5)


@pytest.mark.parametrize("num_genres", [1, 2, 114])
def test_encode_genre_feature_within_one_ulp(num_genres):
    ids = np.arange(num_genres, dtype=np.int32)
    got = tnorm.encode_genre_feature(torch.from_numpy(ids), num_genres).numpy()
    want = np.asarray(jnorm.encode_genre_feature(ids, num_genres))
    assert _ulp_diff(got, want).max() <= 1
