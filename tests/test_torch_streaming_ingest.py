"""The port's streaming (bounded-RAM) preprocessing
(data/streaming.py) against the JAX package's `preprocess_csv_streaming`
(called with `use_native=False`, its Python parse) and against the port's
single-shot `preprocess_csv`: bitwise equal arrays and equal strings for
every chunk size, with the native and the Python parse per chunk."""

import json

import numpy as np
import pytest

from conftest import make_messy_songs_csv

from spotify_recommender_tpu.data.streaming import (
    iter_csv_chunks as jax_chunks,
    preprocess_csv_streaming as jax_streaming,
)
from spotify_recommender_tpu_torch.data.catalog import Catalog, preprocess_csv
from spotify_recommender_tpu_torch.data.streaming import (
    iter_csv_chunks,
    preprocess_csv_streaming,
)

ARRAYS = ("features", "norms", "genre_ids", "min_vals", "max_vals")
STRINGS = ("track_ids", "track_names", "artists")


@pytest.fixture(scope="module")
def messy(tmp_path_factory):
    path, n = make_messy_songs_csv(
        tmp_path_factory.mktemp("stream") / "m.csv", n_clean=150, seed=4)
    return str(path), n


def assert_catalogs_equal(a, b):
    assert len(a) == len(b)
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in STRINGS:
        assert [str(s) for s in getattr(a, name)] == \
            [str(s) for s in getattr(b, name)], name
    assert a.genre_names == b.genre_names


@pytest.mark.parametrize("chunk_rows", [1, 7, 64, None])
def test_equals_jax_streaming_and_single_shot(messy, tmp_path, chunk_rows):
    path, n = messy
    chunk = chunk_rows or 10_000          # None: one chunk holds every row
    ref = preprocess_csv(path, use_native=False)
    jax_cat = jax_streaming(path, str(tmp_path / "jax"), chunk_rows=chunk,
                            use_native=False)
    for use_native in (True, False):
        out = tmp_path / f"torch_{use_native}"
        cat = preprocess_csv_streaming(path, str(out), chunk_rows=chunk,
                                       use_native=use_native)
        assert len(cat) == n
        assert_catalogs_equal(cat, ref)
        assert_catalogs_equal(cat, jax_cat)
        # the directories are the JAX package's, file for file
        for name in ARRAYS + STRINGS:
            a = np.load(out / f"{name}.npy")
            b = np.load(tmp_path / "jax" / f"{name}.npy")
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert (json.loads((out / "meta.json").read_text())
                == json.loads((tmp_path / "jax" / "meta.json").read_text()))


def test_chunks_equal_jax_chunks(messy):
    path, _ = messy
    for size in (1, 7, 64):
        assert list(iter_csv_chunks(path, size)) == list(jax_chunks(path, size))
        assert all(len(lines) <= size for _, lines in iter_csv_chunks(path, size))


def test_empty_csv_raises(tmp_path):
    p = tmp_path / "empty.csv"
    p.write_text("")
    with pytest.raises(ValueError, match="Empty CSV"):
        list(iter_csv_chunks(str(p), 10))


def test_no_valid_rows_raises(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("track_id,track_name,artists,danceability,energy,key,"
                 "loudness,mode,speechiness,acousticness,instrumentalness,"
                 "liveness,valence,tempo,track_genre\nshort,row\n")
    with pytest.raises(ValueError, match="No valid songs"):
        preprocess_csv_streaming(str(p), str(tmp_path / "out"), chunk_rows=4)


def test_output_is_memory_mapped_and_work_dir_removed(messy, tmp_path):
    path, _ = messy
    work = tmp_path / "spill"
    work.mkdir()
    cat = preprocess_csv_streaming(path, str(tmp_path / "cat"), chunk_rows=16,
                                   tmp_dir=str(work))
    assert isinstance(cat.features, np.memmap)
    assert list(work.iterdir()) == []     # the chunk parts are gone
    again = Catalog.load(str(tmp_path / "cat"))
    np.testing.assert_array_equal(again.features, cat.features)
