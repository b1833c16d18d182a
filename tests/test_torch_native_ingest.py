"""The port's native CSV parse (data/native_ingest.py, g++ over
native/csv_parser.cpp) against the JAX package's Python parse
(`csv_ingest.parse_csv_rows`), on every edge case of
tests/test_native_ingest.py: the tables must be equal, field for field.
Also the port's `ingest_csv` / `preprocess_csv` with and without the
native parse, and the build itself (content-hashed, locked, raising)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import make_messy_songs_csv, make_songs_csv

from spotify_recommender_tpu.data import catalog as jcatalog
from spotify_recommender_tpu.data.csv_ingest import parse_csv_rows as jax_parse
from spotify_recommender_tpu_torch.data import catalog, csv_ingest, native_ingest

HEADER = (
    "track_id,track_name,artists,danceability,energy,key,loudness,mode,"
    "speechiness,acousticness,instrumentalness,liveness,valence,tempo,"
    "track_genre"
)
ROW = "t1,Song A,Artist,0.5,0.6,C,-5.0,Major,0.1,0.2,0.3,0.4,0.5,120.0,rock"

# tests/test_native_ingest.py's cases: (header, lines)
CASES = {
    "happy_path": (HEADER, [ROW]),
    "edge_cases": (HEADER, [
        ROW,
        'q1,"Song, with comma","A, B",0.1,0.2,Db,-3,minor,0,0,0,0,0,99,pop',
        "short,row",
        ",NoId,A,0.1,0.2,0,0,1,0,0,0,0,0,99,pop",          # empty id
        "t2,,A,0.1,0.2,0,0,1,0,0,0,0,0,99,pop",            # empty name
        "t3,N,A,xx,0.2,0,0,1,0,0,0,0,0,99,pop",            # bad number
        "t4,N,A,0.1,0.2,H,0,1,0,0,0,0,0,99,pop",           # bad key
        "t5,N,A,0.1,0.2,5,0,maybe,0,0,0,0,0,99,pop",       # bad mode
        "t6,N,A,0.1,0.2,5,0,1,0,0,0,0,0,99,",              # empty genre
        "t7,N,A,1e-3,0.2,Bb,-0.5,0,0,0,0,0,0,99.5,zz-genre",
        "t8,N,A,0x10,0.2,11,-0.5,0,0,0,0,0,0,99.5,rock",   # hex strtod
    ]),
    "bom_and_crlf": ("﻿" + HEADER,
                     [ROW + "\r", "\r", ROW.replace("t1", "t2")]),
    "genre_order": (HEADER, [
        ROW.replace("rock", "z-genre"),
        ROW.replace("t1", "t2").replace("rock", "a-genre"),
        ROW.replace("t1", "t3").replace("rock", "z-genre"),
    ]),
    "unicode": (HEADER, [ROW.replace("Song A", "Chanson être ☆")
                         .replace("rock", "žánr")]),
}


def assert_tables_equal(nat, py):
    assert nat.num_valid_rows == py.num_valid_rows
    assert nat.num_input_rows == py.num_input_rows
    assert list(nat.track_ids) == list(py.track_ids)
    assert list(nat.track_names) == list(py.track_names)
    assert list(nat.artists) == list(py.artists)
    assert nat.genre_names == py.genre_names
    np.testing.assert_array_equal(nat.genre_ids, py.genre_ids)
    np.testing.assert_array_equal(nat.raw_features, py.raw_features)
    assert nat.raw_features.dtype == np.float32
    assert nat.genre_ids.dtype == np.int32


@pytest.mark.parametrize("case", list(CASES))
def test_native_equals_jax_python_parse(case):
    header, lines = CASES[case]
    nat = native_ingest.parse_csv_rows_native(header, lines)
    assert_tables_equal(nat, jax_parse(header, lines))
    if case == "genre_order":
        assert nat.genre_names == ["z-genre", "a-genre"]
    if case == "unicode":
        assert nat.track_names[0] == "Chanson être ☆"


def test_missing_column_raises():
    with pytest.raises(ValueError, match="track_genre"):
        native_ingest.parse_csv_rows_native(
            HEADER.replace(",track_genre", ",x"), [ROW])


def test_large_random_matches(tmp_path):
    p = make_songs_csv(tmp_path / "big.csv", n_rows=5000, n_genres=20)
    text = p.read_text(encoding="utf-8").splitlines()
    nat = native_ingest.parse_csv_rows_native(text[0], text[1:])
    assert_tables_equal(nat, jax_parse(text[0], text[1:]))
    assert nat.num_valid_rows == 5000


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_thread_count_invariant(tmp_path, threads):
    """Genre ids and features do not depend on the thread count (the
    reference's OpenMP ids did, DataManager.cpp:244-251)."""
    p = make_songs_csv(tmp_path / "d.csv", n_rows=3000, n_genres=30, seed=9)
    text = p.read_text(encoding="utf-8")
    nl = text.find("\n")
    py = jax_parse(text[:nl], text[nl + 1:].split("\n"))
    assert_tables_equal(native_ingest.parse_csv_buffer(
        p.read_bytes(), num_threads=threads), py)


def test_env_threads(monkeypatch):
    monkeypatch.delenv("SRT_NUM_THREADS", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert native_ingest._env_threads() == 3
    monkeypatch.setenv("SRT_NUM_THREADS", "5")
    assert native_ingest._env_threads() == 5
    monkeypatch.setenv("SRT_NUM_THREADS", "junk")
    assert native_ingest._env_threads() == 3


def test_messy_csv(tmp_path):
    """The messy fixture (quotes, unicode, CRLF, control characters, bad
    numbers) parses natively as the JAX Python parse does."""
    path, n_expected = make_messy_songs_csv(tmp_path / "m.csv", n_clean=500)
    data = path.read_bytes()
    text = data.decode("utf-8")
    nl = text.find("\n")
    nat = native_ingest.parse_csv_buffer(data)
    assert_tables_equal(nat, jax_parse(text[:nl], text[nl + 1:].split("\n")))
    assert nat.num_valid_rows == n_expected


@pytest.mark.parametrize("use_native", [True, False])
def test_preprocess_either_parse_equals_jax(tmp_path, use_native):
    path, _ = make_messy_songs_csv(tmp_path / "m.csv", n_clean=300)
    t = catalog.preprocess_csv(str(path), use_native=use_native)
    j = jcatalog.preprocess_csv(str(path))
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.norms, j.norms)
    assert list(t.track_ids) == list(j.track_ids)
    assert t.genre_names == j.genre_names
    table = csv_ingest.ingest_csv(str(path), use_native=use_native)
    assert table.num_valid_rows == len(j)


def test_build_is_content_hashed(tmp_path):
    """A build into a fresh root compiles once per source hash; the second
    call finds the library."""
    so = native_ingest.build(tmp_path)
    assert so.parent.name == native_ingest.source_hash()
    assert so.exists() and (so.parent / "g++.log").exists()
    mtime = so.stat().st_mtime_ns
    assert native_ingest.build(tmp_path) == so
    assert so.stat().st_mtime_ns == mtime


def test_concurrent_builds_share_one_library(tmp_path):
    """Four processes that build into one empty root at once all get the
    same library: one compiles under the lock, the others wait for it."""
    code = ("import sys; from pathlib import Path; "
            "from spotify_recommender_tpu_torch.data import native_ingest; "
            "print(native_ingest.build(Path(sys.argv[1])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True,
                              cwd=Path(__file__).resolve().parents[1])
             for _ in range(4)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    assert len(list(tmp_path.glob("*/libsrt_csv.so"))) == 1


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """No quiet Python fallback: a compiler failure raises."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_ingest, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="native csv parser failed"):
        native_ingest.build(tmp_path / "out")
    monkeypatch.setattr(native_ingest, "CXX", "no-such-compiler-srt")
    monkeypatch.setattr(native_ingest, "SOURCE", bad.with_name("b2.cpp"))
    bad.with_name("b2.cpp").write_text("int x;\n")
    with pytest.raises(RuntimeError, match="not found"):
        native_ingest.build(tmp_path / "out2")
