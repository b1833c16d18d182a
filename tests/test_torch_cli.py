"""The port's CLI against the JAX package's, in-process on one CSV.

Below the banner, stdout must be byte-equal.  One exception: a `Score:`
line may differ by one in its last printed digit, because the JAX CLI on
the CPU ranks with its XLA oracle and the port with its certified rerank,
which sum fp32 dots in other orders; the test also checks that the two
fp32 scores behind every printed line are within 2e-6.  `retrieve` is
compared through its JSON lines and its npz: rows and track ids equal,
scores within the same bounds.
"""

import json

import numpy as np
import pytest
import torch

from conftest import make_songs_csv

from spotify_recommender_tpu import cli as jcli
from spotify_recommender_tpu.data.catalog import Catalog as JCatalog
from spotify_recommender_tpu.retrieval.retriever import Retriever as JRetriever
from spotify_recommender_tpu_torch import cli as tcli
from spotify_recommender_tpu_torch.data.catalog import Catalog as TCatalog
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

SCORE_ATOL = 2e-6


@pytest.fixture
def dirs(tmp_path):
    csv = make_songs_csv(tmp_path / "songs.csv", n_rows=300, n_genres=7, seed=5)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    return csv, tmp_path / "jax", tmp_path / "torch"


def _run(monkeypatch, capsys, workdir, main, banner, argv):
    monkeypatch.chdir(workdir)
    rc = main(argv)
    out = capsys.readouterr().out
    assert out.startswith(banner)
    return rc, out[len(banner):]


def _both(monkeypatch, capsys, dirs, argv):
    _, jdir, tdir = dirs
    j = _run(monkeypatch, capsys, jdir, jcli.main, jcli.BANNER, argv)
    t = _run(monkeypatch, capsys, tdir, tcli.main, tcli.BANNER,
             ["--device", "cpu", *argv])
    return j, t


def _assert_same_stdout(j_out, t_out):
    jl, tl = j_out.split("\n"), t_out.split("\n")
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if a != b:
            assert a.startswith("   Score:  ") and b.startswith("   Score:  "), (a, b)
            assert a[:-1] == b[:-1]                  # last printed digit only
            assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= 1.5e-6


def _assert_scores_close(dirs, by_id, query, n):
    """The fp32 scores behind the printed lines are within 2e-6."""
    _, jdir, tdir = dirs
    jr = JRetriever(JCatalog.load(str(jdir / jcli.DEFAULT_CATALOG)))
    tr = Retriever(TCatalog.load(str(tdir / tcli.DEFAULT_CATALOG)), None,
                   torch.device("cpu"))
    fn = "recommend_by_id" if by_id else "recommend_by_name"
    jrec, trec = getattr(jr, fn)(query, n), getattr(tr, fn)(query, n)
    assert [r.row for r in jrec] == [r.row for r in trec]
    np.testing.assert_allclose([r.score for r in trec], [r.score for r in jrec],
                               rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("argv,by_id,query,n", [
    (["--song", "Song 42", "-n", "5"], False, "Song 42", 5),
    (["--song", "song 7"], False, "song 7", 10),          # case-insensitive
    (["--id", "id00003"], True, "id00003", 10),
    (["--id", "id00150", "-n", "7"], True, "id00150", 7),
    (["recommend", "--song", "Song 99", "-n", "3"], False, "Song 99", 3),
])
def test_stdout_equal_below_banner(monkeypatch, capsys, dirs, argv, by_id,
                                   query, n):
    csv = str(dirs[0])
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, dirs,
                                     ["--preprocess", csv])
    assert jrc == trc == 0
    assert jout == tout
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, dirs, argv)
    assert jrc == trc == 0
    _assert_same_stdout(jout, tout)
    _assert_scores_close(dirs, by_id, query, n)


def test_bin_format_round_trip(monkeypatch, capsys, dirs):
    csv = str(dirs[0])
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs,
        ["preprocess", csv, "-o", "songs_data.bin", "--format", "bin"])
    assert jrc == trc == 0 and jout == tout
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs,
        ["recommend", "--id", "id00010", "-n", "4", "--catalog",
         "songs_data.bin"])
    assert jrc == trc == 0
    _assert_same_stdout(jout, tout)


@pytest.mark.parametrize("argv", [
    ["--song", "zzz-not-there"],          # missing song
    ["--song", "Song 1", "-n", "-3"],     # bad -n
    ["--song", "Song 1", "-n", "x"],      # bad -n
    ["--preprocess"],                     # missing CSV
])
def test_error_cases_exit_1_in_both(monkeypatch, capsys, dirs, argv):
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    (jrc, _), (trc, _) = _both(monkeypatch, capsys, dirs, argv)
    assert jrc == trc == 1


def test_unported_subcommand_exits_1(capsys):
    assert tcli.main(["--device", "cpu", "train-mf", "x.csv"]) == 1
    assert "not ported" in capsys.readouterr().err


def test_cuda_without_a_card_raises(monkeypatch, capsys, dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    monkeypatch.chdir(dirs[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--song", "Song 1"])          # --device defaults to cuda


def _retrieve_inputs(monkeypatch, capsys, dirs):
    """Both packages' catalogs from one CSV, and a queries file of three
    catalog rows in each working directory."""
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    for d in dirs[1:]:
        cat = TCatalog.load(str(d / tcli.DEFAULT_CATALOG))
        np.savez(d / "q.npz", queries=cat.features[[4, 150, 299]])


def _json_rows(out):
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return ([x["rows"] for x in lines], [x["scores"] for x in lines],
            [x["track_ids"] for x in lines])


@pytest.mark.parametrize("streaming", [False, True])
def test_retrieve_equals_the_jax_cli(monkeypatch, capsys, dirs, streaming):
    _retrieve_inputs(monkeypatch, capsys, dirs)
    argv = ["retrieve", "q.npz", "-k", "6"] + (["--streaming"] if streaming else [])
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, dirs, argv)
    assert jrc == trc == 0
    jrows, jscores, jids = _json_rows(jout)
    trows, tscores, tids = _json_rows(tout)
    assert len(trows) == 3 and trows == jrows and tids == jids
    # printed with 6 decimals: rounding plus the packages' summation orders
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1.5e-6)
    (jrc, _), (trc, tout) = _both(monkeypatch, capsys, dirs,
                                  argv + ["-o", "r.npz"])
    assert jrc == trc == 0 and "-> r.npz" in tout
    _, jdir, tdir = dirs
    with np.load(jdir / "r.npz") as j, np.load(tdir / "r.npz") as t:
        np.testing.assert_array_equal(t["rows"], j["rows"])
        np.testing.assert_array_equal(t["track_ids"], j["track_ids"])
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=0,
                                   atol=SCORE_ATOL)


def test_retrieve_mesh_exits_1(monkeypatch, capsys, dirs):
    _retrieve_inputs(monkeypatch, capsys, dirs)
    monkeypatch.chdir(dirs[2])
    assert tcli.main(["--device", "cpu", "retrieve", "q.npz", "--mesh",
                      "catalog=8"]) == 1
    assert "not ported" in capsys.readouterr().err


def test_retrieve_streams_a_dir_catalog(monkeypatch, capsys, dirs):
    """`retrieve --streaming` over a memory-mapped dir-v1 catalog, as the
    JAX CLI's help text advises.  The port dispatches a catalog directory
    on its meta.json `layout`.  The JAX CLI sends every directory with a
    meta.json to its sharded (ocdbt-v1) loader (spotify_recommender_tpu/
    cli.py:239-244), which fails on a dir-v1 catalog: this test records
    that fault without editing the JAX package."""
    _retrieve_inputs(monkeypatch, capsys, dirs)
    _, jdir, tdir = dirs
    TCatalog.load(str(tdir / tcli.DEFAULT_CATALOG)).save_dir(str(tdir / "cat"))
    monkeypatch.chdir(tdir)
    capsys.readouterr()
    assert tcli.main(["--device", "cpu", "retrieve", "q.npz", "--catalog",
                      "cat", "--streaming", "-k", "5", "-o", "d.npz"]) == 0
    assert tcli.main(["--device", "cpu", "retrieve", "q.npz", "-k", "5",
                      "-o", "n.npz"]) == 0
    with np.load("d.npz") as d, np.load("n.npz") as npz:
        np.testing.assert_array_equal(d["rows"], npz["rows"])
        np.testing.assert_array_equal(d["track_ids"], npz["track_ids"])
    monkeypatch.chdir(jdir)
    with pytest.raises(KeyError, match="padded_rows"):
        jcli.main(["retrieve", "q.npz", "--catalog", str(tdir / "cat"),
                   "--streaming", "-k", "5"])


def test_retrieve_sharded_artifact_exits_1(monkeypatch, capsys, dirs):
    _retrieve_inputs(monkeypatch, capsys, dirs)
    tdir = dirs[2]
    (tdir / "sharded").mkdir()
    (tdir / "sharded" / "meta.json").write_text(
        json.dumps({"format_version": 1, "layout": "ocdbt-v1"}))
    monkeypatch.chdir(tdir)
    assert tcli.main(["--device", "cpu", "retrieve", "q.npz", "--catalog",
                      "sharded"]) == 1
    assert "not ported" in capsys.readouterr().err
