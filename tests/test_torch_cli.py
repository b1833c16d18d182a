"""The port's CLI against the JAX package's, in-process on one CSV.

Below the banner, stdout must be byte-equal.  One exception: a `Score:`
line may differ by one in its last printed digit, because the JAX CLI on
the CPU ranks with its XLA oracle and the port with its certified rerank,
which sum fp32 dots in other orders; the test also checks that the two
fp32 scores behind every printed line are within 2e-6.
"""

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
