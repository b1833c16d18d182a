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
import os
import shutil

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
    assert tcli.main(["--device", "cpu", "autotune"]) == 1
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
    """`retrieve --mesh` is ported: under --device cpu the catalog is
    row-sharded over that many CPU shards and the answer is the JAX CLI's
    on its 8-device CPU mesh (it exited 1 before the sharded path was
    ported).  Without a card, the default --device cuda raises."""
    _retrieve_inputs(monkeypatch, capsys, dirs)
    for mesh in ("catalog=8", "data=2,catalog=3"):
        argv = ["retrieve", "q.npz", "-k", "6", "--mesh", mesh]
        (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, dirs, argv)
        assert jrc == trc == 0
        jrows, jscores, jids = _json_rows(jout)
        trows, tscores, tids = _json_rows(tout)
        assert len(trows) == 3 and trows == jrows and tids == jids
        np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1.5e-6)
    monkeypatch.chdir(dirs[2])
    with pytest.raises(SystemExit, match="axis must be"):
        tcli.main(["--device", "cpu", "retrieve", "q.npz", "--mesh", "rows=2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["retrieve", "q.npz", "--mesh", "catalog=2"])


@pytest.mark.parametrize("flags", [["--format", "dir"],
                                   ["--streaming", "--chunk-rows", "37"]])
def test_preprocess_dir_equals_the_jax_cli(monkeypatch, capsys, dirs, flags):
    """`preprocess --format dir` and `--streaming` write the JAX CLI's
    memory-mapped directory (the port parses natively, the JAX package
    here in Python) and print the same lines."""
    csv = str(dirs[0])
    argv = ["preprocess", csv, "-o", "songs.npz", *flags]
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, dirs, argv)
    assert jrc == trc == 0 and jout == tout
    assert "Catalog saved to: songs\n" in tout
    _, jdir, tdir = dirs
    meta = json.loads((tdir / "songs" / "meta.json").read_text())
    assert meta == json.loads((jdir / "songs" / "meta.json").read_text())
    assert meta["layout"] == "dir-v1"
    for name in ("features", "norms", "genre_ids", "track_ids", "track_names",
                 "artists", "min_vals", "max_vals"):
        a, b = np.load(tdir / "songs" / f"{name}.npy"), np.load(
            jdir / "songs" / f"{name}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    # and the directory serves `recommend` as the npz does
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs,
        ["recommend", "--id", "id00010", "-n", "4", "--catalog", "songs"])
    assert jrc == trc == 0
    _assert_same_stdout(jout, tout)


def test_preprocess_sharded_and_retrieve_on_it(monkeypatch, capsys, dirs):
    """`preprocess --format sharded` then `retrieve --catalog <dir>`, in
    both CLIs (the JAX one on its orbax artifact and 8-device CPU mesh,
    the port on its per-shard .npy artifact): equal rows and track ids."""
    csv = str(dirs[0])
    _retrieve_inputs(monkeypatch, capsys, dirs)
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs,
        ["preprocess", csv, "-o", "sharded", "--format", "sharded"])
    assert jrc == trc == 0 and jout == tout
    _, jdir, tdir = dirs
    assert json.loads((tdir / "sharded" / "meta.json").read_text())[
        "layout"] == "npy-shards-v1"
    for mesh in (["--mesh", "catalog=2"], []):
        argv = ["retrieve", "q.npz", "-k", "5", "--catalog", "sharded", *mesh]
        (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, dirs, argv)
        assert jrc == trc == 0
        jrows, jscores, jids = _json_rows(jout)
        trows, tscores, tids = _json_rows(tout)
        assert len(trows) == 3 and trows == jrows and tids == jids
        np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1.5e-6)
    monkeypatch.chdir(tdir)
    assert tcli.main(["--device", "cpu", "retrieve", "q.npz", "--catalog",
                      "sharded", "-o", "s.npz"]) == 0
    assert tcli.main(["--device", "cpu", "retrieve", "q.npz", "-o",
                      "n.npz"]) == 0
    with np.load("s.npz") as a, np.load("n.npz") as b:
        np.testing.assert_array_equal(a["rows"], b["rows"])
        np.testing.assert_array_equal(a["scores"], b["scores"])
        np.testing.assert_array_equal(a["track_ids"], b["track_ids"])


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


# ---------------------------------------------------------------- MF path


def _mf_inputs(dirs, n_users=150, n_items=300, seed=0):
    """An interactions CSV (user_id,item_id,count) over the 300-row test
    catalog's items, in both working directories; the last item is
    present, so the item count is the catalog's."""
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(n_users), 8)
    items = (users * 7 + rng.integers(0, 25, users.size)) % n_items
    items[-1] = n_items - 1
    counts = rng.integers(1, 6, users.size)
    body = "user_id,item_id,count\n" + "".join(
        f"{u},{i},{c}\n" for u, i, c in zip(users, items, counts))
    for d in dirs[1:]:
        (d / "inter.csv").write_text(body)


TRAIN_ALS = ["train-mf", "inter.csv", "-o", "mf.npz", "--dim", "8",
             "--iterations", "4", "--reg", "0.05", "--alpha", "10"]


def _shared_model(monkeypatch, capsys, dirs):
    """Train in both packages, then give the port the JAX package's model
    file (the shared artifact), so both CLIs serve the same factors."""
    _both(monkeypatch, capsys, dirs, TRAIN_ALS)
    shutil.copy(dirs[1] / "mf.npz", dirs[2] / "mf.npz")


@pytest.mark.parametrize("extra", [[], ["--subspace", "4"]])
def test_train_mf_als_equals_the_jax_cli(monkeypatch, capsys, dirs, extra):
    _mf_inputs(dirs)
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, dirs, TRAIN_ALS + extra)
    assert jrc == trc == 0
    assert tout == jout and tout.lstrip().startswith("recall@10=")
    _, jdir, tdir = dirs
    with np.load(jdir / "mf.npz") as j, np.load(tdir / "mf.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for key in ("user_factors", "item_factors"):
            np.testing.assert_allclose(t[key], j[key], rtol=0, atol=5e-5)
        for key in ("embedding_dim", "reg", "alpha"):
            assert t[key] == j[key] and t[key].dtype == j[key].dtype


def test_train_mf_sgd(monkeypatch, capsys, dirs):
    """SGD through the CLI (2000 steps) equals the library call; against
    the JAX package SGD agrees only for the first steps at small batches
    (tests/test_torch_mf.py), so the CLI is held to the port's own
    `train_sgd` + `evaluate_ranking`."""
    from spotify_recommender_tpu_torch.core.config import MFConfig
    from spotify_recommender_tpu_torch.models import mf

    _mf_inputs(dirs)
    tdir = dirs[2]
    rc, out = _run(monkeypatch, capsys, tdir, tcli.main, tcli.BANNER,
                   ["--device", "cpu", "train-mf", "inter.csv", "-o", "s.npz",
                    "--dim", "8", "--solver", "sgd"])
    assert rc == 0
    inter = mf.load_interactions(str(tdir / "inter.csv"))
    train, held, seen = mf.split_leave_k_out(inter, k=2, seed=0)
    cfg = MFConfig(embedding_dim=8)
    u, i = mf.train_sgd(train, cfg, num_steps=2000, device="cpu")
    m = mf.evaluate_ranking(u, i, held, k=10, train_mask=seen, device="cpu")
    assert out.strip() == (f"recall@10={m['recall@k']:.4f} "
                           f"ndcg@10={m['ndcg@k']:.4f} "
                           f"({m['num_eval_users']} users)")
    with np.load(tdir / "s.npz") as z:
        np.testing.assert_array_equal(z["user_factors"], u)


def test_train_mf_resumes_from_its_checkpoint_dir(monkeypatch, capsys, dirs):
    _mf_inputs(dirs)
    tdir = dirs[2]
    argv = ["--device", "cpu", *TRAIN_ALS, "--checkpoint-dir", "ck"]
    rc, first = _run(monkeypatch, capsys, tdir, tcli.main, tcli.BANNER, argv)
    assert rc == 0 and sorted(os.listdir(tdir / "ck")) == [
        "step_1.pt", "step_2.pt", "step_3.pt"]
    with np.load(tdir / "mf.npz") as z:
        ref = z["user_factors"]
    # a second run resumes after the last iteration: same model, no work
    rc, again = _run(monkeypatch, capsys, tdir, tcli.main, tcli.BANNER, argv)
    assert rc == 0 and again == first
    with np.load(tdir / "mf.npz") as z:
        np.testing.assert_array_equal(z["user_factors"], ref)


@pytest.mark.parametrize("k,holdout", [(10, 2), (5, 1)])
def test_evaluate_mf_equals_the_jax_cli(monkeypatch, capsys, dirs, k, holdout):
    _mf_inputs(dirs)
    _shared_model(monkeypatch, capsys, dirs)
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs, ["evaluate-mf", "inter.csv", "--mf", "mf.npz",
                                    "-k", str(k), "--holdout", str(holdout)])
    assert jrc == trc == 0 and tout == jout
    assert tout.lstrip().startswith(f"recall@{k}=")


@pytest.mark.parametrize("extra", [
    [], ["--exclude", "3,4,5", "-n", "6"], ["--catalog", "songs_catalog.npz"],
])
def test_recommend_user_equals_the_jax_cli(monkeypatch, capsys, dirs, extra):
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    _mf_inputs(dirs)
    _shared_model(monkeypatch, capsys, dirs)
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs,
        ["recommend-user", "--mf", "mf.npz", "--user", "3", *extra])
    assert jrc == trc == 0 and tout == jout
    assert tout.lstrip().startswith("Top ") and ('"Song ' in tout) == bool(
        "--catalog" in extra)
    if "--exclude" in extra:
        assert not any(f"item {i}:" in tout or f"item {i} " in tout
                       for i in (3, 4, 5))


@pytest.mark.parametrize("exclude", ["3,300", "-301"])
def test_recommend_user_out_of_range_exclude_exits_1(monkeypatch, capsys, dirs,
                                                     exclude):
    """An `--exclude` id outside the model's 300 items: both CLIs exit 1
    with numpy's one-line IndexError (the port builds the mask on the host,
    so a card never sees the id)."""
    _mf_inputs(dirs)
    _shared_model(monkeypatch, capsys, dirs)
    argv = ["recommend-user", "--mf", "mf.npz", "--user", "3", "--exclude", exclude]
    errs = []
    for workdir, main, pre in ((dirs[1], jcli.main, []),
                               (dirs[2], tcli.main, ["--device", "cpu"])):
        monkeypatch.chdir(workdir)
        capsys.readouterr()
        assert main([*pre, *argv]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and errs[1].count("\n") == 1
    assert "out of bounds" in errs[1]


def test_embed_catalog_mf_then_recommend(monkeypatch, capsys, dirs):
    """`embed-catalog --mf` writes the item factors as a 8-dim catalog;
    `recommend --id` serves it through the certified tier, as the JAX CLI
    does through its own."""
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    _mf_inputs(dirs)
    _shared_model(monkeypatch, capsys, dirs)
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs, ["embed-catalog", "--mf", "mf.npz", "-o", "emb.npz"])
    assert jrc == trc == 0 and tout == jout
    assert "300 items x 8 dims" in tout
    _, jdir, tdir = dirs
    emb = TCatalog.load(str(tdir / "emb.npz"))
    with np.load(tdir / "mf.npz") as z:
        np.testing.assert_array_equal(emb.features, z["item_factors"])
    np.testing.assert_array_equal(
        emb.features, JCatalog.load(str(jdir / "emb.npz")).features)
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs, ["--id", "id00003", "-n", "5", "--catalog",
                                    "emb.npz"])
    assert jrc == trc == 0
    _assert_same_stdout(jout, tout)


def test_embed_catalog_needs_row_aligned_items(monkeypatch, capsys, dirs):
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    _mf_inputs(dirs, n_items=120)
    _both(monkeypatch, capsys, dirs, TRAIN_ALS)
    (jrc, _), (trc, _) = _both(monkeypatch, capsys, dirs,
                               ["embed-catalog", "--mf", "mf.npz"])
    assert jrc == trc == 1


@pytest.mark.parametrize("argv", [
    [*TRAIN_ALS, "--mesh", "catalog=2"],
    [*TRAIN_ALS, "--shard-tables"],
    ["train-two-tower", "--mesh", "data=2"],
])
def test_mf_mesh_and_two_tower_exit_1_with_one_line(monkeypatch, capsys, dirs,
                                                    argv):
    _mf_inputs(dirs)
    monkeypatch.chdir(dirs[2])
    capsys.readouterr()
    assert tcli.main(["--device", "cpu", *argv]) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "not ported" in err
    assert not (dirs[2] / "mf.npz").exists()


TRAIN_TT = ["train-two-tower", "-o", "tt.npz", "--dim", "8", "--steps", "30",
            "--batch-size", "32", "--lr", "0.003"]


def test_train_two_tower_then_embed_and_recommend(monkeypatch, capsys, dirs):
    """The port trains on the catalog's same-genre pairs and writes the
    shared model file; `embed-catalog --two-tower` in both CLIs gives the
    same 8-dim catalog from it, which `recommend --id` serves alike."""
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    _, jdir, tdir = dirs
    rc, out = _run(monkeypatch, capsys, tdir, tcli.main, tcli.BANNER,
                   ["--device", "cpu", *TRAIN_TT])
    assert rc == 0 and out.lstrip().startswith("two-tower trained: final loss")
    shutil.copy(tdir / "tt.npz", jdir / "tt.npz")
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs,
        ["embed-catalog", "--two-tower", "tt.npz", "-o", "emb.npz"])
    assert jrc == trc == 0
    assert tout == jout and "(two-tower tt.npz): 300 items x 8 dims" in tout
    emb = TCatalog.load(str(tdir / "emb.npz"))
    np.testing.assert_allclose(
        emb.features, JCatalog.load(str(jdir / "emb.npz")).features,
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(emb.features, axis=1), 1.0,
                               atol=1e-6)
    # both CLIs serve the port's embeddings
    shutil.copy(tdir / "emb.npz", jdir / "emb.npz")
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs, ["--id", "id00003", "-n", "5", "--catalog",
                                    "emb.npz"])
    assert jrc == trc == 0
    _assert_same_stdout(jout, tout)


def test_evaluate_two_tower_equals_the_jax_cli(monkeypatch, capsys, dirs):
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    _mf_inputs(dirs)
    _, jdir, tdir = dirs
    argv = [*TRAIN_TT, "--interactions", "inter.csv"]
    assert _run(monkeypatch, capsys, tdir, tcli.main, tcli.BANNER,
                ["--device", "cpu", *argv])[0] == 0
    shutil.copy(tdir / "tt.npz", jdir / "tt.npz")
    (jrc, jout), (trc, tout) = _both(
        monkeypatch, capsys, dirs,
        ["evaluate-two-tower", "inter.csv", "--two-tower", "tt.npz", "-k", "5"])
    assert jrc == trc == 0
    assert tout == jout and tout.lstrip().startswith("recall@5=")


def test_train_two_tower_resumes_from_its_checkpoint_dir(monkeypatch, capsys,
                                                         dirs):
    _both(monkeypatch, capsys, dirs, ["--preprocess", str(dirs[0])])
    tdir = dirs[2]
    for steps in ("20", "30"):
        rc, _ = _run(monkeypatch, capsys, tdir, tcli.main, tcli.BANNER,
                     ["--device", "cpu", "train-two-tower", "--dim", "8",
                      "--steps", steps, "--batch-size", "32",
                      "--checkpoint-dir", "ck"])
        assert rc == 0
    assert sorted(os.listdir(tdir / "ck")) == ["step_19.pt", "step_29.pt"]
