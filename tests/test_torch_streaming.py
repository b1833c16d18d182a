"""The port's streaming tier and dir-v1 catalog format on the CPU, against
the JAX package: `StreamingRetriever(use_fused=True)` (kernel 3 in
interpret mode per window) and `exact_topk`.

Indices must be equal; scores within 1e-6 abs (the two packages sum the
fp32 dots in different orders, see tests/test_torch_fused.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.data.catalog import Catalog as JCatalog
from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu.retrieval.streaming_retriever import (
    StreamingRetriever as JStreamingRetriever,
)
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.retrieval import StreamingRetriever

CPU = torch.device("cpu")
ATOL = 1e-6


def oracle(q, feats, k, excl=None):
    s, i = exact_topk(
        jnp.asarray(q), jnp.asarray(np.asarray(feats)), k=k,
        exclude_rows=None if excl is None else jnp.asarray(excl, jnp.int32),
    )
    return np.asarray(s), np.asarray(i)


def stream(feats, q, k, excl=None, window=1024, **kw):
    sr = StreamingRetriever(feats, None, None, CPU, window=window, **kw)
    s, i = sr(q, k, exclude_rows=excl)
    return s.numpy(), i.numpy()


def assert_same(t, ref):
    np.testing.assert_array_equal(t[1], ref[1])
    np.testing.assert_allclose(t[0], ref[0], rtol=0, atol=ATOL)


def make(n, b, seed):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    return feats, rows


class TestStreamingAgainstJax:
    def test_windows_not_dividing_n(self):
        feats, rows = make(5003, 9, seed=1)
        q = feats[rows]
        t = stream(feats, q, 10, excl=rows, window=1024)
        js = JStreamingRetriever(feats, window=1024, use_fused=True)
        j = js(q, 10, exclude_rows=rows.astype(np.int32))
        assert_same(t, (np.asarray(j[0]), np.asarray(j[1])))
        assert_same(t, oracle(q, feats, 10, rows))

    def test_last_window_shorter_than_k(self):
        # 2 x 1024 + 5 rows: the last window holds 5 rows and k = 10, so
        # its list ends in 5 unfilled slots (see also the k > N case)
        n = 2 * 1024 + 5
        feats, _ = make(n, 0, seed=2)
        q = feats[[n - 1, n - 3, 10]]
        t = stream(feats, q, 10, window=1024)
        j = JStreamingRetriever(feats, window=1024, use_fused=True)(q, 10)
        assert_same(t, (np.asarray(j[0]), np.asarray(j[1])))
        assert_same(t, oracle(q, feats, 10))
        assert list(t[1][:2, 0]) == [n - 1, n - 3]

    def test_k_above_n_keeps_the_sentinel(self):
        feats, _ = make(7, 0, seed=3)
        t = stream(feats, feats[:2], 10, excl=np.array([1, -1]), window=4)
        assert ((t[1] == -1).sum(axis=1) == [4, 3]).all()
        assert (t[0][t[1] == -1] == -np.inf).all()
        j = JStreamingRetriever(feats, window=4, use_fused=True)(
            feats[:2], 10, exclude_rows=np.array([1, -1], np.int32))
        assert_same(t, (np.asarray(j[0]), np.asarray(j[1])))

    def test_exclusion_on_both_sides_of_a_boundary(self):
        feats, _ = make(3000, 0, seed=4)
        rows = np.array([1022, 1023, 1024, 1025, 2047, 2048, 0, 2999])
        q = feats[rows]
        t = stream(feats, q, 7, excl=rows, window=1024)
        j = JStreamingRetriever(feats, window=1024, use_fused=True)(
            q, 7, exclude_rows=rows.astype(np.int32))
        assert_same(t, (np.asarray(j[0]), np.asarray(j[1])))
        assert_same(t, oracle(q, feats, 7, rows))
        for b, r in enumerate(rows):
            assert r not in t[1][b]

    @pytest.mark.parametrize("window", [1000, 4100])     # 5 windows, 1
    def test_plain_window_merge_equals_the_kernel_path(self, window):
        feats, rows = make(4100, 6, seed=5)
        q = feats[rows]
        fused = stream(feats, q, 10, excl=rows, window=window)
        plain = stream(feats, q, 10, excl=rows, window=window, use_fused=False)
        np.testing.assert_array_equal(fused[1], plain[1])
        assert_same(fused, oracle(q, feats, 10, rows))

    def test_norms_computed_windowed(self):
        feats, _ = make(5000, 0, seed=6)
        sr = StreamingRetriever(feats, None, None, CPU, window=512)
        np.testing.assert_allclose(sr.norms, np.linalg.norm(feats, axis=1),
                                   rtol=1e-6)

    def test_duplicate_tie_rule(self):
        feats, _ = make(3000, 0, seed=7)
        feats[700] = feats[100]
        feats[2900] = feats[100]
        _, i = stream(feats, feats[100][None, :], 3, window=1000)
        got = i[0].tolist()
        assert got[0] == 100 and got.index(700) < got.index(2900)


def _jax_catalog(n, seed):
    feats, _ = make(n, 0, seed)
    ids = np.asarray([f"id{i:05d}" for i in range(n)])
    return JCatalog(
        features=feats, norms=np.linalg.norm(feats, axis=1).astype(np.float32),
        track_ids=ids, track_names=np.asarray([f"Song {i}" for i in range(n)]),
        artists=np.asarray([f"A{i % 7}" for i in range(n)]),
        genre_ids=(np.arange(n) % 3).astype(np.int32),
        genre_names=["a", "b", "c"], min_vals=np.zeros(11, np.float32),
        max_vals=np.ones(11, np.float32),
    )


class TestDirFormat:
    def test_jax_dir_streams_memory_mapped_in_the_port(self, tmp_path):
        jcat = _jax_catalog(2600, seed=8)
        jcat.save_dir(str(tmp_path / "cat"))
        cat = Catalog.load(str(tmp_path / "cat"))            # a directory
        assert isinstance(cat.features, np.memmap)
        assert list(cat.track_ids[:2]) == ["id00000", "id00001"]
        assert cat.genre_names == ["a", "b", "c"] and cat.genre_of(4) == "b"
        rows = np.array([5, 1023, 1024, 2599])
        q = np.asarray(cat.features[rows])
        sr = StreamingRetriever(cat.features, cat.norms, None, CPU, window=1024)
        s, i = sr(q, 10, exclude_rows=rows)
        assert_same((s.numpy(), i.numpy()), oracle(q, jcat.features, 10, rows))

    def test_port_dir_is_the_jax_format(self, tmp_path):
        jcat = _jax_catalog(300, seed=9)
        jcat.save_dir(str(tmp_path / "jax"))
        cat = Catalog.load_dir(str(tmp_path / "jax"), mmap=False)
        cat.save_dir(str(tmp_path / "torch"))
        for name in sorted(os.listdir(tmp_path / "jax")):
            assert ((tmp_path / "jax" / name).read_bytes()
                    == (tmp_path / "torch" / name).read_bytes()), name
        back = JCatalog.load_dir(str(tmp_path / "torch"))
        q = np.asarray(back.features[:4])
        j = JStreamingRetriever(back.features, back.norms, window=128,
                                use_fused=True)(q, 5)
        t = stream(cat.features, q, 5, window=128)
        assert_same(t, (np.asarray(j[0]), np.asarray(j[1])))

    def test_validation_samples_a_memory_mapped_catalog(self, tmp_path):
        jcat = _jax_catalog(9000, seed=10)
        jcat.features[4500] = np.nan        # in the middle: not sampled
        jcat.save_dir(str(tmp_path / "cat"))
        cat = Catalog.load_dir(str(tmp_path / "cat"))
        assert len(cat) == 9000
        with pytest.raises(ValueError, match="non-finite"):
            Catalog.load_dir(str(tmp_path / "cat"), mmap=False)
