"""Kernel 4 (the v2 bin scan) and the certified tier under `scan="v2"`: the
port on the CPU (the kernel's plain version) against the JAX package's
`_scan_call` / `CertifiedRetriever` in interpret mode and against the
oracle, on the same inputs.

Both scans sum the same 48 exact bf16 products in fp32, in different orders
(the port in the CUDA kernel's order, JAX through XLA:CPU's dot), so values
and bounds are compared within 1e-6 and indices exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    CertifiedRetriever as JCertifiedRetriever,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    _certified_retrieve,
    _scan_call,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    build_certified_layout as jax_layout,
)
from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.data.catalog import Catalog
from spotify_recommender_tpu_torch.ops import similarity as tsim
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import scan_v2
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2
from spotify_recommender_tpu_torch.ops.fused_topk import (
    BF16X2_EPS,
    CertifiedRetriever,
    build_certified_layout,
    layout_to_device,
    rerank_certify,
)
from spotify_recommender_tpu_torch.retrieval.retriever import Retriever

CPU = torch.device("cpu")
V2 = RetrievalConfig(scan="v2")
ATOL = 1e-6


def split_queries(q):
    """[qh, ql, ql, qh] of the unit queries, and the raw norms."""
    tq = torch.from_numpy(np.asarray(q, np.float32))
    qn = tsim.row_norms(tq)
    qh, ql = split_bf16x2(tq / qn.clamp_min(1e-30)[:, None])
    return torch.cat([qh, ql, ql, qh], dim=1), qn


def jax_bf16(t):
    return jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16)


def oracle(q, feats, k, excl=None):
    s, i = exact_topk(jnp.asarray(q), jnp.asarray(feats), k=k,
                      exclude_rows=None if excl is None else jnp.asarray(excl))
    return np.asarray(s), np.asarray(i)


def assert_close(got, want):
    """Equal -inf pattern, finite values within ATOL."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL)


@pytest.mark.parametrize("w", [256, 512])
@pytest.mark.parametrize("planes", [2, 4])
@pytest.mark.parametrize("topc", [16, 32, 0])
def test_scan_plain_matches_pallas(w, planes, topc):
    """A ragged catalog (valid < Np), exclusions, zero-norm and tiny-norm
    rows; topc = 0 is the full (B, 3W) / (B, W) structures."""
    rng = np.random.default_rng(w + planes * 10 + topc)
    n, b, tc = 3001, 16, 1024
    feats = rng.random((n, 12), dtype=np.float32)
    feats[5] = 0.0
    feats[6] *= np.float32(1e-12)
    lay = jax_layout(feats, None, JConfig(scan="v2", catalog_tile=tc,
                                          split_planes=planes))
    q = feats[rng.integers(0, n, b)] + 0.01 * rng.standard_normal(
        (b, 12)).astype(np.float32)
    q2, qn = split_queries(q)
    excl = rng.integers(-1, n, b)
    excl[:3] = [5, 6, -1]
    ft = torch.from_numpy(lay.ft).to(torch.bfloat16)
    v, i, bound = scan_v2(q2, qn, ft, torch.from_numpy(lay.nrm_row[0]),
                          torch.from_numpy(excl), n, w=w, eps=1e-8, topc=topc)
    jv, ji, jb = map(np.asarray, _scan_call(
        jax_bf16(q2), jnp.asarray(qn.numpy()[:, None]),
        jnp.asarray(lay.ft, jnp.bfloat16), jnp.asarray(lay.nrm_row),
        jnp.asarray(excl[:, None].astype(np.int32)),
        jnp.full((1, 1), n, jnp.int32),
        tq=b, tc=tc, w=w, eps=1e-8, topc=topc, interpret=True,
    ))
    np.testing.assert_array_equal(i.numpy(), ji)
    assert_close(v, jv)
    assert_close(bound, jb)
    assert not np.isin(i.numpy(), [*excl[:2], *range(n, lay.np_pad)]).any()
    if topc == 0:
        assert v.shape == (b, 3 * w) and bound.shape == (b, w)


@pytest.mark.parametrize("n,cfg", [
    (70000, {}),                       # W = 512, the small-batch padding
    (70000, {"catalog_tile": 1024}),
    (300, {}),                         # a 384-column tile: W halves to 128
    (640, {"scan_bins": 256}),         # v2 ignores scan_bins
])
def test_port_layout_equals_jax_layout(n, cfg):
    feats = np.random.default_rng(n).random((n, 12), dtype=np.float32)
    feats[9] = 0.0
    t = build_certified_layout(feats, None, RetrievalConfig(scan="v2", **cfg))
    j = jax_layout(feats, None, JConfig(scan="v2", **cfg))
    assert (t.scan, t.np_pad, t.w, t.depth, t.rn_min) == (
        j.scan, j.np_pad, j.w, j.depth, j.rn_min)
    np.testing.assert_array_equal(t.nrm_row, j.nrm_row)
    np.testing.assert_array_equal(t.ft, j.ft[: 2 * 12])
    assert t.nrm_row[0, n:].max(initial=0.0) == 0.0


def test_unknown_scan_raises():
    feats = np.ones((10, 12), np.float32)
    with pytest.raises(ValueError, match="scan"):
        build_certified_layout(feats, None, RetrievalConfig(scan="v4"))


def make_data(seed, n, b=32):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    return feats, rows


class TestCertifiedV2:
    @pytest.mark.parametrize("n", [3000, 5000])
    def test_matches_jax_tier_and_oracle(self, n):
        feats, rows = make_data(n, n)
        q = feats[rows]
        jcr = JCertifiedRetriever(feats, config=JConfig(scan="v2"),
                                  interpret=True)
        js, ji = jcr(jnp.asarray(q), 10, jnp.asarray(rows, jnp.int32))
        cr = CertifiedRetriever(feats, None, V2, CPU)
        assert (cr.layout.scan, cr.layout.w, cr.layout.depth) == (
            "v2", jcr.w, 3)
        s, i = cr(q, 10, exclude_rows=rows)
        rs, ri = oracle(q, feats, 10, rows)
        np.testing.assert_array_equal(i.numpy(), ri)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), rs, rtol=0, atol=ATOL)
        assert cr.fallbacks == jcr.fallbacks and cr.escalations == 0

    def test_zero_and_tiny_norm_rows(self):
        """v2 applies the exact tier's guard inside the scan: the
        tiny-norm row anti-correlated with the query scores 0 in the scan
        too, so the certificate holds with no guard clause and no oracle."""
        rng = np.random.default_rng(8)
        n, f = 4096, 12
        q = rng.random(f).astype(np.float32) + 0.5
        feats = -q[None, :] + 0.3 * rng.standard_normal((n, f)).astype(
            np.float32)
        feats[3] = -q * np.float32(1e-12)       # qn * rn <= 1e-8: guarded
        cr = CertifiedRetriever(feats, None, V2, CPU)
        s, i = cr(q[None, :], 3)
        rs, ri = oracle(q[None, :], feats, 3)
        np.testing.assert_array_equal(i.numpy(), ri)
        np.testing.assert_allclose(s.numpy(), rs, rtol=0, atol=ATOL)
        assert i[0, 0] == 3 and s[0, 0] == 0.0
        assert cr.fallbacks == 0
        # a zero-norm row ties the guarded one at 0: the rerank is bitwise
        # its oracle's, so the tie certifies, lowest index first; a zero
        # query ties everywhere at 0, its bound too, so it goes to the
        # oracle
        feats[7] = 0.0
        qs = np.stack([q, np.zeros(f, np.float32)])
        cr = CertifiedRetriever(feats, None, V2, CPU)
        s, i = cr(qs, 3)
        rs, ri = oracle(qs, feats, 3)
        np.testing.assert_array_equal(i.numpy(), ri)
        np.testing.assert_allclose(s.numpy(), rs, rtol=0, atol=ATOL)
        assert i[0, :2].tolist() == [3, 7] and cr.fallbacks == 1

    def test_eps_bound_holds_empirically(self):
        feats, rows = make_data(7, 8192, b=64)
        q = feats[rows] + np.float32(0.01)
        dl = layout_to_device(build_certified_layout(feats, None, V2), CPU)
        q2, qn = split_queries(q)
        v, idx, _ = scan_v2(q2, qn, dl.ft, dl.nrm_row,
                            torch.full((64,), -1), len(feats), w=dl.w,
                            eps=1e-8, topc=32)
        exact = tsim.cosine_scores_batched(torch.from_numpy(q),
                                           torch.from_numpy(feats))
        err = (v - torch.gather(exact, 1, idx.long())).abs().max().item()
        assert err < BF16X2_EPS

    def test_from_jax_layout(self):
        feats, rows = make_data(13, 6000, b=8)
        lay = jax_layout(feats, None, JConfig(scan="v2"))
        cr = CertifiedRetriever.from_layout(lay, len(feats), 12, None, CPU)
        assert cr.layout.scan == "v2" and cr.layout.nrm_row.shape == (
            lay.np_pad,)
        s, i = cr(feats[rows], 10, exclude_rows=rows)
        np.testing.assert_array_equal(
            i.numpy(), oracle(feats[rows], feats, 10, rows)[1])

    def test_retriever_scan_v2(self):
        feats, rows = make_data(17, 2500, b=10)
        n = len(feats)
        ids = np.asarray([f"id{r}" for r in range(n)], dtype=object)
        cat = Catalog(feats, None, ids, ids.copy(), ids.copy(),
                      np.zeros(n, np.int32), ["g"], np.zeros(11, np.float32),
                      np.ones(11, np.float32))
        r = Retriever(cat, V2, CPU)
        assert r.backend == "certified" and r.certified.layout.scan == "v2"
        s, i = r.retrieve_host(feats[rows], k=10, exclude_rows=rows)
        rs, ri = oracle(feats[rows], feats, 10, rows)
        np.testing.assert_array_equal(i, ri)
        recs = r.recommend_by_id(f"id{rows[1]}", 5)
        assert [x.row for x in recs] == ri[1, :5].tolist()


def test_fewer_filled_slots_than_c_leave_the_tail_empty():
    """A catalog of 20 rows, C = 32: only 20 bin slots fill.  The port's
    top-C leaves the other 12 as (-inf, -1) and its tier equals the oracle.
    The JAX kernel's extraction (fused_topk.py:987-998) picks the lowest
    -inf slot each further round, already-taken ones included, so it
    returns column 0 twelve more times; its rerank then scores the copies,
    and with the gap check off (`bitexact_rerank`, as on a TPU for batches
    above 16) the certificate passes on [0, 0, 0, 0, 0]."""
    feats = np.random.default_rng(0).random((20, 12), dtype=np.float32)
    lay = jax_layout(feats, None, JConfig(scan="v2"))
    q = feats[:1]
    q2, qn = split_queries(q)
    v, i, _ = scan_v2(q2, qn, torch.from_numpy(lay.ft).to(torch.bfloat16),
                      torch.from_numpy(lay.nrm_row[0]), torch.full((1,), -1),
                      20, w=lay.w, eps=1e-8, topc=32)
    assert sorted(i[0, :20].tolist()) == list(range(20))
    assert (i[0, 20:] == -1).all() and torch.isinf(v[0, 20:]).all()
    _, ji, _ = _scan_call(
        jax_bf16(q2), jnp.asarray(qn.numpy()[:, None]),
        jnp.asarray(lay.ft, jnp.bfloat16), jnp.asarray(lay.nrm_row),
        jnp.asarray([[-1]], jnp.int32), jnp.full((1, 1), 20, jnp.int32),
        tq=1, tc=lay.tc, w=lay.w, eps=1e-8, topc=32, interpret=True)
    assert (np.asarray(ji)[0, 20:] == 0).all()
    cr = CertifiedRetriever(feats, None, RetrievalConfig(scan="v2",
                                                         prefilter=32), CPU)
    s, i = cr(q, 5)
    np.testing.assert_array_equal(i.numpy(), oracle(q, feats, 5)[1])
    assert cr.fallbacks == 0
    _, ti, ok, _, _ = _certified_retrieve(
        jnp.asarray(q), jnp.asarray(lay.ft, jnp.bfloat16),
        jnp.asarray(lay.nrm_row), jnp.asarray(lay.feats32),
        jnp.asarray(lay.norms1d), jnp.asarray([-1], jnp.int32),
        jnp.full((1, 1), 20, jnp.int32), k=5, c=32, tq=8, tc=lay.tc,
        w=lay.w, eps=1e-8, ceps=2e-5, bitexact_rerank=True, scan="v2",
        interpret=True)
    assert np.asarray(ti).tolist() == [[0] * 5] and bool(ok[0])


def test_graft_entry_inputs_give_entry_indices():
    """`__graft_entry__.entry()` compiles the JAX `_certified_retrieve` at
    its defaults (scan v2, depth 3) with W = 256, C = 32 over 4096 rows and
    64 self-excluded queries.  The port's kernel-4 scan and rerank on the
    same inputs give the same top-k, and the certificate verdicts of the
    JAX tier whose rerank is bitwise its oracle's (`bitexact_rerank`, no
    gap check), which hold wherever the entry's (gap check on) hold."""
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    top_s, top_i, ok_gap, _, _ = jax.jit(fn)(*args)
    _, _, ok, _, _ = _certified_retrieve(
        *args, k=10, c=32, tq=64, tc=4096, w=256, eps=1e-8, ceps=2e-5,
        bitexact_rerank=True, interpret=True)
    q, f2, nr, f32, n1, e, v = map(np.array, args)   # writable copies
    n = int(v[0, 0])
    lay = build_certified_layout(f32, n1, V2)
    np.testing.assert_array_equal(lay.ft, f2.astype(np.float32))
    dl = layout_to_device(dataclasses.replace(lay, w=256), CPU)
    tq = torch.from_numpy(q)
    q2, qn = split_queries(q)
    excl = torch.from_numpy(e.astype(np.int64))
    a_s, cand, cb = scan_v2(q2, qn, dl.ft, dl.nrm_row, excl, n, w=256,
                            eps=1e-8, topc=32)
    s, i, tok = rerank_certify(tq, qn, a_s, cand, cb, excl, dl, n, k=10,
                               eps=1e-8, ceps=2e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(top_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(top_s), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    assert (tok.numpy() >= np.asarray(ok_gap)).all() and tok.sum() >= 60
    # the whole tier (the oracle behind the failures) gives the oracle's
    cr = CertifiedRetriever.from_layout(dataclasses.replace(lay, w=256), n,
                                        12, V2, CPU)
    np.testing.assert_array_equal(cr(q, 10, excl)[1].numpy(),
                                  oracle(q, f32, 10, e)[1])
    assert cr.fallbacks == (~tok).sum()


def test_wrapper_rejects_bad_inputs():
    q2 = torch.zeros((4, 48), dtype=torch.bfloat16)
    ft = torch.zeros((24, 512), dtype=torch.bfloat16)
    qn, nrm, excl = torch.ones(4), torch.ones(512), torch.full((4,), -1)
    with pytest.raises(ValueError):      # topc beyond 3 * w
        scan_v2(q2, qn, ft, nrm, excl, 512, w=128, eps=1e-8, topc=385)
    with pytest.raises(ValueError):      # Np not a multiple of w
        scan_v2(q2, qn, ft[:, :500], nrm[:500], excl, 500, w=128, eps=1e-8,
                topc=8)
    with pytest.raises(TypeError):       # int32 exclusions
        scan_v2(q2, qn, ft, nrm, excl.int(), 512, w=128, eps=1e-8, topc=8)
