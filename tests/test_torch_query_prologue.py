"""Kernel 2's query prologue (`ops/cuda/split.query_prologue`) on the CPU.

Its plain version against the JAX package's own expressions on the same
numpy inputs (`q / jnp.maximum(qn, 1e-30)`, the Pallas `_split_bf16x2` in
interpret mode, `jnp.concatenate([hi, lo, lo, hi], 1)`), the tiers that
run it against the JAX package, and one prologue per device and batch on
a sharded catalog.  tests/test_torch_cuda.py holds the kernel against this
plain version on the card.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    ApproxRetriever as JApprox,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    CertifiedRetriever as JCertified,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import _split_bf16x2
from spotify_recommender_tpu_torch.core.config import MeshConfig, RetrievalConfig
from spotify_recommender_tpu_torch.core.mesh import make_mesh
from spotify_recommender_tpu_torch.ops import fused_topk as ft_mod
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.cuda.split import (
    query_prologue,
    query_prologue_plain,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.fused_topk import (
    ApproxRetriever,
    CertifiedRetriever,
    FusedRetriever,
    prepare_queries,
)
from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog

CPU = torch.device("cpu")


def _bits(x):
    return np.asarray(x).view(np.uint16)


def _queries(seed, b, f, tiny):
    """Unit-scale rows, with tiny, huge and zero rows where B allows."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, f)).astype(np.float32)
    if b >= 7:
        q[1] *= np.float32(tiny)          # a tiny row
        q[2] *= np.float32(3e37)          # a huge row
        q[3] = 0.0                        # a zero row
    if b >= 1024:
        q[100:164] *= np.float32(tiny)
        q[200:208] = 0.0
    return q


def _norms(q):
    return np.linalg.norm(q.astype(np.float64), axis=1).astype(np.float32)


def _jax_prologue(q, qn):
    u = jnp.asarray(q) / jnp.maximum(jnp.asarray(qn), jnp.float32(1e-30))[:, None]
    hi, lo = _split_bf16x2(u, interpret=True)
    return np.asarray(jnp.concatenate([hi, lo, lo, hi], 1))


@pytest.mark.parametrize("f", [12, 64])
@pytest.mark.parametrize("b", [1, 7, 1024])
def test_plain_bitwise_equals_the_jax_expressions(b, f):
    # tiny rows at 1e-20 keep every lo value a normal fp32 number: XLA:CPU
    # (which runs the Pallas interpreter) flushes subnormal results to zero
    q = _queries(b * f, b, f, tiny=1e-20)
    qn = _norms(q)
    out = query_prologue_plain(torch.from_numpy(q), torch.from_numpy(qn))
    assert out.shape == (b, 4 * f) and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out.view(torch.uint16)),
                                  _bits(_jax_prologue(q, qn)))


@pytest.mark.parametrize("b", [1, 7, 1024])
def test_the_wrapper_on_the_cpu_is_the_plain_version(b):
    q = torch.from_numpy(_queries(b, b, 12, tiny=1e-20))
    qn = similarity.row_norms(q)
    assert torch.equal(query_prologue(q, qn).view(torch.int16),
                       query_prologue_plain(q, qn).view(torch.int16))
    before = query_prologue.launches
    query_prologue(q, qn)
    assert query_prologue.launches == before      # CPU tensors: no kernel


def test_plain_is_the_four_op_string_it_replaces():
    """Bitwise the norms, division, split and concatenation the tiers ran
    before the prologue had a kernel of its own."""
    q = torch.from_numpy(_queries(5, 1024, 12, tiny=1e-30))
    qn = similarity.row_norms(q)
    qh, ql = split_bf16x2_plain(q / qn.clamp_min(1e-30)[:, None])
    old = torch.cat([qh, ql, ql, qh], dim=1)
    pn, q2 = prepare_queries(q)
    assert torch.equal(pn, qn)
    assert torch.equal(q2.view(torch.int16), old.view(torch.int16))


def test_subnormal_lo_values_match_the_host_split():
    """Components at 1e-30 and below of a unit row, and whole rows at
    1e-30 (some under the 1e-30 clamp): the unit values' lo planes hold
    subnormals, which the port keeps, as the numpy / ml_dtypes split of
    the JAX package's build_certified_layout does (fused_topk.py:1730)."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((64, 12)).astype(np.float32)
    q[:32, 1:] *= np.float32(1e-30) * np.logspace(
        0, -8, 11, dtype=np.float32)      # tiny components of unit rows
    q[32:48] *= np.float32(1e-30)         # tiny rows
    q[48:52] *= np.float32(1e-31)         # rows below the clamp
    qn = _norms(q)
    out = query_prologue_plain(torch.from_numpy(q), torch.from_numpy(qn))
    u = q / np.maximum(qn, np.float32(1e-30))[:, None]
    hi = u.astype(ml_dtypes.bfloat16)
    lo = (u - hi.astype(np.float32)).astype(ml_dtypes.bfloat16)
    ref = np.concatenate([hi, lo, lo, hi], 1)
    np.testing.assert_array_equal(_bits(out.view(torch.uint16)), _bits(ref))
    subnormal = ((_bits(lo) & 0x7F80) == 0) & ((_bits(lo) & 0x7F) != 0)
    assert subnormal.any()


def test_nan_and_inf_propagate_as_the_torch_ops():
    q = torch.tensor([[1.0, 2.0, 2.0], [float("nan"), 0.0, 1.0],
                      [float("inf"), 1.0, 0.0], [0.0, 0.0, 0.0]])
    qn = similarity.row_norms(q)
    qn_nan = qn.clone()
    qn_nan[0] = float("nan")               # a NaN norm is not clamped away
    for norms in (qn, qn_nan):
        out = query_prologue(q, norms).float()
        ref = query_prologue_plain(q, norms).float()
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        assert torch.equal(out.nan_to_num(), ref.nan_to_num())
    assert torch.isnan(query_prologue(q, qn_nan)[0]).all()


def test_bad_inputs_raise():
    q = torch.zeros((4, 12))
    qn = torch.ones(4)
    with pytest.raises(TypeError):
        query_prologue(q.double(), qn)
    with pytest.raises(TypeError):
        query_prologue(q, qn.double())
    with pytest.raises(ValueError):
        query_prologue(q, torch.ones(5))
    with pytest.raises(ValueError):
        query_prologue(q[0], qn)
    with pytest.raises(ValueError):
        query_prologue(q.to("meta"), qn.to("meta"))


# --------------------------------------------------------------------------
# The tiers that run it
# --------------------------------------------------------------------------


def quantized(rng, shape):
    """Multiples of 1/256: squared norms exact in any summation order, so
    both packages compute the same norms and unit queries."""
    return (rng.integers(0, 256, shape) / 256).astype(np.float32)


def _data(seed, n, b):
    rng = np.random.default_rng(seed)
    feats = quantized(rng, (n, 12))
    rows = rng.integers(0, n, b).astype(np.int32)
    return feats, rows


@pytest.mark.parametrize("n,b,k", [(3000, 16, 10), (1037, 1, 5)])
def test_certified_tier_equals_the_jax_tier(n, b, k):
    feats, rows = _data(n + b, n, b)
    q = feats[rows]
    s, i = CertifiedRetriever(feats, None, None, CPU)(q, k, rows)
    js, ji = JCertified(feats, None, JConfig(), interpret=True)(
        jnp.asarray(q), k, jnp.asarray(rows))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,b,k", [(3000, 16, 10), (1037, 1, 5)])
def test_approx_tier_equals_the_jax_tier(n, b, k):
    feats, rows = _data(n * 3 + b, n, b)
    q = feats[rows]
    s, i = ApproxRetriever(feats, None, None, CPU)(q, k, rows)
    js, ji = JApprox(feats, interpret=True)(jnp.asarray(q), k,
                                             jnp.asarray(rows))
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=1e-6)
    # indices where neighbouring scores are more than 2e-6 apart
    gap = np.diff(js, axis=1) < -2e-6
    edge = np.ones((len(js), 1), bool)
    sep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
    sep[:, -1] = False
    np.testing.assert_array_equal(i.numpy()[sep], ji[sep])


@pytest.fixture
def spy(monkeypatch):
    """Counts the tiers' calls of the prologue (CPU tensors move no
    launch counter)."""
    calls = []

    def counted(queries, qn):
        calls.append(queries.shape[0])
        return query_prologue(queries, qn)

    monkeypatch.setattr(ft_mod, "query_prologue", counted)
    return calls


def test_each_tier_runs_one_prologue_per_batch(spy):
    feats, rows = _data(3, 3000, 8)
    q = feats[rows]
    CertifiedRetriever(feats, None, None, CPU)(q, 10, rows)
    assert spy == [8]
    ApproxRetriever(feats, None, None, CPU)(q, 10, rows)
    assert spy == [8, 8]
    FusedRetriever(feats, None, RetrievalConfig(dtype="bfloat16x2",
                                                exact_scores=False), CPU)(q, 10)
    assert spy == [8, 8, 8]
    with pytest.raises(ValueError):
        ft_mod.prepare_and_call(torch.from_numpy(q), torch.full((8,), -1),
                                torch.zeros((24, 128), dtype=torch.bfloat16),
                                torch.ones(128), 128, k=10, eps=1e-8,
                                exact=True, dtype="bfloat16x2")


@pytest.mark.parametrize("data,catalog", [(1, 4), (2, 2)])
def test_a_sharded_batch_runs_one_prologue_per_device(spy, data, catalog):
    """A [cpu] * 4 mesh: one prologue per batch (per data slice), not one
    per shard, and the answer bitwise the single-device tier's."""
    n, b, k = 3001, 12, 10
    feats, rows = _data(catalog, n, b)
    mesh = make_mesh(MeshConfig(data=data, catalog=catalog),
                     devices=[CPU] * (data * catalog))
    sc = ShardedCatalog(feats, None, mesh, use_certified=True,
                        data_axis="data" if data > 1 else None)
    q = feats[rows]
    s, i = sc.retrieve(q, k, rows)
    assert spy == [b // data] * data
    rs, ri = CertifiedRetriever(feats, None, None, CPU)(q, k, rows)
    assert torch.equal(i, ri) and torch.equal(s, rs)


def test_start_takes_prepared_queries():
    feats, rows = _data(8, 2000, 6)
    cr = CertifiedRetriever(feats, None, None, CPU)
    q = torch.from_numpy(feats[rows])
    excl = torch.from_numpy(rows).long()
    s, i = cr.finish(cr.start(q, 10, excl, prepare_queries(q)))
    rs, ri = cr(q, 10, excl)
    assert torch.equal(i, ri) and torch.equal(s, rs)
