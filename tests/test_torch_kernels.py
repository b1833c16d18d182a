"""The plain torch versions of the port's two kernels against the JAX
package's Pallas kernels in interpret mode, on the same inputs.

On the CPU the wrappers run the plain versions (CUDA tensors launch the
kernels; tests/test_torch_cuda.py holds kernel against plain on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    _scan_call_v3,
    _split_bf16x2,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    build_certified_layout as jax_layout,
)
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import scan_v3
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2
from spotify_recommender_tpu_torch.ops.fused_topk import (
    CertifiedRetriever,
    build_certified_layout,
)


def _bits(x):
    return np.asarray(x).view(np.uint16)


def _split_rows(seed, tiny, m=512, f=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, f)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)     # unit rows
    x[:64] *= np.float32(tiny)                        # tiny rows
    x[64:128] *= np.float32(3e37)                     # huge rows
    x[128:136] = 0.0                                  # zero rows
    return x


def test_split_plain_bitwise_equals_pallas():
    # tiny rows at 1e-20 keep every lo value a normal fp32 number: XLA:CPU
    # (which runs the Pallas interpreter) flushes subnormal results to zero
    x = _split_rows(0, tiny=1e-20)
    hi, lo = split_bf16x2(torch.from_numpy(x))
    jhi, jlo = _split_bf16x2(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(_bits(hi.view(torch.uint16)), _bits(jhi))
    np.testing.assert_array_equal(_bits(lo.view(torch.uint16)), _bits(jlo))
    unit = np.ones(len(x), bool)
    unit[:136] = False
    res = np.abs(hi.float().numpy() + lo.float().numpy() - x)[unit].max()
    assert res < 1e-5, res     # ~2^-18 on unit vectors; ~2^-9 if lo were lost


def test_split_keeps_subnormals_like_the_host_split():
    """At 1e-30 some lo values are subnormal.  The port keeps them, as the
    numpy/ml_dtypes split in the JAX package's build_certified_layout does
    (fused_topk.py:1730-1732)."""
    import ml_dtypes

    x = _split_rows(0, tiny=1e-30)
    hi, lo = split_bf16x2(torch.from_numpy(x))
    nhi = x.astype(ml_dtypes.bfloat16)
    nlo = (x - nhi.astype(np.float32)).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_bits(hi.view(torch.uint16)), _bits(nhi))
    np.testing.assert_array_equal(_bits(lo.view(torch.uint16)), _bits(nlo))
    subnormal = ((_bits(nlo) & 0x7F80) == 0) & ((_bits(nlo) & 0x7F) != 0)
    assert subnormal.any()


def _scan_case(seed, n, b, planes):
    """One JAX-built certified layout and split-plane queries, fed to both
    packages' scans."""
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    lay = jax_layout(feats, None, JConfig(catalog_tile=1024, split_planes=planes))
    q = feats[rng.integers(0, n, b)] + 0.01 * rng.standard_normal(
        (b, 12)).astype(np.float32)
    qu = q / np.linalg.norm(q, axis=1, keepdims=True)
    qh, ql = split_bf16x2(torch.from_numpy(qu))
    q2 = torch.cat([qh, ql, ql, qh], dim=1)
    return lay, q2


@pytest.mark.parametrize("planes", [4, 2])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("topc", [16, 32])
def test_scan_plain_matches_pallas(depth, topc, planes):
    b = 16
    lay, q2 = _scan_case(depth * 100 + topc, 5000, b, planes)
    ft = torch.from_numpy(lay.ft).to(torch.bfloat16)
    v, i, bound = scan_v3(q2, ft, w=128, depth=depth, topc=topc)
    jv, ji, jb = map(np.asarray, _scan_call_v3(
        jnp.asarray(q2.view(torch.uint16).numpy()).view(jnp.bfloat16),
        jnp.asarray(lay.ft, jnp.bfloat16),
        tq=b, tc=1024, w=128, depth=depth, topc=topc, interpret=True,
    ))
    np.testing.assert_array_equal(i.numpy(), ji)
    # both sum the same 48 exact products, in different orders
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bound.numpy(), jb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("w", [256, 512])
@pytest.mark.parametrize("depth", [2, 3])
def test_scan_plain_matches_pallas_wide_bins(w, depth):
    """W > 128 (`scan_bins`), which the CUDA kernel takes up to 1024: the
    bin of a column is col mod W in both packages."""
    b = 16
    lay, q2 = _scan_case(w + depth, 5000, b, 2)
    ft = torch.from_numpy(lay.ft).to(torch.bfloat16)
    v, i, bound = scan_v3(q2, ft, w=w, depth=depth, topc=32)
    jv, ji, jb = map(np.asarray, _scan_call_v3(
        jnp.asarray(q2.view(torch.uint16).numpy()).view(jnp.bfloat16),
        jnp.asarray(lay.ft, jnp.bfloat16),
        tq=b, tc=1024, w=w, depth=depth, topc=32, interpret=True,
    ))
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bound.numpy(), jb, rtol=0, atol=1e-6)


def test_wide_bin_layout_equals_jax_layout():
    feats = np.random.default_rng(5).random((5000, 12), dtype=np.float32)
    for bins in (256, 512, 1024):
        cfg = {"scan_bins": bins, "catalog_tile": 4096}
        t = build_certified_layout(feats, None, RetrievalConfig(**cfg))
        j = jax_layout(feats, None, JConfig(**cfg))
        assert (t.w, t.np_pad) == (j.w, j.np_pad) == (bins, 8192)


def test_scan_empty_slots_and_short_bins():
    """A catalog of one 128-column tile: each bin holds one column, so the
    depth-2 structure has empty slots (-inf, -1) and no bound."""
    lay, q2 = _scan_case(7, 100, 4, 4)
    ft = torch.from_numpy(lay.ft).to(torch.bfloat16)
    v, i, bound = scan_v3(q2, ft, w=128, depth=2, topc=160)
    assert torch.all(i[:, :128] >= 0) and torch.all(i[:, 128:] == -1)
    assert torch.all(torch.isinf(v[:, 128:])) and torch.all(torch.isinf(bound))


def test_port_layout_equals_jax_layout():
    """Same features -> the same padding, bins and split planes; the port
    stores the [hi; lo] planes that both layouts have."""
    feats = np.random.default_rng(3).random((70000, 12), dtype=np.float32)
    feats[9] = 0.0
    for cfg in ({}, {"scan_depth": 3}, {"catalog_tile": 1024}):
        t = build_certified_layout(feats, None, RetrievalConfig(**cfg))
        j = jax_layout(feats, None, JConfig(**cfg))
        assert (t.np_pad, t.w, t.depth, t.rn_min) == (
            j.np_pad, j.w, j.depth, j.rn_min)
        assert t.planes == 2 and j.planes == 4
        np.testing.assert_array_equal(t.ft, j.ft[: 2 * 12])
        np.testing.assert_array_equal(t.feats32, j.feats32[: len(feats)])
        np.testing.assert_array_equal(t.norms1d, j.norms1d[: len(feats)])


def test_cpu_tensors_launch_no_kernel():
    split_bf16x2.launches = scan_v3.launches = 0
    feats = np.random.default_rng(4).random((3000, 12), dtype=np.float32)
    cr = CertifiedRetriever(feats, None, None, torch.device("cpu"))
    cr(feats[:20], 10, exclude_rows=np.arange(20))
    assert split_bf16x2.launches == 0 and scan_v3.launches == 0


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        split_bf16x2(torch.zeros((4, 12), dtype=torch.float64))
    q2 = torch.zeros((4, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError):      # Np not a multiple of w
        scan_v3(q2, torch.zeros((24, 200), dtype=torch.bfloat16), w=128,
                depth=2, topc=32)
    with pytest.raises(ValueError):      # topc beyond depth * w
        scan_v3(q2, torch.zeros((24, 256), dtype=torch.bfloat16), w=128,
                depth=1, topc=129)
