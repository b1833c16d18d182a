"""TPU kernels 9-12, the bin-scan prototypes of `experiments/`: the port's
plain versions (the CPU side of ops/cuda/proto_scans.py) against the JAX
launchers in interpret mode, on the same inputs.

The JAX launchers of kernel_r3.py and kernel_ablation_r2e.py take no
`interpret` argument, so `pallas_call` is patched to interpret;
certified_proto.scan_call passes its own.  `experiments/` is no package,
so its files load by path.

Data: unit split planes (as certified_proto.main builds them) and
standard-normal bf16 planes (as kernel_r3.main).  Both packages sum the
same exact bf16 products in fp32, in different orders (the port in the
CUDA kernel's, XLA:CPU in its own), so values on unit data agree within
1e-6 abs, on standard-normal data within 1e-5 rel + 1e-5 abs; bin indices
are equal wherever the values are separated by more than twice that.
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spotify_recommender_tpu_torch.ops.cuda import proto_scans
from spotify_recommender_tpu_torch.ops.cuda.proto_scans import (
    mxu_only,
    proto_scan,
    scan3,
    scan_d1,
    scan_d1_plain,
    scan_d1_split,
    scan_d1_split_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2_plain

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
PALLAS_CALL = pl.pallas_call
TC = 512
TOL = {"unit": (0.0, 1e-6), "normal": (1e-5, 1e-5)}     # (rtol, atol)
CEPS = 2e-5


def load_experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jx():
    return {name: load_experiment(name) for name in
            ("kernel_r3", "kernel_ablation_r2e", "certified_proto")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(PALLAS_CALL, interpret=True))


def jax_bf16(t):
    return jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16)


def planes(data, seed, n, b, width):
    """(b, width) bf16 queries and (width, n) bf16 catalog planes, raw
    query norms (b, 1) and catalog norms (1, n).  "unit": split planes of
    uniform rows, width 24 = [qh, ql] / [hi; lo] or 48 = [qh, ql, ql, qh] /
    [hi; lo; hi; lo]; "normal": standard-normal planes (the queries scaled
    so the dots straddle the clip at +-1)."""
    rng = np.random.default_rng(seed)
    if data == "normal":
        scale = 1.0 if width == 48 else 0.07
        q = torch.from_numpy(scale * rng.standard_normal(
            (b, width), dtype=np.float32)).to(torch.bfloat16)
        ft = torch.from_numpy(rng.standard_normal(
            (width, n), dtype=np.float32)).to(torch.bfloat16)
        qn = (rng.random((b, 1), dtype=np.float32) + 0.5)
        cn = rng.random((1, n), dtype=np.float32)
        cn[0, :7] = [0.0, 1e-12, 0.0, 1e-9, 0.0, 0.0, 1e-30]  # guarded
        return q, ft, torch.from_numpy(qn), torch.from_numpy(cn)
    feats = rng.random((n, 12), dtype=np.float32)
    feats[3] = 0.0                                        # a zero row
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    unit = feats / np.maximum(norms, 1e-30)[:, None]
    hi, lo = split_bf16x2_plain(torch.from_numpy(unit))
    qr = feats[rng.integers(0, n, b)] + 0.01 * rng.standard_normal(
        (b, 12)).astype(np.float32)
    qn = np.linalg.norm(qr, axis=1, keepdims=True).astype(np.float32)
    qh, ql = split_bf16x2_plain(torch.from_numpy(qr / qn))
    if width == 24:
        q, ft = torch.cat([qh, ql], 1), torch.cat([hi, lo], 1)
    else:
        q, ft = torch.cat([qh, ql, ql, qh], 1), torch.cat([hi, lo, hi, lo], 1)
    return (q, ft.t().contiguous(), torch.from_numpy(qn),
            torch.from_numpy(norms[None, :]))


def tol_of(data, v):
    rtol, atol = TOL[data]
    return atol + rtol * np.abs(v)


def assert_values(got, want, data):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    rtol, atol = TOL[data]
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def assert_bins(got, want, data):
    """Bin structures ([v_1, i_1, ..., v_D, i_D], bound), each (B, W):
    values within the tolerance; indices equal where the slot's value is
    more than twice the tolerance from its neighbours (empty slots are
    (-inf, -1) in both)."""
    *levels, bound = [np.asarray(x) for x in got]
    *jlevels, jbound = [np.asarray(x) for x in want]
    vals, jvals = levels[0::2] + [bound], jlevels[0::2] + [jbound]
    for v, jv in zip(vals, jvals):
        assert_values(v, jv, data)
    stack = np.stack(jvals)
    with np.errstate(invalid="ignore"):
        gap = (stack[:-1] - stack[1:]) > 2 * tol_of(data, stack[:-1])
    compared = 0
    for lv in range(len(levels) // 2):
        sep = gap[lv] & (gap[lv - 1] if lv else True)
        sep |= np.isinf(stack[lv])
        i, ji = levels[2 * lv + 1], jlevels[2 * lv + 1]
        np.testing.assert_array_equal(i[sep], ji[sep])
        compared += sep.sum()
    assert compared > 0.5 * vals[0].size * (len(vals) - 1)


def d_levels(sv, si, w):
    """(B, D*W) slots -> [v1, i1, v2, i2, ...] of (B, W) each."""
    d = sv.shape[1] // w
    out = []
    for lv in range(d):
        out += [sv[:, lv * w:(lv + 1) * w], si[:, lv * w:(lv + 1) * w]]
    return out


# ------------------------------------------------ kernel 10: mxu_only

@pytest.mark.parametrize("data", ["unit", "normal"])
@pytest.mark.parametrize("b", [5, 16])
def test_mxu_only_matches_pallas(jx, interpret, data, b):
    q, ft, _, _ = planes(data, b, 2048, b, 48)
    got = mxu_only(q, ft)
    want = jx["kernel_r3"].mxu_only(jax_bf16(q), jax_bf16(ft), tq=b, tc=TC)
    assert got.shape == (b, 128)
    assert_values(got, want, data)


# ------------------------------------------------ kernel 11: scan_d1

@pytest.mark.parametrize("data,b", [("unit", 16), ("normal", 5)])
@pytest.mark.parametrize("w", [128, 256, 512])
@pytest.mark.parametrize("invert", [False, True])
def test_scan_d1_matches_pallas(jx, interpret, data, b, w, invert):
    q, ft, _, _ = planes(data, w + b, 4096, b, 48)
    got = scan_d1(q, ft, w=w, invert=invert)
    want = jx["kernel_r3"].scan_d1(jax_bf16(q), jax_bf16(ft), tq=b, tc=TC,
                                   w=w, invert=invert)
    assert [tuple(x.shape) for x in got] == [(b, w)] * 3
    assert got[1].dtype == torch.int32
    assert_bins(got, want, data)


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("w,slice_mult", [(128, 1), (128, 3), (256, 2),
                                          (512, 1), (512, 8)])
def test_scan_d1_split_bitwise_equals_single_walk(b, w, slice_mult):
    """The catalog split with its per-bin merge (the kernel's arithmetic,
    repeated in torch) equals the single walk bitwise, duplicated columns
    (ties across slices) included."""
    q, ft, _, _ = planes("normal", b + w, 8192, b, 48)
    ft[:, 4096:4096 + w] = ft[:, 1024:1024 + w]      # ties across slices
    single = scan_d1_plain(q, ft, w=w)
    split = scan_d1_split_plain(q, ft, w=w, slice_=slice_mult * w)
    for a, c in zip(single, split):
        assert torch.equal(a, c)
    # the wrapper's slices follow the card's schedule (132 SMs)
    for a, c in zip(single, scan_d1_split(q, ft, w=w)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("kind", ["scan_d1", "proto_scan"])
def test_duplicated_columns_lowest_wins(jx, interpret, kind):
    """The first 2W columns copied to the next 2W: every bin's best value
    ties with its copy, and both packages keep the lower column."""
    w, b = 256, 8
    width = 48 if kind == "scan_d1" else 24
    q, ft, qn, cn = planes("unit", 11, 2048, b, width)
    ft[:, 2 * w:4 * w] = ft[:, :2 * w]
    cn[:, 2 * w:4 * w] = cn[:, :2 * w]
    jq, jft = jax_bf16(q), jax_bf16(ft)
    if kind == "scan_d1":
        got = scan_d1(q, ft, w=w)
        want = jx["kernel_r3"].scan_d1(jq, jft, tq=b, tc=TC, w=w)
        v1, i1, jv1, ji1 = got[0], got[1], want[0], want[1]
        top = i1 < 2 * w              # the copy's value is the 2nd best
        assert torch.equal(got[2][top], v1[top])
    else:
        excl = torch.full((b, 1), -1, dtype=torch.int32)
        got = proto_scan(q, qn, ft, cn, excl, 2048, w=w)
        want = jx["certified_proto"].scan_call(
            jq, jnp.asarray(qn.numpy()), jft, jnp.asarray(cn.numpy()),
            jnp.asarray(excl.numpy()), jnp.full((1, 1), 2048, jnp.int32),
            tq=b, tc=TC, w=w, interpret=True)
        v1, i1, jv1, ji1 = got[0][:, :w], got[1][:, :w], want[0][:, :w], \
            want[1][:, :w]
        # the copy lands one level down in the bins where the best is copied
        top = i1 < 2 * w
        assert torch.equal(got[0][:, w:2 * w][top], v1[top])
    top = (i1 < 2 * w).numpy()
    assert top.any()
    np.testing.assert_array_equal(np.asarray(ji1)[top], i1.numpy()[top])
    assert_values(v1, jv1, "unit")


# ------------------------------------------------ kernel 9: scan3

@pytest.mark.parametrize("data", ["unit", "normal"])
@pytest.mark.parametrize("b", [5, 16])
def test_scan3_matches_pallas(jx, interpret, data, b):
    q, ft, qn, cn = planes(data, 90 + b, 4096, b, 24)
    got = scan3(q, qn, ft, cn)
    want = jx["kernel_ablation_r2e"].run_scan3(
        jax_bf16(q), jnp.asarray(qn.numpy()), jax_bf16(ft),
        jnp.asarray(cn.numpy()), tq=b, tc=TC)
    assert [tuple(x.shape) for x in got] == [(b, 256)] * 7
    assert_bins(got, want, data)
    if data == "normal":      # guarded columns score 0, clipped ones +-1
        assert got[0].max() == 1.0


# ------------------------------------------------ kernel 12: proto_scan

@pytest.mark.parametrize("data,b", [("unit", 16), ("normal", 5)])
@pytest.mark.parametrize("w", [128, 256, 512])
def test_proto_scan_matches_pallas(jx, interpret, data, b, w):
    """Exclusions and a ragged catalog (valid < Np): -inf in both, never
    in a bin."""
    n, valid = 4096, 3001
    q, ft, qn, cn = planes(data, 7 * w + b, n, b, 24)
    rng = np.random.default_rng(w)
    excl = rng.integers(-1, valid, (b, 1)).astype(np.int32)
    excl[:2, 0] = [-1, 5]
    got = proto_scan(q, qn, ft, cn, torch.from_numpy(excl), valid, w=w)
    want = jx["certified_proto"].scan_call(
        jax_bf16(q), jnp.asarray(qn.numpy()), jax_bf16(ft),
        jnp.asarray(cn.numpy()), jnp.asarray(excl),
        jnp.full((1, 1), valid, jnp.int32), tq=b, tc=TC, w=w,
        interpret=True)
    assert [tuple(x.shape) for x in got] == [(b, 3 * w), (b, 3 * w), (b, w)]
    assert_bins(d_levels(*got[:2], w) + [got[2]],
                d_levels(*map(np.asarray, want[:2]), w) + [want[2]], data)
    idx = got[1].numpy()
    assert (idx < valid).all()
    assert not (idx == excl).any()
    assert (idx[excl[:, 0] >= 0] != -1).any()


def test_prototype_scan_misses_the_cross_terms(jx, interpret):
    """The prototype contracts [qh, ql] with [hi; lo]: qh*hi + ql*lo, no
    ql*hi + qh*lo.  Its scan values miss the exact cosine by far more than
    the certificate's CEPS, in both packages alike; the four-product form
    of the same planes stays within it."""
    n, b, w = 8192, 16, 256
    q, ft, qn, cn = planes("unit", 5, n, b, 24)
    excl = torch.full((b, 1), -1, dtype=torch.int32)
    v, i, _ = proto_scan(q, qn, ft, cn, excl, n, w=w)
    jv, ji, _ = map(np.asarray, jx["certified_proto"].scan_call(
        jax_bf16(q), jnp.asarray(qn.numpy()), jax_bf16(ft),
        jnp.asarray(cn.numpy()), jnp.asarray(excl.numpy()),
        jnp.full((1, 1), n, jnp.int32), tq=b, tc=TC, w=w, interpret=True))
    assert_values(v, jv, "unit")
    qh, ql = q[:, :12].double(), q[:, 12:].double()
    hi, lo = ft[:12].double(), ft[12:].double()
    # the cosine of the unit rows, to the split's 2^-17 per element:
    # qh*hi + ql*lo + ql*hi + qh*lo, in fp64
    cos = (qh + ql) @ (hi + lo)
    miss = (v.double() - cos.gather(1, i.long())).abs().max().item()
    jmiss = np.abs(jv - np.take_along_axis(cos.numpy(), ji.astype(np.int64),
                                           1)).max()
    assert miss > 10 * CEPS and jmiss > 10 * CEPS
    two = (qh @ hi + ql @ lo).clamp(-1.0, 1.0).gather(1, i.long())
    assert (v.double() - two).abs().max().item() < 1e-6


# ------------------------------------------------ the wrappers

def test_wrappers_reject_bad_inputs():
    q = torch.zeros((4, 48), dtype=torch.bfloat16)
    ft = torch.zeros((48, 1024), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        mxu_only(q.float(), ft)
    with pytest.raises(ValueError):           # Np not a multiple of 128
        mxu_only(q, ft[:, :1000])
    with pytest.raises(ValueError):           # Np not a multiple of w
        scan_d1(q, ft, w=384)
    with pytest.raises(ValueError):           # Np not a multiple of w
        scan_d1_split(q, ft, w=384)
    with pytest.raises(ValueError):           # fewer catalog rows than qw
        scan_d1(q, ft[:24], w=256)
    q24, ft24 = q[:, :24], ft[:24]
    with pytest.raises(ValueError):           # norms of the wrong length
        scan3(q24, torch.ones(4), ft24, torch.ones(1000))
    with pytest.raises(TypeError):            # float64 norms
        proto_scan(q24, torch.ones(4, dtype=torch.float64), ft24,
                   torch.ones(1024), torch.full((4,), -1), 1024, w=256)


def test_cpu_tensors_launch_no_kernel():
    for fn in (mxu_only, scan_d1, scan_d1_split, scan3, proto_scan):
        fn.launches = 0
    q, ft, qn, cn = planes("unit", 1, 1024, 4, 24)
    mxu_only(q, ft)
    scan_d1(q, ft, w=256)
    scan_d1(q, ft, w=256, invert=True)
    scan3(q, qn, ft, cn)
    proto_scan(q, qn, ft, cn, torch.full((4,), -1), 1024, w=256)
    assert all(fn.launches == 0 for fn in
               (mxu_only, scan_d1, scan_d1_split, scan3, proto_scan))


def test_split_slice_covers_the_card():
    # B = 1 at W = 512: one query tile, so ~2 x 132 slices of the catalog
    s = proto_scans.split_slice(1, 10_027_008, 512, 8, 132, 2)
    assert s % 512 == 0 and 256 <= -(-10_027_008 // s) <= 264
    # B = 1024: 128 tiles already cover the card, a few slices
    s = proto_scans.split_slice(1024, 10_027_008, 512, 8, 132, 2)
    assert -(-10_027_008 // s) == 3
    assert proto_scans.split_slice(4, 512, 512, 8, 132, 2) == 512
