"""TPU kernel 10 (`mxu_only`): the bound its tensor-core kernel is held to.

The kernel sums on the tensor cores, in their order, so on the card it is
held to its plain version (sequential round-to-nearest fp32) within
`mxu_only_tolerance` = qw * 2^-22 * S, S per (query, lane) the max over the
lane's columns of sum_r |q[r] * ft[r, c]|.  These tests hold that bound's
parts on the CPU, on seeded numpy data, against the exact dot (the bf16
operands in fp64):

- the plain version lies within qw * 2^-24 * S of the exact dot (the
  round-to-nearest model, which BF16X2_EPS's 48-term budget assumes);
- a sequential round-toward-zero fp32 sum, emulated in numpy, lies within
  qw * 2^-23 * S of the exact dot and so within the tolerance of the plain
  version, but can break the round-to-nearest bound: the tolerance covers
  truncation;
- the accumulation measured on the card (per k step of 16: terms kept to 2
  bits below the last bit of the step's largest exponent, a product's
  being the sum of its operands', and one truncation of the step's sum),
  emulated in numpy, is the port's `kernel_r3.step_model`, gives the
  card's probe values and stays within the tolerance;
- the tolerance is qw * 2^-22 * S, over column chunks too;
- the study that measures the card's accumulation runs on the CPU, where
  the plain version stands in for the kernel, and no CPU call launches.
"""

import numpy as np
import pytest
import torch

from spotify_recommender_tpu_torch.experiments import kernel_r3
from spotify_recommender_tpu_torch.ops.cuda import proto_scans
from spotify_recommender_tpu_torch.ops.cuda.proto_scans import (
    mxu_only,
    mxu_only_plain,
    mxu_only_tolerance,
)

QW = 48
U = 2.0**-23      # fp32's spacing above 1


def bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16()


def inputs(kind: str, seed: int, b: int = 64, np_: int = 512):
    """(b, 48) bf16 queries and a (48, np_) bf16 catalog from numpy:
    "split" unit split planes [qh, ql, ql, qh] / [hi; lo; hi; lo] of
    uniform rows, "normal" standard-normal planes, "cancel" 16 pairs of
    large opposite products (rows 16-31 repeat the query's rows 0-15
    against the negated catalog rows) beside 16 products scaled by 2^-12."""
    rng = np.random.default_rng(seed)
    if kind == "split":
        def planes(m):
            x = rng.random((m, 12), dtype=np.float32)
            x /= np.linalg.norm(x, axis=1, keepdims=True)
            hi = bf16(x)
            lo = bf16(x - hi.float().numpy())
            return hi, lo
        qh, ql = planes(b)
        hi, lo = planes(np_)
        return (torch.cat([qh, ql, ql, qh], 1),
                torch.cat([hi, lo, hi, lo], 1).t().contiguous())
    q = bf16(rng.standard_normal((b, QW)))
    ft = bf16(rng.standard_normal((QW, np_)))
    if kind == "cancel":
        q[:, 16:32] = q[:, :16]
        ft[16:32] = -ft[:16]
        ft[32:] = (ft[32:].float() * 2.0**-12).bfloat16()
    return q, ft


def exact_and_s(q, ft):
    """Per (query, column): the exact dot and sum_r |q[r] * ft[r, c]|, in
    fp64 (the bf16 products are exact there)."""
    qd, fd = q.double().numpy(), ft[:q.shape[1]].double().numpy()
    return qd @ fd, np.abs(qd) @ np.abs(fd)


def lane_max(x: np.ndarray) -> np.ndarray:
    return x.reshape(x.shape[0], -1, 128).max(axis=1)


def rz_sum(q, ft) -> np.ndarray:
    """The dots summed in ascending row order in fp32, each addition
    rounded toward zero (numpy rounds to nearest; a result past the exact
    sum in magnitude steps one fp32 back toward zero)."""
    qd, fd = q.double().numpy(), ft[:q.shape[1]].double().numpy()
    acc = np.zeros((qd.shape[0], fd.shape[1]), np.float32)
    for r in range(qd.shape[1]):
        v = acc.astype(np.float64) + qd[:, r:r + 1] * fd[r:r + 1]
        x = v.astype(np.float32)
        past = np.abs(x.astype(np.float64)) > np.abs(v)
        acc = np.where(past, np.nextafter(x, np.float32(0)), x)
    return acc


@pytest.mark.parametrize("kind", ["split", "normal", "cancel"])
@pytest.mark.parametrize("np_", [128, 1024])
def test_plain_within_round_to_nearest_bound(kind, np_):
    """Bound: qw * 2^-24 * S per dot; at Np = 128 each output is one dot,
    above it the max over a lane's columns moves by no more."""
    q, ft = inputs(kind, 3 + np_, np_=np_)
    exact, s = exact_and_s(q, ft)
    got = mxu_only_plain(q, ft).double().numpy()
    if np_ == 128:
        assert np.all(np.abs(got - exact) <= QW * 2.0**-24 * s)
    assert np.all(np.abs(got - lane_max(exact)) <= QW * 2.0**-24 * lane_max(s))


@pytest.mark.parametrize("kind", ["split", "normal", "cancel"])
def test_round_toward_zero_sum_within_tolerance(kind):
    """Bound: a truncating sum lies within qw * 2^-23 * S of the exact dot,
    so within qw * (2^-23 + 2^-24) * S < qw * 2^-22 * S of the plain
    version, after the max over each lane's columns too."""
    q, ft = inputs(kind, 11, np_=1024)
    exact, s = exact_and_s(q, ft)
    rz = rz_sum(q, ft).astype(np.float64)
    assert np.all(np.abs(rz - exact) <= QW * 2.0**-23 * s)
    tol = mxu_only_tolerance(q, ft).double().numpy()
    plain = mxu_only_plain(q, ft).double().numpy()
    assert np.all(np.abs(lane_max(rz) - plain) <= tol)


def test_round_toward_zero_can_break_the_nearest_bound():
    """1 plus 47 products of (1 - 2^-8) * 2^-23 (each just under fp32's
    spacing above 1): truncation drops every one, 46.8 * 2^-23 from the
    exact sum, past the round-to-nearest bound 48 * 2^-24 * S (S ~ 1), yet
    within the tolerance of the plain sum, which rounds each one up."""
    q = torch.ones((2, QW), dtype=torch.bfloat16)
    col = np.full(QW, (1 - 2.0**-8) * U)
    col[0] = 1.0
    ft = np.zeros((QW, 128))
    ft[:, 0] = col
    ft[:, 1] = -col
    ft = bf16(ft)
    exact, s = exact_and_s(q, ft)
    rz = rz_sum(q, ft).astype(np.float64)
    plain = mxu_only_plain(q, ft).double().numpy()
    assert rz[0, 0] == 1.0 and rz[0, 1] == -1.0
    assert plain[0, 0] == 1.0 + 47 * U
    miss = np.abs(rz - exact)[:, :2]
    assert np.all(miss > QW * 2.0**-24 * s[:, :2])         # breaks RN's bound
    assert np.all(miss <= QW * 2.0**-23 * s[:, :2])        # within RZ's
    tol = mxu_only_tolerance(q, ft).double().numpy()
    assert np.all(np.abs(rz - plain)[:, :2] <= tol[:, :2])
    assert np.all(np.abs(rz - plain)[:, :2] > tol[:, :2] / 4)


def step_model_sum(q, ft, keep_bits: int = 2) -> np.ndarray:
    """The tensor cores' fp32 accumulation as measured on an H100 (PERF.md
    section 6), emulated in numpy: per k step of 16 rows, the
    accumulator and the step's exact products are truncated toward zero to
    a multiple of 2^(E - 23 - keep_bits), E the largest exponent among
    the accumulator's and the products' (a product's: the sum of its
    operands' exponents), summed exactly, and the sum truncated toward
    zero to fp32."""
    def exponent(x):
        return np.where(x != 0, np.frexp(x)[1] - 1, -(1 << 20))
    qd, fd = q.double().numpy(), ft[:q.shape[1]].double().numpy()
    eq, ef = exponent(qd), exponent(fd)
    acc = np.zeros((qd.shape[0], fd.shape[1]))
    for k0 in range(0, qd.shape[1], 16):
        prods = qd[:, k0:k0 + 16, None] * fd[None, k0:k0 + 16]
        pe = np.where(prods != 0, eq[:, k0:k0 + 16, None] + ef[None, k0:k0 + 16],
                      -(1 << 20))
        top = np.maximum(pe.max(axis=1), exponent(acc))
        res = np.ldexp(1.0, np.where(top > -(1 << 20), top, 0) - 23 - keep_bits)
        terms = np.concatenate([acc[:, None], prods], axis=1)
        total = (np.trunc(terms / res[:, None]) * res[:, None]).sum(axis=1)
        x = total.astype(np.float32)
        past = np.abs(x.astype(np.float64)) > np.abs(total)
        acc = np.where(past, np.nextafter(x, np.float32(0)), x).astype(np.float64)
    return acc


def test_step_model_reproduces_the_card_and_stays_within_tolerance():
    """The model gives what `rounding_probe` measured on the card (kernel
    column, units of 2^-23: 0, 0, 0, 0, 4, 35; with no bit kept below the
    largest term's last, sub_ulp_after would give 0).  Bound: per step
    under (17/4 + 1) * 2^-23 * S, 0.65 of the round-to-nearest budget
    48 * 2^-24 * S at qw = 48, so within `mxu_only_tolerance` of the plain
    version."""
    u = 2.0**-23
    ft = np.zeros((QW, 128))
    ft[0, 0], ft[1, 0] = 1.0, 0.75 * u
    ft[0, 1], ft[1, 1] = -1.0, -0.75 * u
    ft[0, 2], ft[1, 2] = 1.0, 0.5 * u
    ft[0, 3], ft[1:, 3] = 1.0, 0.125 * u
    ft[:46, 4], ft[47, 4] = 0.125 * u, 1.0
    ft[0, 5], ft[1:, 5] = 1.0, (1 - 2.0**-8) * u
    ft = bf16(ft)
    q = torch.ones((1, QW), dtype=torch.bfloat16)
    lead = np.array([1.0, -1.0, 1.0, 1.0, 1.0, 1.0])
    units = (step_model_sum(q, ft)[0, :6] - lead) / u
    np.testing.assert_array_equal(units, [0, 0, 0, 0, 4, 35])
    assert (step_model_sum(q, ft, keep_bits=0)[0, 5] - 1.0) / u == 0
    probe = kernel_r3.rounding_probe(torch.device("cpu"))
    assert [v[5] for v in probe.values()] == [0, 0, 0, 0, 4, 35]
    for kind in ("split", "normal", "cancel"):
        q, ft = inputs(kind, 21, np_=1024)
        exact, s = exact_and_s(q, ft)
        got = step_model_sum(q, ft)
        # the port's model (kernel_r3.step_model, in torch) is this one
        np.testing.assert_array_equal(
            kernel_r3.step_model(q, ft).double().numpy(), got)
        assert np.all(np.abs(got - exact) <= 3 * (17 / 4 + 1) * u * s)
        tol = mxu_only_tolerance(q, ft).double().numpy()
        plain = mxu_only_plain(q, ft).double().numpy()
        assert np.all(np.abs(lane_max(got) - plain) <= tol)


@pytest.mark.parametrize("b,np_,chunk", [(8, 1280, 1 << 12), (3, 384, 1 << 27)])
def test_tolerance_is_qw_2m22_s(monkeypatch, b, np_, chunk):
    """qw * 2^-22 * the lane max of S, over column chunks (512 columns at
    8 queries of a 2^12-element chunk: two whole, one partial) or one."""
    monkeypatch.setattr(proto_scans, "MXU_TOL_CHUNK", chunk)
    q, ft = inputs("normal", b, b=b, np_=np_)
    ft = torch.cat([ft, bf16(np.full((5, np_), 7.0))])    # rows past qw
    _, s = exact_and_s(q, ft)
    want = (QW * 2.0**-22 * lane_max(s)).astype(np.float32)
    got = mxu_only_tolerance(q, ft)
    assert got.shape == (b, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_tolerance_of_zero_products_is_zero():
    q = torch.zeros((4, 24), dtype=torch.bfloat16)
    ft = bf16(np.ones((24, 256)))
    assert not mxu_only_tolerance(q, ft).any()
    assert not mxu_only_plain(q, ft).any()


@pytest.mark.parametrize("case", ["float", "ragged", "rows", "flat"])
def test_mxu_only_rejects_bad_inputs(case):
    q = torch.zeros((4, QW), dtype=torch.bfloat16)
    ft = torch.zeros((QW, 1024), dtype=torch.bfloat16)
    bad = {"float": ((q.float(), ft), TypeError),
           "ragged": ((q, ft[:, :1000]), ValueError),    # Np % 128
           "rows": ((q, ft[:24]), ValueError),           # fewer rows than qw
           "flat": ((q[0], ft), ValueError)}[case]
    with pytest.raises(bad[1]):
        mxu_only(*bad[0])


def test_cpu_calls_launch_no_kernel():
    mxu_only.launches = 0
    q, ft = inputs("split", 1, b=5, np_=256)
    assert torch.equal(mxu_only(q, ft), mxu_only_plain(q, ft))
    mxu_only_tolerance(q, ft)
    kernel_r3.accumulation_study("cpu", b=16, calls=1)
    assert mxu_only.launches == 0


def test_accumulation_study_on_cpu():
    """On the CPU the plain version stands in for the kernel: both ratios
    equal and at most 1 (the round-to-nearest bound), every output within
    the tolerance; the rounding probe shows the plain version's sequential
    round-to-nearest."""
    st = kernel_r3.accumulation_study("cpu", b=256, calls=2)
    for kind in kernel_r3.STUDY_SETS:
        r = st[kind]
        assert r["dots"] == 2 * 256 * 128
        assert r["kernel_ratio"] == r["plain_ratio"] <= 1.0
        assert 0.0 < r["plain_exact"] == r["kernel_exact"] <= 1.0
        assert 0.0 < r["kernel_model"] < 1.0     # the plain sum is not it
        assert r["within"]
    rounding = st["rounding"]
    assert {c: v[1] for c, v in rounding.items()} == {
        "up_0.75": 1.0, "down_0.75": -1.0, "tie_0.5": 0.0,
        "small_after": 0.0, "small_first": 6.0, "sub_ulp_after": 47.0}
    assert {c: v[2] for c, v in rounding.items()} == {
        "up_0.75": 0.75, "down_0.75": -0.75, "tie_0.5": 0.5,
        "small_after": 5.875, "small_first": 5.75,
        "sub_ulp_after": 47 * (1 - 2.0**-8)}
    assert all(v[0] == v[1] and v[3] == v[4] <= 1.0
               for v in rounding.values())


@pytest.mark.parametrize("kind", kernel_r3.STUDY_SETS)
def test_study_inputs(kind):
    g = torch.Generator().manual_seed(4)
    q, ft = kernel_r3.study_inputs(kind, 32, g, torch.device("cpu"))
    assert q.shape == (32, 48) and ft.shape == (48, 128)
    assert q.dtype == ft.dtype == torch.bfloat16 and ft.is_contiguous()
    if kind == "split":     # hi + lo of each catalog column is a unit vector
        unit = ft[:12].double() + ft[12:24].double()
        np.testing.assert_allclose(unit.norm(dim=0).numpy(), 1.0, atol=1e-5)
        assert torch.equal(ft[:24], ft[24:]) and torch.equal(q[:, :12], q[:, 36:])
    if kind == "cancel":    # the 16 large pairs cancel exactly
        pairs = (q[:, :32].double() @ ft[:32].double())
        assert not pairs.any()
        assert ft[32:].float().abs().max() < 2.0**-8
