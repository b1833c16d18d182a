"""The plain versions of the ablation bodies (TPU kernels 5-8,
ops/cuda/ablation.py) on the CPU, where the card kernel's redesign moved
them: the bf16 chain's step is one fused multiply-add, rounded once, as
the card's __fmaf_rn; the fp32 chain rounds each multiply and each add, as
before; TOP2's reduction is the TPU bodies' walk with NaN and ties.

The step is held against exact rational arithmetic (`fractions`): acc +
a * b rounded once to fp32, to nearest with ties to even, subnormals and
overflow included.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from spotify_recommender_tpu_torch.ops.cuda import ablation

F32_MAX = Fraction(int(np.float32(np.finfo(np.float32).max)))
MIN_EXP, MANT = -149, 24   # the fp32 quantum's smallest exponent, its bits


def round_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest fp32, ties to even (the sign of an exact
    zero is the caller's)."""
    if x == 0:
        return np.float32(0.0)
    sign, ax = (-1 if x < 0 else 1), abs(x)
    e = ax.numerator.bit_length() - ax.denominator.bit_length()
    if Fraction(2) ** e > ax:
        e -= 1                                  # 2^e <= ax < 2^(e+1)
    quantum = Fraction(2) ** max(e - (MANT - 1), MIN_EXP)
    n, rem = divmod(ax, quantum)
    n = int(n)
    if rem * 2 > quantum or (rem * 2 == quantum and n % 2):
        n += 1
    v = n * quantum
    if v > F32_MAX:
        return np.float32(sign * np.inf)
    return np.float32(sign * float(v))


def exact_step(acc: np.float32, a: np.float32, b: np.float32) -> np.float32:
    exact = Fraction(float(acc)) + Fraction(float(a)) * Fraction(float(b))
    return round_f32(exact)


def bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def random_triples(n: int, seed: int):
    """n (acc, a, b) with acc fp32 and a, b bf16 values, random signs and
    significands; acc's exponent and a * b's in [-150, 10], a third of
    them with a * b within a few binades of acc (cancellation, ties)."""
    rng = np.random.default_rng(seed)
    ea = rng.integers(-150, 11, n)
    ep = np.where(rng.random(n) < 1 / 3, ea + rng.integers(-3, 4, n),
                  rng.integers(-150, 11, n))
    e1 = rng.integers(-75, 6, n)
    e1 = np.clip(e1, ep - 5 - 75, ep + 75)     # both factors inside bf16
    e2 = ep - e1
    sig = lambda: rng.uniform(1, 2, n) * rng.choice([-1.0, 1.0], n)  # noqa
    acc = np.ldexp(sig(), ea).astype(np.float32)
    a = bf16(np.ldexp(sig(), e1))
    b = bf16(np.ldexp(sig(), e2))
    return acc, a, b


def test_round_f32_agrees_with_numpy_on_doubles():
    """The rounding oracle against numpy's float64 -> float32 cast (one
    rounding, ties to even) on doubles of up to 53 bits, subnormals and
    the overflow edge included."""
    rng = np.random.default_rng(1)
    xs = np.ldexp(rng.uniform(-2, 2, 3000), rng.integers(-160, 130, 3000))
    top = float(np.finfo(np.float32).max)
    xs = np.concatenate([xs, [2.0**-149 * 1.5, 2.0**-150, 2.0**-151,
                              top * (1 + 2.0**-25), top * (1 + 2.0**-24)]])
    for x in xs:
        with np.errstate(over="ignore"):
            want = np.float32(x)
        assert round_f32(Fraction(float(x))) == want or (
            np.isinf(want) and np.isinf(round_f32(Fraction(float(x))))), x


def test_bf16_step_is_one_rounding_of_the_exact_sum():
    """`fma_step` on 2,000 seeded triples equals acc + a * b rounded once;
    the multiply-then-add chain differs from it on some of them."""
    acc, a, b = random_triples(2000, seed=0)
    got = ablation.fma_step(torch.from_numpy(acc),
                            torch.from_numpy(a).to(torch.bfloat16),
                            torch.from_numpy(b).to(torch.bfloat16)).numpy()
    want = np.array([exact_step(x, y, z) for x, y, z in zip(acc, a, b)],
                    np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with np.errstate(under="ignore"):
        two_step = acc + a * b              # fp32 multiply, then fp32 add
    assert (two_step.view(np.int32) != want.view(np.int32)).sum() > 0


def test_bf16_step_directed_case():
    """2^-75 * 2^-74 then 2^-75 * 2^-75: the chain gives 2^-149 + 2^-150
    rounded once, 2^-148 (the tie goes to the even significand); rounding
    the product 2^-150 first gives 0, then 2^-149."""
    q = torch.tensor([[2.0**-75, 2.0**-75]], dtype=torch.bfloat16)
    ft = torch.tensor([[2.0**-74], [2.0**-75]], dtype=torch.bfloat16)
    got = ablation.plain_dots(q, ft)
    assert got.item() == 2.0**-148
    assert exact_step(np.float32(2.0**-149), np.float32(2.0**-75),
                      np.float32(2.0**-75)) == np.float32(2.0**-148)
    qf, ff = q.float(), ft.float()
    assert (qf[:, :1] * ff[:1] + qf[:, 1:] * ff[1:]).item() == 2.0**-149


def test_bf16_plain_dots_follow_the_exact_chain():
    """plain_dots over F = 6 bf16 rows, tiny and huge values mixed, equals
    the chain of exact steps from the rounded first product."""
    rng = np.random.default_rng(2)
    b, f, n = 5, 6, 40
    q = bf16(np.ldexp(rng.uniform(-2, 2, (b, f)),
                      rng.integers(-80, 8, (b, f))))
    ft = bf16(np.ldexp(rng.uniform(-2, 2, (f, n)),
                       rng.integers(-80, 8, (f, n))))
    got = ablation.plain_dots(torch.from_numpy(q).to(torch.bfloat16),
                              torch.from_numpy(ft).to(torch.bfloat16)).numpy()
    for i in range(b):
        for c in range(n):
            acc = round_f32(Fraction(float(q[i, 0]))
                            * Fraction(float(ft[0, c])))
            for r in range(1, f):
                acc = exact_step(acc, q[i, r], ft[r, c])
            assert got[i, c].view(np.int32) == acc.view(np.int32), (i, c)


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e30])
def test_fp32_chain_is_the_old_one(scale):
    """The fp32 chain is bitwise the multiply-then-add chain it always was
    (each product rounded, then each sum), here written out in numpy."""
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((7, 12)) * scale).astype(np.float32)
    ft = (rng.standard_normal((12, 300)) * scale).astype(np.float32)
    got = ablation.plain_dots(torch.from_numpy(q),
                              torch.from_numpy(ft)).numpy()
    with np.errstate(all="ignore"):
        want = q[:, :1] * ft[:1]
        for r in range(1, 12):
            want = want + q[:, r:r + 1] * ft[r:r + 1]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_bf16_plain_dots_chunk_the_fp64_steps(monkeypatch):
    """Chunking the columns of the fp64 steps does not change the dots."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(
        torch.bfloat16)
    ft = torch.from_numpy(rng.standard_normal((5, 1000)).astype(
        np.float32)).to(torch.bfloat16)
    whole = ablation.plain_dots(q, ft)
    monkeypatch.setattr(ablation, "PLAIN_CHUNK_ELEMS", 3 * 7)
    assert torch.equal(ablation.plain_dots(q, ft), whole)


def walk_top2(s: np.ndarray):
    """The TPU bodies' per-lane walk (experiments/kernel_ablation_r2c.py,
    k_fastguard_top2) over s (groups, lanes): v1 from group 0, then strict
    `>`; returns (max of v1 over lanes, NaN winning; max of g1 + g2)."""
    v1 = s[0].copy()
    g1 = np.zeros(s.shape[1], np.int64)
    v2 = np.full(s.shape[1], -np.inf, np.float32)
    g2 = np.zeros(s.shape[1], np.int64)
    with np.errstate(invalid="ignore"):
        for gi in range(1, s.shape[0]):
            x = s[gi]
            beat1 = x > v1
            beat2 = ~beat1 & (x > v2)
            v2 = np.where(beat1, v1, np.where(beat2, x, v2))
            g2 = np.where(beat1, g1, np.where(beat2, gi, g2))
            v1 = np.where(beat1, x, v1)
            g1 = np.where(beat1, gi, g1)
    m = np.nan if np.isnan(v1).any() else v1.max()
    return m, (g1 + g2).max()


@pytest.mark.parametrize("seed", range(6))
def test_top2_lanes_is_the_walk_with_nan_and_ties(seed):
    """`top2_lanes` (the plain TOP2 reduction the card kernel is held to)
    equals the TPU walk on lanes with ties across groups, -inf, and NaN in
    group 0 (it stays v1) or later (it never enters)."""
    rng = np.random.default_rng(seed)
    groups, lanes = 9, 128
    s = rng.integers(-3, 4, (groups, lanes)).astype(np.float32)  # ties
    s[rng.random((groups, lanes)) < 0.1] = -np.inf
    s[rng.random((groups, lanes)) < 0.05] = np.nan
    if seed % 2:
        s[0, rng.integers(0, lanes, 3)] = np.nan
    else:
        s[0] = np.where(np.isnan(s[0]), 0.0, s[0])
    m, g = ablation.top2_lanes(torch.from_numpy(s)[None, None])
    wm, wg = walk_top2(s)
    assert (np.isnan(wm) and torch.isnan(m).item()) or m.item() == wm
    assert g.item() == wg
