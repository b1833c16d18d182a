"""TPU kernels 7-8, the round-2 ablation cases of kernel 3 with (B, 128)
outputs (`experiments/kernel_ablation_r2c.py`, `kernel_ablation_r2d.py`):
the port's plain versions against the JAX launchers in interpret mode on
the same inputs, and the two mains on the CPU.

Each case keeps its body, storage and stored F; its tiles shrink to tq 8
and tc 256 (TPU tc <= 8192) or 512 (larger), in the loaded JAX module
object's CASES and in the port's case table alike (no file changes).
Inputs: dyadic (entries k/4, |k| <= 2, norms in {0, 1/4, ..., 4}, zero
features and norms on the ragged last tile; exact, so bitwise) and
uniform (scaled unit rows, dots straddling +-1; unit-scale values within
1e-6 abs, raw dots within 1e-5 rel + 1e-6 abs, as
test_torch_ablation_r2.py states).
"""

import functools
import importlib.util
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spotify_recommender_tpu_torch.experiments import (
    kernel_ablation_r2c,
    kernel_ablation_r2d,
)
from spotify_recommender_tpu_torch.ops.cuda import ablation

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
PALLAS_CALL = pl.pallas_call
B, TQ, NP, VALID = 16, 8, 2048, 2011
ATOL, RTOL = 1e-6, 1e-5
PORTS = {"kernel_ablation_r2c": kernel_ablation_r2c,
         "kernel_ablation_r2d": kernel_ablation_r2d}
CASES = [(mod, name) for mod, port in PORTS.items() for name in port.CASES]


def small_tc(tc: int) -> int:
    return 256 if tc <= 8192 else 512


def load_small(name):
    """The JAX file, loaded by path, with every case's tiles shrunk."""
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for case, (fn, dt, _, tc, *rest) in mod.CASES.items():
        mod.CASES[case] = (fn, dt, TQ, small_tc(tc), *rest)
    return mod


def port_cases(mod: str) -> dict:
    return {case: (body, dt, TQ, small_tc(tc), *rest)
            for case, (body, dt, _, tc, *rest) in PORTS[mod].CASES.items()}


@pytest.fixture(scope="module")
def jx():
    return {name: load_small(name) for name in PORTS}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(PALLAS_CALL, interpret=True))


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def make_inputs(data, seed, fs, dtype):
    """q (B, fs), qn (B, 1), ft (fs, NP), cn (1, NP) in the case's
    storage; zero beyond VALID columns and, as the mains store them, in the
    padded feature rows (12-15 of 16 fp32, 24-31 of 32 bf16)."""
    rng = np.random.default_rng(seed)
    f = 12 if fs in (12, 16) else 24
    if data == "uniform":
        q = rng.standard_normal((B, f)).astype(np.float32)
        ft = rng.standard_normal((f, NP)).astype(np.float32)
        q *= (rng.uniform(0.9, 1.4, (B, 1))
              / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        ft *= (rng.uniform(0.9, 1.4, (1, NP))
               / np.linalg.norm(ft, axis=0, keepdims=True)).astype(np.float32)
        qn = rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)
        cn = rng.uniform(0.5, 2.0, (1, NP)).astype(np.float32)
        cn[:, rng.integers(0, NP, 40)] = 0.0              # guarded
    else:
        q = (rng.integers(-2, 3, (B, f)) / 4).astype(np.float32)
        ft = (rng.integers(-2, 3, (f, NP)) / 4).astype(np.float32)
        levels = [0.0, 0.25, 0.5, 1.0, 2.0, 4.0]
        qn = rng.choice(levels, (B, 1)).astype(np.float32)
        cn = rng.choice(levels, (1, NP)).astype(np.float32)
    ft[:, VALID:], cn[:, VALID:] = 0.0, 0.0
    qp = np.zeros((B, fs), np.float32)
    fp = np.zeros((fs, NP), np.float32)
    qp[:, :f], fp[:f] = q, ft
    return (torch.from_numpy(qp).to(dtype), torch.from_numpy(qn),
            torch.from_numpy(fp).to(dtype), torch.from_numpy(cn))


@pytest.mark.parametrize("data", ["dyadic", "uniform"])
@pytest.mark.parametrize("mod,name", CASES)
def test_cases_match_pallas(jx, interpret, mod, name, data):
    body, dtype, _, tc, fs, *_ = PORTS[mod].CASES[name]
    args = make_inputs(data, zlib.crc32(name.encode()), fs, dtype)
    (got,) = kernel_ablation_r2c.run_case(*args, name=name,
                                          cases=port_cases(mod))
    (want,) = jx[mod].run_case(*map(to_jax, args), name=name)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (B, 128)
    if data == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        rtol = RTOL if body.reduce == ablation.FIRST else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)
    if body.reduce != ablation.FIRST:           # broadcast of the tile max
        assert (got == got[:, :1]).all()


@pytest.mark.parametrize("mod", list(PORTS))
def test_case_table_keeps_the_jax_names_and_tiles(mod):
    """Same names, bodies' JAX functions, storage, tc and stored F."""
    jcases = load_experiment_cases(mod)
    port = PORTS[mod].CASES
    assert list(port) == list(jcases)
    for name, (body, dt, tq, tc, fs, *rest) in port.items():
        jfn, jdt, jtq, jtc, jfs, *jrest = jcases[name]
        line = jfn.__code__.co_firstlineno
        assert body.replaces == f"experiments/{mod}.py:{line}"
        assert (str(dt).split(".")[1], tq, tc, fs, rest) == (
            jnp.dtype(jdt).name, jtq, jtc, jfs, jrest)


def load_experiment_cases(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_cases_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


def test_tq_is_a_label():
    """Cases that differ only in tq (or the TPU's grid semantics) give the
    same output on the same inputs."""
    args = make_inputs("uniform", 1, 32, torch.bfloat16)
    cases = port_cases("kernel_ablation_r2d")
    a = kernel_ablation_r2c.run_case(*args, name="fg2_bf16x2p32_512x8k",
                                     cases=cases, digest=True)
    b = kernel_ablation_r2c.run_case(*args, name="fg2_bf16x2p32_1024x8k",
                                     cases=cases, digest=True)
    assert all(torch.equal(x, y) for x, y in zip((a[0], *a[1]),
                                                 (b[0], *b[1])))
    args = make_inputs("uniform", 2, 12, torch.float32)
    cases = port_cases("kernel_ablation_r2c")
    (a,) = kernel_ablation_r2c.run_case(*args, name="dot_f32_par", cases=cases)
    (b,) = kernel_ablation_r2c.run_case(*args, name="dot_f32_512x8k",
                                        cases=cases)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mod", list(PORTS))
def test_main_runs_on_cpu(mod):
    out = PORTS[mod].main(n=3000, b=8, device="cpu", reps=1)
    assert set(out) == set(PORTS[mod].CASES)
    assert all(np.isfinite(t) and t > 0 for t in out.values())


def test_case_arrays_are_the_jax_mains_layouts():
    data = kernel_ablation_r2c.main_data(3000, 8, "cpu")
    feats, norms, unit, q, qn, qunit = data
    qp, qn2, ft, nrm = kernel_ablation_r2c.case_arrays(data, torch.bfloat16,
                                                       8192, 32)
    assert ft.shape == (32, 8192) and qp.shape == (8, 32)
    assert not ft[24:].any() and not ft[:, 3000:].any() and not qp[:, 24:].any()
    hi, lo = ft[:12, :3000].t().float(), ft[12:24, :3000].t().float()
    assert (hi + lo - unit).abs().max() < 2**-16
    assert torch.equal(nrm[0, :3000], norms) and not nrm[0, 3000:].any()
    qp, _, ft, _ = kernel_ablation_r2c.case_arrays(data, torch.float32, 32768,
                                                   16)
    assert ft.shape == (16, 32768) and torch.equal(ft[:12, :3000].t(), feats)
    assert torch.equal(qp[:, :12], q) and not qp[:, 12:].any()
