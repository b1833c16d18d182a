"""TPU kernels 5-6, the round-2 ablation bodies of kernel 3 with (B, k)
outputs (`experiments/kernel_ablation_r2.py`, `kernel_ablation_r2b.py`):
the port's plain versions (the CPU side of ops/cuda/ablation.py) against
the JAX launchers in interpret mode, on the same inputs; `full_r1`
against the JAX package's kernel 3; the per-tile digest; the mains.

The JAX launchers take no `interpret` argument, so `pallas_call` is
patched to interpret; `experiments/` is no package, so its files load by
path.  Inputs (numpy, seeded):
- dyadic: entries k/4 with |k| <= 2 and norms in {0, 1/4, ..., 4}, so
  every product, sum, quotient and clip is exact in fp32 and bf16 and both
  packages agree bitwise, NaN positions included; the few values put many
  ties into the vertical top-2.  "pad": the last tile ragged (zero
  features and norms beyond `valid`, e_div's 0 / 0), exclusions, zero
  norms; "full": every column valid, no zero norm;
- uniform: scaled unit rows whose dots straddle +-1, zero-norm columns,
  exclusions, a ragged last tile.  The sums round in another order in
  XLA, so unit-scale values agree within 1e-6 abs and raw dots within
  1e-5 rel + 1e-6 abs (a sum of 12 unit-scale products rounds by ~1e-7
  abs however small it is); max(g1 + g2) must be equal for each query
  whose lanes have every top-3 gap above 2e-6.
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

from spotify_recommender_tpu.ops.pallas.fused_topk import _fused_call
from spotify_recommender_tpu_torch.experiments import (
    kernel_ablation_r2,
    kernel_ablation_r2b,
)
from spotify_recommender_tpu_torch.ops.cuda import ablation

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
PALLAS_CALL = pl.pallas_call
B, F, K, TQ = 16, 12, 16, 8
ATOL, RTOL = 1e-6, 1e-5
R2_NAMES = ["dotonly", "widemax", "vertmax", "verttop2"]
R2B_NAMES = list(kernel_ablation_r2b.KERNELS)
ALL_BODIES = [body for group in ablation.BODIES.values()
              for body in group.values()]


def load_experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jx():
    return {name: load_experiment(name) for name in
            ("kernel_ablation_r2", "kernel_ablation_r2b")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(PALLAS_CALL, interpret=True))


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def make_inputs(data, seed, tc, f=F, b=B):
    """q (b, f), qn (b, 1), ft (f, Np), cn (1, Np), excl (b, 1) int32,
    valid (1, 1) int32; Np = 4 tiles."""
    rng = np.random.default_rng(seed)
    np_ = 4 * tc
    valid = np_ - 37 if data != "full" else np_
    if data == "uniform":
        q = rng.standard_normal((b, f)).astype(np.float32)
        ft = rng.standard_normal((f, np_)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        ft /= np.linalg.norm(ft, axis=0, keepdims=True)
        q *= rng.uniform(0.9, 1.4, (b, 1)).astype(np.float32)
        ft *= rng.uniform(0.9, 1.4, (1, np_)).astype(np.float32)
        qn = np.linalg.norm(q, axis=1, keepdims=True).astype(np.float32)
        cn = np.linalg.norm(ft, axis=0, keepdims=True).astype(np.float32)
        zero = rng.integers(0, np_, 40)
        ft[:, zero], cn[:, zero] = 0.0, 0.0          # zero-norm columns
    else:
        q = (rng.integers(-2, 3, (b, f)) / 4).astype(np.float32)
        ft = (rng.integers(-2, 3, (f, np_)) / 4).astype(np.float32)
        levels = [0.25, 0.5, 1.0, 2.0, 4.0] + ([0.0] if data == "pad" else [])
        qn = rng.choice(levels, (b, 1)).astype(np.float32)
        cn = rng.choice(levels, (1, np_)).astype(np.float32)
    ft[:, valid:], cn[:, valid:] = 0.0, 0.0
    excl = rng.integers(-1, valid, (b, 1)).astype(np.int32)
    if data == "full":
        excl[:] = -1
    return (torch.from_numpy(q), torch.from_numpy(qn), torch.from_numpy(ft),
            torch.from_numpy(cn), torch.from_numpy(excl),
            torch.full((1, 1), valid, dtype=torch.int32))


def separated(body, args, tc):
    """Per query: every lane of the last tile has its top-3 scores more
    than 2 * ATOL apart (or exactly -inf)."""
    q, qn, ft, cn, excl, valid = args
    c0 = ft.shape[1] - tc
    s = body.scores(q, qn.reshape(-1), ft[:, c0:], cn.reshape(-1)[c0:],
                    excl.reshape(-1), ablation.as_int(valid), c0)
    top = s.view(q.shape[0], tc // 128, 128).sort(dim=1, descending=True)[0]
    top = top[:, :3]
    gap = (top[:, :-1] - top[:, 1:] > 2 * ATOL) | torch.isinf(top[:, 1:])
    return gap.all(dim=2).all(dim=1).numpy()


def assert_outputs(got, want, data, body, args, tc):
    s, i = (np.asarray(x) for x in got)
    js, ji = (np.asarray(x) for x in want)
    assert s.shape == js.shape and i.shape == ji.shape and i.dtype == np.int32
    if data != "uniform":
        np.testing.assert_array_equal(s, js)       # NaN positions too
        np.testing.assert_array_equal(i, ji)
        return
    np.testing.assert_array_equal(np.isnan(s), np.isnan(js))
    rtol = RTOL if body.reduce == ablation.FIRST else 0.0
    np.testing.assert_allclose(s, js, rtol=rtol, atol=ATOL)
    if body.reduce != ablation.TOP2:
        np.testing.assert_array_equal(i, ji)           # zeros
        return
    sep = separated(body, args, tc)
    assert sep.sum() >= B // 2
    np.testing.assert_array_equal(i[sep], ji[sep])


def run_both(jmod, port, name, args, tc, dtype=torch.float32):
    q, qn, ft, cn, excl, valid = args
    q, ft = q.to(dtype), ft.to(dtype)
    got = port.run_variant(q, qn, ft, cn, excl, valid, name=name, k=K, tc=tc)
    want = jmod.run_variant(to_jax(q), to_jax(qn), to_jax(ft), to_jax(cn),
                            to_jax(excl), to_jax(valid), name=name, k=K,
                            tq=TQ, tc=tc)
    return got, want


DATA = [("pad", 512), ("full", 512), ("uniform", 256)]


@pytest.mark.parametrize("data,tc", DATA)
@pytest.mark.parametrize("name", R2_NAMES)
def test_r2_bodies_match_pallas(jx, interpret, name, data, tc):
    args = make_inputs(data, zlib.crc32(name.encode()), tc)
    got, want = run_both(jx["kernel_ablation_r2"], kernel_ablation_r2, name,
                         args, tc)
    assert_outputs(got, want, data, kernel_ablation_r2.KERNELS[name], args, tc)
    if name == "verttop2":
        assert np.asarray(got[1]).max() > 0


@pytest.mark.parametrize("data,tc", DATA)
@pytest.mark.parametrize("name", R2B_NAMES)
def test_r2b_bodies_match_pallas(jx, interpret, name, data, tc):
    body, dtype = kernel_ablation_r2b.KERNELS[name]
    args = make_inputs(data, zlib.crc32(name.encode()), tc)
    got, want = run_both(jx["kernel_ablation_r2b"], kernel_ablation_r2b, name,
                         args, tc, dtype)
    assert_outputs(got, want, data, body, args, tc)
    if name == "e_div" and data != "full":    # 0 / 0 on the ragged tile
        assert np.isnan(np.asarray(got[0])).all()


def test_full_r1_is_broken_in_jax_and_ported_as_kernel_3(jx, interpret):
    """`k_full_r1` passes 11 refs to `_fused_kernel`, which takes 15: the
    JAX variant raises.  The port's full_r1 is kernel 3, held against the
    JAX package's `_fused_call` (exact, interpret mode)."""
    tc = 256
    q, qn, ft, cn, excl, valid = make_inputs("uniform", 3, tc)
    jargs = [to_jax(x) for x in (q, qn, ft, cn, excl, valid)]
    with pytest.raises(TypeError, match="missing 4 required positional"):
        jx["kernel_ablation_r2"].run_variant(*jargs, name="full_r1", k=K,
                                             tq=TQ, tc=tc)
    s, i = kernel_ablation_r2.run_variant(q, qn, ft, cn, excl, valid,
                                          name="full_r1", k=K, tc=tc)
    js, ji = map(np.asarray, _fused_call(*jargs, k=K, tq=TQ, tc=tc, eps=1e-8,
                                         exact=True, interpret=True))
    assert s.shape == (B, K) and i.dtype == torch.int32
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=ATOL)
    gaps = np.diff(js, axis=1) < -2 * ATOL
    sep = np.ones_like(js, bool)
    sep[:, 1:] &= gaps
    sep[:, :-1] &= gaps
    sep[:, -1] = False
    assert sep.sum() > 0.8 * sep.size
    np.testing.assert_array_equal(i.numpy()[sep], ji[sep])
    assert not (i.numpy() == excl.numpy()).any()


# ------------------------------------------------------------ the digest

@pytest.mark.parametrize("body", ALL_BODIES, ids=lambda b: b.name)
def test_digest_covers_every_tile(body):
    """A change in the first tile alone moves the first tile's digest of
    that query and leaves the outputs (the last tile's) as they were."""
    tc, b = 256, 4
    rng = np.random.default_rng(7)
    q = torch.from_numpy(0.05 * rng.standard_normal((b, F), dtype=np.float32))
    ft = torch.from_numpy(0.05 * rng.standard_normal((F, 3 * tc),
                                                     dtype=np.float32))
    ones_q, ones_c = torch.ones(b, 1), torch.ones(1, 3 * tc)
    excl, valid = torch.full((b, 1), -1, dtype=torch.int32), 3 * tc

    def run(q_, ft_):
        return body(q_, ones_q, ft_, ones_c, excl, valid, tc=tc, width=16,
                    index=True, digest=True)

    *out, dig = run(q, ft)
    ft2 = ft.clone()
    ft2[:, 5] = q[0] * (0.5 / q[0].dot(q[0]))          # dot 0.5 for query 0
    *out2, dig2 = run(q, ft2)
    assert dig[0].shape == (b, 3) and len(dig) == (
        2 if body.reduce == ablation.TOP2 else 1)
    assert abs(dig2[0][0, 0] - 0.5) < 1e-5 and dig[0][0, 0] < 0.25
    for d, d2 in zip(dig, dig2):           # the later tiles are untouched
        assert torch.equal(d[:, 1:], d2[:, 1:])
    for o, o2 in zip(out, out2):
        assert torch.equal(o, o2)


# ------------------------------------------------------------ the mains

@pytest.mark.parametrize("mod", [kernel_ablation_r2, kernel_ablation_r2b],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_runs_on_cpu(mod):
    out = mod.main(n=3000, b=8, device="cpu", reps=1)
    assert set(out) == set(mod.KERNELS)
    assert all(np.isfinite(t) and t > 0 for t in out.values())


def test_main_inputs_are_the_jax_mains():
    q, qn, ft, nrm, excl, valid = kernel_ablation_r2.inputs(3000, 8, "cpu")
    assert ft.shape == (F, 8192) and not ft[:, 3000:].any()
    assert not nrm[0, 3000:].any() and valid == 3000
    assert (excl == -1).all() and q.shape == (8, F)
    # the queries are catalog rows
    hits = (ft[:, :3000].t()[None] == q[:, None]).all(dim=2).any(dim=1)
    assert hits.all()
    torch.testing.assert_close(qn[:, 0], q.norm(dim=1), rtol=1e-6, atol=0)


# ------------------------------------------------------------ the wrappers

def test_wrappers_reject_bad_inputs():
    body = ablation.BODIES["r2"]["widemax"]
    q, qn, ft, cn = torch.zeros(4, F), torch.ones(4), torch.zeros(F, 512), \
        torch.ones(512)
    excl = torch.full((4,), -1)
    with pytest.raises(TypeError):                 # mixed storage
        body(q, qn, ft.to(torch.bfloat16), cn, excl, 512, tc=256, width=16,
             index=True)
    with pytest.raises(ValueError):                # Np not a multiple of tc
        body(q, qn, ft[:, :384], cn[:384], excl, 384, tc=256, width=16,
             index=True)
    with pytest.raises(ValueError):                # tc not a multiple of 128
        body(q, qn, ft, cn, excl, 512, tc=192, width=16, index=True)
    with pytest.raises(ValueError):                # masks need excl, valid
        body(q, qn, ft, cn, tc=256, width=16, index=True)
    with pytest.raises(ValueError):                # FIRST takes <= 128
        ablation.BODIES["r2"]["dotonly"](q, qn, ft, cn, tc=256, width=129,
                                         index=True)
    with pytest.raises(ValueError):                # full_r1 has no digest
        kernel_ablation_r2.run_variant(q, qn[:, None], ft, cn[None], excl,
                                       512, name="full_r1", k=16, tc=256,
                                       digest=True)


def test_cpu_tensors_launch_no_kernel():
    for body in ALL_BODIES:
        body.launches = 0
    args = make_inputs("pad", 0, 256, b=4)
    for body in ALL_BODIES:
        body(*args, tc=256, width=16, index=True)
    assert all(body.launches == 0 for body in ALL_BODIES)


def test_nan_equal():
    a = torch.tensor([1.0, float("nan"), -0.0])
    assert ablation.nan_equal(a, torch.tensor([1.0, float("nan"), 0.0]))
    assert not ablation.nan_equal(a, torch.tensor([1.0, 2.0, 0.0]))
    assert not ablation.nan_equal(a, a[:2])


@pytest.mark.parametrize("launcher", ["kernel_ablation_r2", "kernel_ablation_r2b"])
def test_bodies_name_their_jax_functions(jx, launcher):
    """Each body's `replaces` is the line of its JAX function."""
    port = {"kernel_ablation_r2": kernel_ablation_r2,
            "kernel_ablation_r2b": kernel_ablation_r2b}[launcher]
    jkernels = jx[launcher].KERNELS
    assert list(port.KERNELS) == list(jkernels)
    for name, entry in port.KERNELS.items():
        if name == "full_r1":
            continue
        body = entry[0] if isinstance(entry, tuple) else entry
        jfn = jkernels[name][0] if isinstance(entry, tuple) else jkernels[name]
        assert body.replaces == (f"experiments/{launcher}.py:"
                                 f"{jfn.__code__.co_firstlineno}")
        if isinstance(entry, tuple):              # r2b: the storage type
            assert str(entry[1]).split(".")[1] == jnp.dtype(
                jkernels[name][1]).name
