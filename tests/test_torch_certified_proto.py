"""The three experiment paths that run TPU kernels 9-12, on the CPU: the
port's `certified_proto.certified` and `kernel_ablation_r2e.rerank`
against the JAX prototypes (their scan in interpret mode) on the same
inputs, and each ported `main` end to end at a tiny size.

`certified()` must return the JAX pipeline's rows and certificate verdicts;
scores within 1e-6, since the two reranks sum the 12 fp32 products in
their own orders.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu_torch.experiments import (
    certified_proto,
    kernel_ablation_r2e,
    kernel_r3,
)

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
CPU = torch.device("cpu")
ATOL = 1e-6


def load_experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jcp():
    return load_experiment("certified_proto")


def proto_inputs(n, b, seed, self_excl):
    """The prototype main's arrays: uniform rows, catalog-row queries, the
    [hi; lo] planes padded to 8192 columns, raw norms."""
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    rows = rng.integers(0, n, b)
    q = feats[rows]
    excl = (rows if self_excl else np.full(b, -1)).astype(np.int32)
    ft, nrm = certified_proto.layout(feats, norms, CPU)
    return feats, norms, q, excl, ft, nrm


@pytest.mark.parametrize("n,b,w,self_excl", [
    (8192, 32, 256, False),
    (8192, 32, 256, True),
    (300, 8, 128, True),       # the catalog fits the bins: `everything`
])
def test_certified_matches_jax(jcp, n, b, w, self_excl):
    feats, norms, q, excl, ft, nrm = proto_inputs(n, b, n + b, self_excl)
    s, i, ok = certified_proto.certified(q, ft, nrm, feats, norms, excl, n,
                                         k=10, c=32, w=w)
    js, ji, jok = map(np.asarray, jcp.certified(
        jnp.asarray(q), jnp.asarray(ft.view(torch.uint16).numpy()).view(
            jnp.bfloat16), jnp.asarray(nrm.numpy()), jnp.asarray(feats),
        jnp.asarray(norms), jnp.asarray(excl), jnp.full((1, 1), n, jnp.int32),
        k=10, c=32, tq=8, tc=1024, w=w, interpret=True))
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=ATOL)
    assert ok.sum() > 0
    if self_excl:
        assert not (i.numpy() == excl[:, None]).any()
    if n < 3 * w:
        assert ok.all()


def test_rerank_matches_jax():
    jr2e = load_experiment("kernel_ablation_r2e")
    rng = np.random.default_rng(2)
    n, b, c = 5000, 16, 64
    feats = rng.random((n, 12), dtype=np.float32)
    feats[7] = 0.0                                 # a guarded row
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    q = feats[rng.integers(0, n, b)]
    cand = rng.integers(0, n, (b, c))
    cand[:, 0] = 7
    s, i = kernel_ablation_r2e.rerank(
        torch.from_numpy(q), torch.from_numpy(cand), torch.from_numpy(feats),
        torch.from_numpy(norms), 10)
    js, ji = jr2e.rerank(jnp.asarray(q), jnp.asarray(cand, jnp.int32),
                         jnp.asarray(feats), jnp.asarray(norms), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=ATOL)


def test_kernel_r3_main_runs_on_cpu():
    out = kernel_r3.main(n=3000, b=5, device="cpu", reps=1)
    assert out["np"] == 65536 and out["split_equal"] == [True, True]
    assert all(out[k] > 0 for k in ("mxu_only", "scan_d3_topc", "scan_d1",
                                    "scan_d1_split", "scan_d1_b1",
                                    "scan_d1_split_b1"))


def test_kernel_r3_layout_is_split_planes():
    q, ft = kernel_r3.split_layout(1000, 4, CPU)
    assert q.shape == (4, 48) and ft.shape == (48, 65536)
    assert torch.equal(q[:, :12], q[:, 36:]) and torch.equal(q[:, 12:24],
                                                             q[:, 24:36])
    assert torch.equal(ft[:12], ft[24:36]) and torch.equal(ft[12:24], ft[36:])
    assert not ft[:, 1000:].any()
    # hi + lo of each catalog column is a unit vector
    unit = ft[:12, :1000].double() + ft[12:24, :1000].double()
    assert torch.allclose(unit.norm(dim=0), torch.ones(1000, dtype=torch.float64),
                          atol=1e-5)


def test_r2e_main_runs_on_cpu():
    out = kernel_ablation_r2e.main(n=3000, b=8, device="cpu", reps=1)
    assert set(out) == {"rerank_c32", "rerank_c64", "rerank_c256",
                        "rerank_c768", "topk_768_64", "scan3"}


def test_certified_proto_main_runs_on_cpu():
    out = certified_proto.main(n=5000, b=16, n_check=3000, b_check=16,
                               device="cpu", reps=1)
    assert set(out["w512"]) == {"ms", "enqueued_ms", "cert_ok"}
    check = out["check"]
    assert check["b"] == 16 and 0 <= check["mismatch_cert_ok"] <= 16
