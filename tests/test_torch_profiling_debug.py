"""The port's core/profiling.py and core/debug.py on the CPU, mirroring the
JAX package's tests/test_profiling.py (timed, annotate, trace) and
tests/test_debug.py (assert_finite, nan_guard), with the JAX helpers run
on the same inputs where they name a path or return a value."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core import debug as jdebug
from spotify_recommender_tpu_torch.core.debug import assert_finite, nan_guard
from spotify_recommender_tpu_torch.core.profiling import annotate, timed, trace


def test_timed_returns_median_and_output():
    t, out = timed(lambda x: x * 2, torch.ones(8), iters=3, warmup=1)
    assert t >= 0
    assert torch.equal(out, 2 * torch.ones(8))


def test_annotation_scope_is_a_span_of_the_trace(tmp_path):
    d = tmp_path / "trace"
    with trace(str(d)) as prof:
        with annotate("test-span"):
            torch.arange(4).sum()
        torch.ones(16).sum()
    files = list(d.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "test-span" in names and "aten::sum" in names
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_annotate_outside_a_trace_is_harmless():
    with annotate("no-profiler"):
        assert int(torch.arange(4).sum()) == 6


class TestAssertFinite:
    def test_passes_on_finite(self):
        assert_finite({"a": torch.ones(3), "b": [torch.zeros(2)]})
        assert_finite({"a": np.ones(3), "b": (1.0, 2)})

    @pytest.mark.parametrize("tree,name", [
        ({"params": {"w": [1.0, np.nan]}}, "params"),
        ({"a": [np.ones(2), {"z": [np.inf]}]}, "tree"),
        ([np.ones(1), (np.ones(1), np.array([-np.inf]))], "grads"),
    ])
    def test_raises_naming_the_path_as_jax(self, tree, name):
        with pytest.raises(ValueError) as theirs:
            jdebug.assert_finite(jax.tree_util.tree_map(jnp.asarray, tree),
                                 name=name)
        torch_tree = jax.tree_util.tree_map(
            lambda x: torch.as_tensor(np.asarray(x, np.float32)), tree)
        with pytest.raises(ValueError) as ours:
            assert_finite(torch_tree, name=name)
        assert str(ours.value) == str(theirs.value)

    def test_ignores_int_tensors(self):
        assert_finite({"idx": torch.arange(5), "i": np.arange(3)})


class TestNanGuard:
    def test_raises_at_the_op_that_makes_a_nan(self):
        x = torch.tensor([1.0, 0.0])
        with pytest.raises(FloatingPointError, match="aten.div"):
            with nan_guard():
                y = x * 2                  # finite: passes
                x / x                      # 0 / 0
        assert torch.equal(y, torch.tensor([2.0, 0.0]))

    def test_checks_the_backward(self):
        w = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(FloatingPointError):
            with nan_guard():
                torch.sqrt(w * w).sum().backward()   # d sqrt at 0: 0 * inf

    def test_scope_ends_and_integers_pass(self):
        x = torch.tensor([0.0])
        with nan_guard():
            torch.arange(3) // 1
            torch.tensor([float("inf")]) * 2       # inf is not NaN
        assert torch.isnan(x / x).all()            # outside: no check
