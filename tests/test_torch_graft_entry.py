"""The port's graft entry points (spotify_recommender_tpu_torch/
graft_entry.py) on the CPU, against the JAX repo's `__graft_entry__.py`
where both compute the same thing: `entry()`'s certified forward equals
the port's certified tier bit for bit and the JAX entry's indices (its
scores within 1e-6: the port sums dots in fixed feature order, XLA in its
own); `dryrun_multichip(8)` runs every multi-device path over [cpu] * 8."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from spotify_recommender_tpu_torch import graft_entry
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.ops.fused_topk import CertifiedRetriever


def test_entry_is_the_certified_tier_and_the_jax_entry():
    fn, args = graft_entry.entry("cpu")
    s, i = fn(*args)
    assert s.shape == i.shape == (64, 10)
    feats = args[3].numpy()
    want = CertifiedRetriever(feats, None,
                              RetrievalConfig(scan_bins=256, prefilter=32),
                              torch.device("cpu"))(args[0], 10, args[6])
    assert torch.equal(i, want[1]) and torch.equal(s, want[0])
    assert not bool((i == args[6][:, None]).any())      # self-exclusion
    jfn, jargs = jentry.entry()
    js, ji = jax.jit(jfn)(*jargs)[:2]
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_over_repeated_cpu_cells(n):
    graft_entry.dryrun_multichip(n, "cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
