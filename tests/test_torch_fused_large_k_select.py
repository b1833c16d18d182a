"""Kernel 3's large-k selection (csrc/fused_topk.cu, "k > 128") on the CPU.

- The keys (`score_keys`): their order is the plain version's (value
  descending, lowest column first; -0.0 and +0.0 equal), and a key gives
  back its score's bits, the sign of a zero included.
- `radix_threshold`, the kernel's block-wide select: exactly `need` keys
  at or above it, and it is the least such key.
- `emulate_large_k`, the kernel's selection step by step (per query and
  split: filter against the buffer's threshold, append, cut to the k best
  after a tile once the buffer may not take another; then the merge): it
  equals `fused_topk_plain` index for index and bit for bit on tie-heavy
  catalogs, +-0.0 ties, zero-norm rows, all-equal scores, scores that
  rise with the column (a cut every few tiles), many cuts of a buffer at
  its least capacity, and k above the valid columns.

Imports nothing of JAX: tests/test_torch_cuda.py takes its inputs
(`signed_zero_inputs`, `ascending_inputs`) from here on the card.
"""

import numpy as np
import pytest
import torch
from test_torch_fused_select import TIE_KINDS, kernel3_args, tie_inputs

from spotify_recommender_tpu_torch.ops.cuda.fused import (
    _TC,
    LARGE_SCRATCH_CEILING,
    SMALL_K_MAX,
    _large_plan,
    emulate_large_k,
    fused_topk,
    fused_topk_large,
    fused_topk_plain,
    key_columns,
    key_values,
    large_capacity,
    radix_threshold,
    score_keys,
)

F32 = np.float32
CPU = torch.device("cpu")
N = 2600
KINDS = (*TIE_KINDS, "signed_zero", "ascending")


def signed_zero_inputs(n, b, seed):
    """(features (n, 12), queries (b, 12), excl) whose best scores are
    zeros of both signs: each query has -1 and -0.0 entries; a third of the
    rows are 0 where the query is -1 and positive where it is -0.0 (every
    product -0.0: the dot is -0.0), a third negative where it is -0.0 (a
    +0.0 product: +0.0), the rest positive where the query is -1 (below
    0).  Exclusions on even queries."""
    rng = np.random.default_rng(seed)
    neg = np.arange(12) % 2 == 0                    # the query's -1 entries
    q = np.where(neg, F32(-1), F32(-0.0)).astype(F32)
    q = np.tile(q, (b, 1))
    q[:, neg] *= (1 + rng.random((b, neg.sum()), dtype=F32))
    feats = np.zeros((n, 12), F32)
    kind = np.arange(n) % 3
    mag = (rng.random((n, 12), dtype=F32) + F32(0.1)).astype(F32)
    feats[kind == 0] = np.where(neg, F32(0), mag[kind == 0])
    feats[kind == 1] = np.where(neg, F32(0), -mag[kind == 1])
    feats[kind == 2] = np.where(neg, mag[kind == 2], F32(0))
    rows = rng.integers(0, n, b)
    excl = np.where(np.arange(b) % 2 == 0, rows, -1).astype(np.int64)
    return feats, q, excl


def ascending_inputs(n, b):
    """(features, queries, excl) whose cosine with every query rises with
    the column (a duplicate pair among them): every column beats the ones
    before it, so each buffer fills and is cut again every few tiles."""
    theta = np.linspace(1.5, 0.0, n, dtype=np.float64)
    feats = np.zeros((n, 12), F32)
    feats[:, 0], feats[:, 1] = np.cos(theta), np.sin(theta)
    feats[n // 3] = feats[n // 3 + 1]
    q = np.zeros((b, 12), F32)
    q[:, 0] = 1.0
    q[:, 2:] = 1e-3 * np.arange(1, b + 1, dtype=F32)[:, None]
    excl = np.where(np.arange(b) % 2 == 0, n - 20, -1).astype(np.int64)
    return feats, q, excl


def large_inputs(kind, n, b, seed, edges=()):
    """The inputs of any of KINDS as numpy arrays."""
    if kind == "signed_zero":
        return signed_zero_inputs(n, b, seed)
    if kind == "ascending":
        return ascending_inputs(n, b)
    return tie_inputs(kind, n, b, seed, edges=edges)


# ---- the keys and the select

def _ranked_order(x, cols):
    """Positions of (x, cols) by value descending, column ascending, with
    -0.0 == +0.0 (as topk_stable ranks them)."""
    return np.lexsort((cols, -x.astype(np.float64)))


def test_keys_order_as_the_plain_version_and_give_back_the_bits():
    rng = np.random.default_rng(0)
    m = 20000
    x = rng.uniform(-1, 1, m).astype(F32)
    special = np.array([-1, 1, 0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38,
                        np.nextafter(F32(1), F32(0)), -0.5, 0.5], F32)
    x[:len(special) * 40] = np.repeat(special, 40)    # many equal values
    x[-2000:] = rng.choice(special, 2000)
    cols = rng.permutation(2**31 - 1 - np.arange(m))[:m].astype(np.int64)
    cols[:5] = [0, 1, 2**31 - 2, 2**30, 7]
    keys = score_keys(x, cols)
    assert len(np.unique(keys)) == m and (keys > 0).all()
    np.testing.assert_array_equal(np.argsort(~keys), _ranked_order(x, cols))
    np.testing.assert_array_equal(key_values(keys).view(np.uint32),
                                  x.view(np.uint32))   # -0.0 comes back
    np.testing.assert_array_equal(key_columns(keys), cols)
    # -1.0 at the largest column is above the empty key 0
    assert score_keys(np.array([-1.0], F32), np.array([2**31 - 2]))[0] > 0


@pytest.mark.parametrize("m,need", [(1, 1), (5, 5), (6, 5), (300, 129),
                                    (2000, 1000), (4096, 1), (4096, 4095)])
@pytest.mark.parametrize("data", ["uniform", "ties", "two_values"])
def test_radix_threshold_keeps_exactly_need(m, need, data):
    rng = np.random.default_rng(m + need)
    x = {"uniform": rng.uniform(-1, 1, m),
         "ties": rng.choice([0.25, -0.0, 0.0, 0.5], m),
         "two_values": np.where(np.arange(m) % 2, 1.0, -1.0)}[data]
    keys = score_keys(x.astype(F32), rng.permutation(10 * m)[:m])
    keys = np.concatenate([keys, np.zeros(7, np.uint64)])   # empty slots
    t = radix_threshold(keys, need)
    real = keys[keys != 0]
    if len(real) <= need:
        assert t == 1
        return
    kept = real[real >= np.uint64(t)]
    assert len(kept) == need
    np.testing.assert_array_equal(np.sort(kept), np.sort(real)[-need:])
    # the least such key: one below it would keep more
    assert (real >= np.uint64(t - 1)).sum() in (need, need + 1)


# ---- the emulated selection against the plain version

@pytest.mark.parametrize("b", [1, 5, 17])
@pytest.mark.parametrize("k", [129, 300, "valid", "valid+37"])
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_large_k_equals_plain(kind, k, b):
    valid = N - 5
    k = {"valid": valid, "valid+37": valid + 37}.get(k, k)
    # three splits with their edges in the tie kinds' duplicates
    feats, q, excl = large_inputs(kind, N, b, seed=b, edges=(1024, 2048))
    args = kernel3_args(feats, q, excl, exact=True, valid=valid)
    ev, ei, stats = emulate_large_k(*args, k=k, exact=True, nsplit=3,
                                    split_cols=1024)
    pv, pi = fused_topk_plain(*args, k=k, exact=True)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)
    assert torch.equal(torch.signbit(ev), torch.signbit(pv))
    assert torch.equal(ei == -1, ev == float("-inf"))
    assert (ei < valid).all()
    if k > valid:
        assert ((ei == -1).sum(dim=1) >= k - valid).all()
    if kind == "ascending" and k == 129:
        # every column enters: a cut after each tile once a buffer holds
        # cap - 128 = 256 keys (6 in each full split, 2 in the last)
        assert stats["cuts"] == b * 14, stats
    if kind == "signed_zero":
        assert (torch.signbit(ev) & (ev == 0)).any()   # -0.0 among the best
        assert ((ev == 0) & ~torch.signbit(ev)).any()
    if kind == "constant":                    # every score ties
        for r in range(b):
            want = [c for c in range(valid) if c != excl[r]][:k]
            assert ei[r, :len(want)].tolist() == want


@pytest.mark.parametrize("k", [129, 200])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("exact", [True, False])
def test_emulated_large_k_many_cuts_at_the_least_capacity(kind, k, exact):
    """cap = k + 128, the least the kernel takes: a buffer is cut after
    nearly every tile it grows in; the answer stays the plain version's."""
    b = 5
    feats, q, excl = large_inputs(kind, N, b, seed=k, edges=(1408,))
    args = kernel3_args(feats, q, excl, exact=exact, valid=N - 3)
    ev, ei, stats = emulate_large_k(*args, k=k, exact=exact, nsplit=2,
                                    split_cols=1408, cap=k + _TC)
    pv, pi = fused_topk_plain(*args, k=k, exact=exact)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)
    assert torch.equal(torch.signbit(ev), torch.signbit(pv))
    if kind in ("ascending", "duplicates"):
        assert stats["cuts"] >= b * 2 * 3, stats
    if not exact:
        assert stats["divisions"] == 0


def test_emulated_large_k_spares_divisions_on_random_rows():
    """On random rows, two splits of 4096 columns: the filter against the
    buffer's threshold spares most divisions (a split's first k columns
    all enter, then ever fewer)."""
    n = 8000
    rng = np.random.default_rng(3)
    feats = rng.random((n, 12), dtype=F32)
    q = feats[rng.integers(0, n, 4)]
    excl = np.full(4, -1, np.int64)
    args = kernel3_args(feats, q, excl, exact=True)
    ev, ei, stats = emulate_large_k(*args, k=129, exact=True, nsplit=2,
                                    split_cols=4096)
    pv, pi = fused_topk_plain(*args, k=129, exact=True)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)
    assert stats["divisions"] < 0.25 * 4 * n, stats
    assert stats["entries"] <= stats["divisions"]


def test_capacity_and_plan():
    """cap = 2k rounded up to a tile, at least three tiles (>= k + 128 and
    >= the merge's sort of a power of two >= k, at every k); the plan
    keeps its scratch under max(64 MiB, four blocks a SM), and splits at
    least 8k columns wide."""
    for k in (1, 10, 127, 128, 129, 256, 1000, 4096, 20004, 100_000):
        cap = large_capacity(k)
        assert cap % _TC == 0 and cap >= k + _TC
        assert cap == -(-max(2 * k, 3 * _TC) // _TC) * _TC
        assert cap >= 1 << (k - 1).bit_length()
    chunk, nsplit, cols, cap = _large_plan(1024, 10**6, CPU, fq=12, k=1000,
                                           exact=True, bf16=False)
    assert (chunk, nsplit, cap) == (1024, 8, 2048)
    assert chunk * nsplit * cap * 8 <= max(64 << 20, 4 * 132 * 16 * cap * 8)
    chunk, nsplit, cols, cap = _large_plan(100_000, 10**6, CPU, fq=12,
                                           k=4096, exact=True, bf16=False)
    assert chunk < 100_000 and nsplit == 1          # batch chunks
    assert chunk * cap * 8 == LARGE_SCRATCH_CEILING   # four blocks a SM
    _, nsplit, cols, _ = _large_plan(1, 10**6, CPU, fq=12, k=1000,
                                     exact=True, bf16=False)
    assert cols >= 8 * 1000 and nsplit * cols >= 10**6



@pytest.mark.parametrize("k,chunk,nsplit", [(10**4, 1024, 3),
                                            (10**5, 320, 1),
                                            (3 * 10**6, 16, 1)])
def test_large_plan_keeps_its_scratch_under_the_ceiling(k, chunk, nsplit):
    """B = 1024 on 10M columns: past k = 4096 four blocks a SM would need
    more than LARGE_SCRATCH_CEILING (512 MiB), so fewer splits (k = 10^4:
    3 of 8k columns and more, 192 blocks), then batch chunks (k = 10^5: 20
    query tiles a launch), keep the scratch under it; one block's buffers
    (16 x cap keys) pass it only where they alone do (k = 3e6)."""
    plan = _large_plan(1024, 10**7, CPU, fq=12, k=k, exact=True, bf16=False)
    assert plan[:2] == (chunk, nsplit)
    cols, cap = plan[2:]
    assert nsplit * cols >= 10**7 and (cols >= 8 * k or nsplit == 1)
    block = 16 * cap * 8
    assert chunk * nsplit * cap * 8 <= max(LARGE_SCRATCH_CEILING, block)
    # one more split, or in a chunked batch one more tile, would pass it
    assert chunk // 16 * (nsplit + 1) * block > LARGE_SCRATCH_CEILING
    assert chunk == 1024 or (chunk // 16 + 1) * block > LARGE_SCRATCH_CEILING

def test_cpu_tensors_take_any_k_through_the_plain_version():
    """On CPU tensors both wrappers run the plain version at any k >= 1,
    and neither counts a launch."""
    feats, q, excl = tie_inputs("duplicates", 400, 3, seed=2)
    args = kernel3_args(feats, q, excl, exact=True, valid=390)
    before = (fused_topk.launches, fused_topk_large.launches)
    for k in (1, SMALL_K_MAX, SMALL_K_MAX + 1, 390, 1000):
        for fn in (fused_topk, fused_topk_large):
            v, i = fn(*args, k=k, exact=True)
            pv, pi = fused_topk_plain(*args, k=k, exact=True)
            assert torch.equal(i, pi) and torch.equal(v, pv)
            assert v.shape == (3, k)
    assert (fused_topk.launches, fused_topk_large.launches) == before
    with pytest.raises(ValueError, match="k >= 1"):
        fused_topk(*args, k=0, exact=True)
