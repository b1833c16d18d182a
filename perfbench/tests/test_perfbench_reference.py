"""The plain reference against a NumPy brute force at small sizes, with
ties (lowest row first) and self-exclusion; its TF32 control."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import cosine_topk, tower


def brute_force(cat: np.ndarray, q: np.ndarray, excl: np.ndarray, k: int):
    """float64 cosines, one query at a time, ranked by (-score, row)."""
    cat = cat.astype(np.float64)
    q = q.astype(np.float64)
    out_s, out_i = [], []
    for j in range(q.shape[0]):
        sc = []
        for r in range(cat.shape[0]):
            if r == excl[j]:
                continue
            d = np.linalg.norm(q[j]) * np.linalg.norm(cat[r])
            s = np.clip(q[j] @ cat[r] / d, -1, 1) if d > 1e-8 else 0.0
            sc.append((-s, r))
        sc.sort()
        out_s.append([-s for s, _ in sc[:k]])
        out_i.append([r for _, r in sc[:k]])
    return np.asarray(out_s), np.asarray(out_i)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_brute_force_with_ties(seed):
    rng = np.random.default_rng(seed)
    # few distinct rows, many repeated: ties everywhere; a zero row scores 0
    base = rng.random((7, 5), dtype=np.float32)
    cat = base[rng.integers(0, 7, 300)]
    cat[17] = 0.0
    q = cat[rng.integers(0, 300, 9)]
    excl = rng.integers(-1, 300, 9)
    for k in (1, 10, 40):
        s, i = cosine_topk.reference_topk(torch.from_numpy(cat),
                                          torch.from_numpy(q),
                                          torch.from_numpy(excl), k, block=4)
        bs, bi = brute_force(cat, q, excl, k)
        np.testing.assert_array_equal(i.numpy(), bi)
        np.testing.assert_allclose(s.numpy(), bs, rtol=0, atol=1e-15)


def test_reference_scores_and_exclusion():
    rng = np.random.default_rng(3)
    cat = rng.random((500, 12), dtype=np.float32)
    rows = rng.integers(0, 500, 16)
    q, excl = torch.from_numpy(cat[rows]), torch.from_numpy(rows)
    s, i = cosine_topk.reference_topk(torch.from_numpy(cat), q, excl, 10)
    assert not (i == excl[:, None]).any()               # itself excluded
    again = cosine_topk.reference_scores(torch.from_numpy(cat), q, i)
    assert torch.equal(again, s)
    assert (s[:, :-1] >= s[:, 1:]).all()


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0000002,
                      1.0 + 2**-12])
    r = cosine_topk.round_tf32(x)
    # ties to even at the 10th mantissa bit, magnitudes for negatives
    assert r.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0, 1.0]
    y = torch.rand(10000) * 7 - 3
    rel = ((cosine_topk.round_tf32(y) - y).abs() / y.abs()).max()
    assert rel <= 2**-11


def test_control_differs_from_reference():
    rng = np.random.default_rng(4)
    cat = torch.from_numpy(rng.random((3000, 12), dtype=np.float32))
    rows = torch.from_numpy(rng.integers(0, 3000, 32))
    rs, ri = cosine_topk.reference_topk(cat, cat[rows], rows, 10)
    cs, ci = cosine_topk.control_topk(cat, cat[rows], rows, 10)
    served = cosine_topk.reference_scores(cat, cat[rows], ci)
    assert (cs.double() - served).abs().max() > 1e-5


def test_tower_embeddings_unit_norm_and_seeded():
    g = torch.Generator().manual_seed(5)
    layers = tower.draw_weights([12, 256, 128, 64], g, torch.device("cpu"))
    x = torch.rand((1000, 12), generator=g)
    e = tower.embed(x, layers, block=300)
    assert e.shape == (1000, 64)
    torch.testing.assert_close(torch.linalg.vector_norm(e, dim=1),
                               torch.ones(1000))
    g2 = torch.Generator().manual_seed(5)
    layers2 = tower.draw_weights([12, 256, 128, 64], g2, torch.device("cpu"))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(layers, layers2))
