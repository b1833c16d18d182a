"""Kernel 3's selection (csrc/fused_topk.cu) on the CPU.

- `filter_pass`, the kernel's filter and the exact instances' rule for
  where to divide: it never rules out a column whose score (0 where
  rn(qn * cn) <= eps, else the clamped rn(dot / rn(qn * cn))) exceeds the
  k-th best t, on seeded fp32 draws, hypothesis draws and the edge cases
  (t at the quotient and its neighbours, t = -1, t >= 1, den just above
  eps, zero norms, subnormal dots, negative t with positive dots).
- `emulate_kernel3`, the kernel's selection structure in torch: warp-
  private top-k lists over the interleaved columns of each catalog split,
  the block's fold of its 4 warp lists, the merge of the splits.  On tie-
  heavy catalogs it equals `fused_topk_plain` index for index and bit for
  bit, which is the tie argument of the kernel's notes shown on the CPU.

Imports nothing of JAX: tests/test_torch_cuda.py takes its tie-heavy
inputs (`tie_inputs`) from here on the card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spotify_recommender_tpu_torch.core.config import COSINE_EPS
from spotify_recommender_tpu_torch.ops.cuda.fused import (
    _TC,
    _splits,
    filter_pass,
    fused_topk_plain,
)

F32 = np.float32
EPS32 = F32(COSINE_EPS)
WARPS = 4                       # warps of a kernel-3 block
TIE_KINDS = ("constant", "duplicates", "zero_norm")


def tie_inputs(kind, n, b, seed, edges=()):
    """(features (n, 12), queries (b, 12), excl (b,) int64) of a tie-heavy
    catalog, numpy fp32:

    - "constant": every row the same, so every score ties and the answer
      is the lowest columns not excluded;
    - "duplicates": the queries' own rows copied to both sides of every
      warp edge (columns 32m - 1 and 32m) and of each column in `edges`
      (the split edges), so equal top scores straddle the edges;
    - "zero_norm": negative queries against a positive catalog with a
      zero row every 29 columns and at each edge: the zero rows score 0
      (ties), every other row below 0.
    """
    rng = np.random.default_rng(seed)
    feats = (rng.random((n, 12), dtype=F32) + F32(0.1)).astype(F32)
    rows = rng.integers(0, n, b)
    excl = np.where(np.arange(b) % 2 == 0, rows, -1).astype(np.int64)
    if kind == "constant":
        feats[:] = F32(0.5)
        excl[:] = np.arange(b) % 5
        return feats, rng.random((b, 12), dtype=F32) + F32(0.1), excl
    cuts = sorted({*range(32, n, 32), *(e for e in edges if 0 < e < n)})
    if kind == "duplicates":
        q = feats[rows].copy()
        for i, e in enumerate(cuts):
            feats[e - 1] = feats[e] = q[i % b]
        return feats, q, excl
    if kind == "zero_norm":
        feats[::29] = 0.0
        feats[np.asarray(cuts[::3])] = 0.0
        return feats, -rng.random((b, 12), dtype=F32), excl
    raise ValueError(kind)


def kernel3_args(feats, q, excl, exact, valid=None):
    """fused_topk's arguments on the CPU: raw rows (exact) or unit rows
    and queries (prenormalized), the transposed catalog, raw norms."""
    f, qt = torch.from_numpy(feats), torch.from_numpy(q)
    norms = torch.linalg.vector_norm(f, dim=1)
    qn = torch.linalg.vector_norm(qt, dim=1)
    if not exact:
        f = f / norms.clamp_min(1e-30)[:, None]
        qt = qt / qn.clamp_min(1e-30)[:, None]
    return (qt.contiguous(), qn, f.t().contiguous(), norms,
            torch.from_numpy(excl), feats.shape[0] if valid is None else valid)


def _ranked(v, c, k):
    """The first k of (v, c) along the last axis by value descending,
    column ascending."""
    o = torch.argsort(c, dim=-1, stable=True)
    v, c = v.gather(-1, o), c.gather(-1, o)
    o = torch.argsort(v, dim=-1, descending=True, stable=True)
    return v.gather(-1, o)[..., :k], c.gather(-1, o)[..., :k]


def emulate_kernel3(queries, q_norms, features_t, norms, excl, valid, *, k,
                    exact, eps=COSINE_EPS):
    """Kernel 3's selection in torch: ((B, k) values, (B, k) columns,
    divisions made).  The catalog splits as `fused_topk` splits it on an
    H100; warp w of split s walks columns s*split_cols + 128*tile + 32*w +
    lane in ascending order and keeps, per query, a sorted top-k of its
    own columns with the kernel's strict `>` insert after the entries >=
    the new value, skipping a score below the block's floor (the least of
    the block's warps' ceil(k/4)-th best values, taken in lockstep here); a
    column gets its score (exact mode: divides) only
    where `filter_pass` lets it through.  All lists step together, one
    column each per step."""
    b, fq = queries.shape
    fc, np_ = features_t.shape
    nsplit, split_cols = _splits(b, np_, torch.device("cpu"))
    q, ft = queries.float(), features_t.float()
    dots = q[:, 0:1] * ft[0:1]                   # the kernel's chain
    for d in range(1, fq):
        dots = dots + q[:, d:d + 1] * ft[d % fc:d % fc + 1]
    den = q_norms[:, None] * norms[None, :]
    cols = torch.arange(np_)
    bad = (cols >= valid)[None, :] | (cols[None, :] == excl[:, None])
    j = torch.arange(split_cols // WARPS)
    colmap = (torch.arange(nsplit)[:, None, None] * split_cols
              + (j // 32) * _TC + 32 * torch.arange(WARPS)[None, :, None]
              + j % 32).reshape(nsplit * WARPS, -1)     # (lists, steps)
    lv = torch.full((nsplit * WARPS, b, k), float("-inf"))
    lc = torch.full((nsplit * WARPS, b, k), -1, dtype=torch.int64)
    slot = torch.arange(k)
    kq = -(-k // WARPS)
    divisions = 0
    for step in range(colmap.shape[1]):
        c = colmap[:, step]
        live = c < np_
        cc = c.clamp(max=np_ - 1)
        dot, dn = dots[:, cc].t(), den[:, cc].t()       # (lists, B)
        ok = live[:, None] & ~bad[:, cc].t()
        t = lv[:, :, k - 1]
        # the block's floor: each warp's ceil(k/4)-th best, their minimum
        floor = lv[:, :, kq - 1].reshape(nsplit, WARPS, b).amin(1)
        floor = floor.repeat_interleave(WARPS, 0)
        guard = dn > eps
        cand = ok & filter_pass(dot, q_norms[None, :], norms[cc][:, None], t,
                                exact, floor)
        if exact:
            divisions += int((cand & guard).sum())
            x = dot / torch.where(guard, dn, 1.0)
        else:
            x = dot
        x = torch.where(guard, torch.clamp(x, -1.0, 1.0), 0.0)
        x = torch.where(cand, x, float("-inf"))
        enter = ((x > t) & (x >= floor))[..., None]
        pos = (lv >= x[..., None]).sum(-1, keepdim=True)
        shift_v = torch.cat([lv[..., :1], lv[..., :-1]], -1)
        shift_c = torch.cat([lc[..., :1], lc[..., :-1]], -1)
        new_v = torch.where(slot < pos, lv,
                            torch.where(slot == pos, x[..., None], shift_v))
        new_c = torch.where(slot < pos, lc,
                            torch.where(slot == pos, c[:, None, None], shift_c))
        lv = torch.where(enter, new_v, lv)
        lc = torch.where(enter, new_c, lc)
    # the block's fold of its warp lists, then the merge of the splits
    lv = lv.reshape(nsplit, WARPS, b, k).permute(0, 2, 1, 3)
    lc = lc.reshape(nsplit, WARPS, b, k).permute(0, 2, 1, 3)
    fv, fcol = _ranked(lv.reshape(nsplit, b, WARPS * k),
                       lc.reshape(nsplit, b, WARPS * k), k)
    ov, oc = _ranked(fv.permute(1, 0, 2).reshape(b, nsplit * k),
                     fcol.permute(1, 0, 2).reshape(b, nsplit * k), k)
    return ov, oc.masked_fill(ov == float("-inf"), -1), divisions


# ---- the filter and the division rule

def _assert_never_skips_an_entry(dot, qn, cn, t, exact=True, floor=None):
    """Every (dot, qn, cn, t, floor) whose score exceeds t and is at or
    above the floor passes the filter; returns (passes, enters)."""
    floor = np.full(len(dot), -np.inf) if floor is None else floor
    dot, qn, cn, t, floor = (torch.as_tensor(np.asarray(a, F32))
                             for a in (dot, qn, cn, t, floor))
    den = qn * cn
    x = dot / torch.where(den > EPS32, den, 1.0) if exact else dot
    score = torch.where(den > EPS32, torch.clamp(x, -1.0, 1.0), 0.0)
    enters = (score > t) & (score >= floor)
    passes = filter_pass(dot, qn, cn, t, exact, floor)
    missed = enters & ~passes
    assert not bool(missed.any()), [a[missed] for a in (dot, qn, cn, t, floor)]
    return passes, enters


@pytest.mark.parametrize("exact", [True, False])
def test_filter_seeded_draws(exact):
    rng = np.random.default_rng(0)
    m = 400_000
    qn = (10.0 ** rng.uniform(-3, 3, m)).astype(F32)
    cn = (10.0 ** rng.uniform(-6, 3, m)).astype(F32)
    cn[::97] = 0.0
    den = (qn * cn).astype(F32)
    dot = (den * rng.uniform(-1.3, 1.3, m)).astype(F32)
    t = rng.uniform(-1, 1, m).astype(F32)
    t[::50] = -np.inf
    # thresholds at the score and its fp32 neighbours: the tightest cases
    r = m // 4
    with np.errstate(divide="ignore", invalid="ignore"):
        x = (dot[:r] / den[:r]).astype(F32) if exact else dot[:r]
    x = np.where(den[:r] > EPS32, np.clip(x, -1, 1), F32(0))
    t[r:2 * r] = x
    t[2 * r:3 * r] = np.nextafter(x, F32(-np.inf))
    t[3 * r:] = np.nextafter(x, F32(np.inf))
    for a in (dot, qn, cn):
        a[r:] = np.concatenate([a[:r]] * 3)
    passes, enters = _assert_never_skips_an_entry(dot, qn, cn, t, exact)
    # the block's floor at the score and its neighbours, t below it
    _assert_never_skips_an_entry(dot, qn, cn, np.minimum(t, F32(-0.5)), exact,
                                 floor=t)
    # and it rules out nearly every column that cannot enter where t is a
    # normal positive float not within a few ulps of the score
    far = torch.from_numpy((t[:r] >= 2.0**-60) & (den[:r] > EPS32))
    ruled_out = (~passes[:r] & far).sum().item()
    assert ruled_out >= 0.99 * (~enters[:r] & far).sum().item(), ruled_out


def test_filter_edge_cases():
    eps_up = np.nextafter(EPS32, F32(1))
    tiny = np.float32(1e-45)                      # the smallest subnormal
    third = F32(1.0) / F32(3.0)
    cases = [  # (dot, qn, cn, t)
        (0.5, 1.0, 1.0, 0.5), (0.5, 1.0, 1.0, np.nextafter(F32(0.5), F32(0))),
        (0.5, 1.0, 1.0, np.nextafter(F32(0.5), F32(1))),
        (1.0, 3.0, 1.0, third), (1.0, 1.0, 3.0, np.nextafter(third, F32(0))),
        (1.0, 1.5, 2.0, np.nextafter(third, F32(0))),
        (-2.0, 1.0, 1.0, -1.0), (-0.5, 1.0, 1.0, -1.0), (-1.0, 1.0, 1.0, -1.0),
        (5.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0), (2.0, 1.0, 1.0, 1.5),
        (1e-8, eps_up, 1.0, 0.9), (2e-8, 1.0, eps_up, 0.99),
        (-1e-8, eps_up, 1.0, -1.0), (tiny, eps_up, 1.0, 0.0),
        (-tiny, 1.0, eps_up, -1e-37), (tiny, 1.0, 1.0, 0.0),
        (tiny, 1.0, 1.0, -tiny), (1e-40, eps_up, 1.0, 1e-32),
        (2e-18, 1.0, 1e-17, 0.1), (0.0, 1.0, 1.0, -0.0),
        (0.3, 2.0, 1.0, -0.5), (1e-20, 1e-3, 1.0, -1e-30),
        (0.7, 0.7, 1.0, 0.99999994), (0.0, 1.0, 0.0, -0.5),   # zero norm
        (0.0, 1.0, 0.0, 0.5), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 1.0, -0.1),
        (3e19, 1e19, 3e18, 0.5), (-3e19, 1e19, 1e-27, 0.5),
        (0.1, 1e4, 1.0, -np.inf), (-0.1, 1.0, 1e4, -np.inf),
    ]
    dot, qn, cn, t = zip(*cases)
    for exact in (True, False):
        # t as the block's floor: a score equal to it passes
        _assert_never_skips_an_entry(dot, qn, cn, [-np.inf] * len(t), exact,
                                     floor=np.minimum(t, F32(1)))
        passes, enters = _assert_never_skips_an_entry(dot, qn, cn, t, exact)
        got = dict(zip(cases, passes.tolist()))
        assert not got[(5.0, 1.0, 1.0, 1.0)] and not got[(2.0, 1.0, 1.0, 1.5)]
        assert got[(0.1, 1e4, 1.0, -np.inf)] and got[(0.0, 1.0, 0.0, -0.5)]
        assert not got[(0.0, 0.0, 1.0, 0.0)]      # a zero query, t >= 0
        assert enters.sum().item() >= 5
    # exact: a column well below the bound gets no division
    assert not got[(2e-18, 1.0, 1e-17, 0.1)] or not exact


_f32 = dict(width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=500, deadline=None, derandomize=True)
@given(dot=st.floats(**_f32),
       qn=st.floats(min_value=0.0, max_value=2.0**60, width=32),
       cn=st.floats(min_value=0.0, max_value=2.0**60, width=32),
       t=st.one_of(st.just(float("-inf")),
                   st.floats(min_value=-1.0, max_value=1.0, width=32)),
       floor=st.one_of(st.just(float("-inf")),
                       st.floats(min_value=-1.0, max_value=1.0, width=32)),
       exact=st.booleans())
def test_filter_hypothesis(dot, qn, cn, t, floor, exact):
    _assert_never_skips_an_entry([dot], [qn], [cn], [t], exact, [floor])


# ---- the selection structure against the plain version

@pytest.mark.parametrize("b", [1, 5, 17])
@pytest.mark.parametrize("kind", TIE_KINDS)
@pytest.mark.parametrize("k", [1, 32, 33, 64, 65, 128])
def test_emulated_selection_equals_plain_on_ties(k, kind, b):
    n = 2600                      # 3 splits at every B here: 1024, 1024, 552
    edges = range(0, n, _splits(b, n, torch.device("cpu"))[1])
    feats, q, excl = tie_inputs(kind, n, b, seed=k + b, edges=edges)
    args = kernel3_args(feats, q, excl, exact=True, valid=n - 5)
    ev, ei, divisions = emulate_kernel3(*args, k=k, exact=True)
    pv, pi = fused_topk_plain(*args, k=k, exact=True)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)
    assert (ei < n - 5).all()
    if kind == "constant":       # every score ties: the lowest columns
        for r in range(b):
            want = [c for c in range(k + 1) if c != excl[r]][:k]
            assert ei[r].tolist() == want
    if kind == "duplicates" and k <= 33:
        # the filter spares most divisions once the lists are full (on the
        # constant catalog the k-th best is the score itself, and on the
        # zero-norm one it stays <= 0, so there every column is let
        # through; at k >= 64 a warp's 217 columns barely fill its lists)
        assert divisions < 0.5 * b * n, divisions


@pytest.mark.parametrize("kind", TIE_KINDS)
@pytest.mark.parametrize("k", [1, 33, 128])
def test_emulated_selection_equals_plain_prenormalized(k, kind):
    n, b = 2600, 5
    edges = range(0, n, _splits(b, n, torch.device("cpu"))[1])
    feats, q, excl = tie_inputs(kind, n, b, seed=7 * k, edges=edges)
    args = kernel3_args(feats, q, excl, exact=False)
    ev, ei, divisions = emulate_kernel3(*args, k=k, exact=False)
    pv, pi = fused_topk_plain(*args, k=k, exact=False)
    assert divisions == 0
    assert torch.equal(ei, pi) and torch.equal(ev, pv)


def test_emulated_selection_fewer_valid_columns_than_k():
    feats, q, excl = tie_inputs("duplicates", 300, 3, seed=1)
    args = kernel3_args(feats, q, excl, exact=True, valid=40)
    ev, ei, _ = emulate_kernel3(*args, k=64, exact=True)
    pv, pi = fused_topk_plain(*args, k=64, exact=True)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)
    assert torch.equal(ei == -1, ev == float("-inf"))
    assert ((ei == -1).sum(dim=1) >= 64 - 40).all()
