"""The port's matrix-factorization path (`models/mf.py`,
`ops/similarity.mips_topk_chunked`, `experiments/als_scale_1m.py`) against
the JAX package's, on the CPU: the same seeded numpy inputs through both.

Tolerances (fp32 on both sides, other summation orders): one ALS half-step
1e-5 (measured 6.6e-7); `train_als`, 6 iterations at the benchmark quality
row's shapes, factors 5e-5 (measured 6.9e-6) and recall@10 / NDCG@10 1e-4;
MIPS scores 1e-6 with equal indices; SGD parameters 1e-5 at batch 8192
over 20 steps at lr 0.01 on the quality row's data.  Where a gradient
coordinate cancels to Adam's eps, Adam turns the packages' different
rounding of that sum into a step of up to lr, so at batch 256, and at
config 3's size at the default lr, parameters agree to 1e-5 for one step
only; there the per-step losses are held instead
(`test_train_sgd_matches_jax`, `test_train_sgd_default_lr_at_config3_matches_jax`).
"""

import importlib.util
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import MFConfig as JMFConfig
from spotify_recommender_tpu.models import mf as jmf
from spotify_recommender_tpu.ops.similarity import (
    mips_topk_chunked as jmips_topk_chunked,
)
from spotify_recommender_tpu_torch.core.config import MFConfig
from spotify_recommender_tpu_torch.experiments import als_scale_1m
from spotify_recommender_tpu_torch.models import mf
from spotify_recommender_tpu_torch.ops.similarity import mips_topk_chunked

CPU = "cpu"
QUALITY = dict(embedding_dim=16, num_iterations=6, reg=0.05, alpha=10.0, seed=0)
EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"


def _t(x):
    return torch.from_numpy(np.asarray(x))


def assert_inter_equal(a, b):
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    for f in ("item_idx", "confidence", "mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.fixture(scope="module")
def quality():
    """The benchmark quality row's data and both packages' 6-iteration
    ALS factors."""
    inter, _, _ = mf.synthetic_interactions(2000, 1000, 8, seed=0)
    split = mf.split_leave_k_out_arrays(inter, k=1, seed=0)
    ju, ji = jmf.train_als(split[0], JMFConfig(**QUALITY))
    tu, ti = mf.train_als(split[0], MFConfig(**QUALITY), device=CPU)
    return split, (np.asarray(ju), np.asarray(ji)), (tu, ti)


# -------------------------------------------------------------- host data


@pytest.mark.parametrize("seed,max_degree", [(0, None), (1, 3), (2, 1)])
def test_from_coo_bitwise(seed, max_degree):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 50, 400)
    items = rng.integers(0, 70, 400)
    counts = rng.integers(1, 9, 400).astype(np.float32)
    assert_inter_equal(
        mf.Interactions.from_coo(users, items, counts, 60, 80, max_degree),
        jmf.Interactions.from_coo(users, items, counts, 60, 80, max_degree))


@pytest.mark.parametrize("max_degree", [None, 4])
def test_transpose_bitwise(max_degree):
    inter, _, _ = mf.synthetic_interactions(120, 60, 4, density=0.06, seed=3)
    jinter, _, _ = jmf.synthetic_interactions(120, 60, 4, density=0.06, seed=3)
    assert_inter_equal(inter.transpose(max_degree), jinter.transpose(max_degree))


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_interactions_bitwise(seed):
    a, tu, ti = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=seed)
    b, ju, ji = jmf.synthetic_interactions(300, 200, 6, density=0.05, seed=seed)
    assert_inter_equal(a, b)
    assert np.array_equal(tu, ju) and np.array_equal(ti, ji)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_split_leave_k_out_arrays_bitwise(k):
    inter, _, _ = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=1)
    ours = mf.split_leave_k_out_arrays(inter, k=k, seed=4)
    theirs = jmf.split_leave_k_out_arrays(inter, k=k, seed=4)
    assert_inter_equal(ours[0], theirs[0])
    for a, b in zip(ours[1:], theirs[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_split_leave_k_out_dicts_equal():
    inter, _, _ = mf.synthetic_interactions(200, 100, 6, density=0.05, seed=2)
    train, held, seen = mf.split_leave_k_out(inter, k=2, seed=0)
    jtrain, jheld, jseen = jmf.split_leave_k_out(inter, k=2, seed=0)
    assert_inter_equal(train, jtrain)
    for ours, theirs in ((held, jheld), (seen, jseen)):
        assert ours.keys() == theirs.keys()
        assert all(np.array_equal(ours[u], theirs[u]) for u in ours)


@pytest.mark.parametrize("width", [None, 2])
def test_pad_ragged_bitwise(width):
    rows = {0: np.asarray([4, 1, 7]), 3: np.asarray([2]), 5: np.asarray([], np.int64)}
    keys = [0, 1, 3, 5]
    for a, b in zip(mf._pad_ragged(rows, keys, width),
                    jmf._pad_ragged(rows, keys, width)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n,md,d", [(10, 3, 8), (1_000_000, 16, 64), (50_000, 400, 32)])
def test_als_block_rows_equal(n, md, d):
    assert mf._als_block_rows(n, md, d) == jmf._als_block_rows(n, md, d)


# -------------------------------------------------------------- ALS


def _half_inputs(seed, n, m, md, d):
    rng = np.random.default_rng(seed)
    other = (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)
    idx = rng.integers(0, m, (n, md)).astype(np.int32)
    conf = (1 + rng.poisson(2.0, (n, md))).astype(np.float32)
    mask = rng.random((n, md)) < 0.7
    mask[:3] = False                     # fully masked rows solve to 0
    x0 = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    return other, idx, conf, mask, x0


@pytest.mark.parametrize("solve_block", [0, 128, 333])
@pytest.mark.parametrize("d", [8, 16])
def test_als_solve_matches_jax(solve_block, d):
    other, idx, conf, mask, _ = _half_inputs(d + solve_block, 700, 300, 9, d)
    ours = mf._als_solve(_t(other), _t(idx), _t(conf), _t(mask), 0.05, 10.0,
                         solve_block=solve_block)
    theirs = np.asarray(jmf._als_solve(*map(jnp.asarray, (other, idx, conf, mask)),
                                       0.05, 10.0, solve_block=solve_block))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)
    assert not ours[:3].any()


def test_full_subspace_equals_full_solve():
    other, idx, conf, mask, x0 = _half_inputs(7, 400, 200, 9, 8)
    args = (_t(other), _t(idx), _t(conf), _t(mask))
    full = mf._als_solve(*args, 0.05, 10.0)
    pp = mf._als_pp_solve(*args, _t(x0), 0.05, 10.0, subspace=8)
    np.testing.assert_allclose(pp.numpy(), full.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("subspace,solve_block", [(4, 0), (4, 96), (2, 0), (8, 150)])
def test_als_pp_solve_matches_jax(subspace, solve_block):
    other, idx, conf, mask, x0 = _half_inputs(subspace, 500, 200, 9, 8)
    ours = mf._als_pp_solve(_t(other), _t(idx), _t(conf), _t(mask), _t(x0),
                            0.05, 10.0, subspace, solve_block=solve_block)
    theirs = np.asarray(jmf._als_pp_solve(
        *map(jnp.asarray, (other, idx, conf, mask, x0)), 0.05, 10.0, subspace,
        solve_block=solve_block))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)


def test_subspace_must_divide_the_dim():
    other, idx, conf, mask, x0 = _half_inputs(0, 20, 30, 4, 8)
    with pytest.raises(ValueError, match="must divide"):
        mf._als_pp_solve(_t(other), _t(idx), _t(conf), _t(mask), _t(x0),
                         0.05, 10.0, subspace=3)


def test_failed_cholesky_raises():
    """lambda = 0 and a zero column make every normal matrix singular
    (JAX returns NaN rows there; the port raises)."""
    other, idx, conf, mask, _ = _half_inputs(1, 50, 30, 4, 8)
    other[:, 3] = 0.0
    with pytest.raises(torch.linalg.LinAlgError, match="Cholesky"):
        mf._als_solve(_t(other), _t(idx), _t(conf), _t(mask), 0.0, 10.0)


def test_train_als_quality_row_matches_jax(quality):
    """The benchmark quality row's ALS in both packages: factors to 5e-5,
    recall@10 / NDCG@10 to 1e-4 (0.5916380 / 0.4063576 in both)."""
    (_, held_idx, held_mask, seen_idx, seen_mask), (ju, ji), (tu, ti) = quality
    np.testing.assert_allclose(tu, ju, rtol=0, atol=5e-5)
    np.testing.assert_allclose(ti, ji, rtol=0, atol=5e-5)
    el = np.nonzero(held_mask.any(1))[0]
    args = (el, held_idx[el], held_mask[el])
    kw = dict(k=10, seen_idx=seen_idx[el], seen_mask=seen_mask[el])
    mt = mf.evaluate_ranking_arrays(tu, ti, *args, **kw, device=CPU)
    mj = jmf.evaluate_ranking_arrays(ju, ji, *args, **kw)
    assert mt["num_eval_users"] == mj["num_eval_users"] == 1746
    for key, want in (("recall@k", 0.5916380), ("ndcg@k", 0.4063576)):
        assert abs(mt[key] - mj[key]) <= 1e-4
        assert abs(mt[key] - want) <= 1e-4


def test_train_als_subspace_matches_jax():
    inter, _, _ = mf.synthetic_interactions(400, 200, 6, density=0.05, seed=2)
    cfg = dict(embedding_dim=8, num_iterations=3, reg=0.1, alpha=5.0)
    tu, ti = mf.train_als(inter, MFConfig(**cfg), subspace=4, device=CPU)
    ju, ji = jmf.train_als(inter, JMFConfig(**cfg), subspace=4)
    np.testing.assert_allclose(tu, np.asarray(ju), rtol=0, atol=5e-5)
    np.testing.assert_allclose(ti, np.asarray(ji), rtol=0, atol=5e-5)


def test_train_als_stats_and_callback():
    inter, _, _ = mf.synthetic_interactions(100, 50, 4, density=0.1, seed=0)
    stats, seen = {}, []
    mf.train_als(inter, MFConfig(embedding_dim=8, num_iterations=3), device=CPU,
                 stats=stats, callback=lambda it, u, i: seen.append(
                     (it, tuple(u.shape), tuple(i.shape))))
    assert seen == [(it, (100, 8), (50, 8)) for it in range(3)]
    assert sorted(stats) == ["chol_ms", "item_ms", "user_ms"]
    assert all(len(v) == 3 and min(v) >= 0 for v in stats.values())
    assert all(c <= u + i for c, u, i in
               zip(stats["chol_ms"], stats["user_ms"], stats["item_ms"]))


@pytest.mark.parametrize("train,kw", [
    (mf.train_als, {"mesh": object()}),
    (mf.train_als, {"shard_tables": True}),
    (mf.train_sgd, {"mesh": object()}),
])
def test_a_mesh_raises(train, kw):
    inter, _, _ = mf.synthetic_interactions(50, 30, 4, density=0.1, seed=0)
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 6"):
        train(inter, MFConfig(embedding_dim=4), device=CPU, **kw)


# -------------------------------------------------------------- SGD


def test_sgd_loss_and_grads_match_jax():
    import jax

    rng = np.random.default_rng(0)
    users = rng.standard_normal((40, 8)).astype(np.float32)
    items = rng.standard_normal((30, 8)).astype(np.float32)
    u, i = rng.integers(0, 40, 64), rng.integers(0, 30, 64)
    conf = rng.integers(1, 5, 64).astype(np.float32)
    neg = rng.integers(0, 30, (64, 4))
    jl, jg = jax.value_and_grad(jmf._sgd_loss)(
        {"users": users, "items": items}, u, i, conf, neg, 0.01, 2.0)
    params = {"users": _t(users).requires_grad_(), "items": _t(items).requires_grad_()}
    loss = mf._sgd_loss(params, _t(u), _t(i), _t(conf), _t(neg), 0.01, 2.0)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for name in ("users", "items"):
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   np.asarray(jg[name]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg,steps", [
    (dict(embedding_dim=16, reg=0.05, alpha=10.0, learning_rate=0.01), 20),
    (dict(embedding_dim=8, reg=0.01, alpha=2.0, learning_rate=0.05,
          batch_size=256), 1),
])
def test_train_sgd_matches_jax(cfg, steps):
    """20 steps at the default batch: parameters to 1e-5 (measured 2.3e-6).
    At batch 256, 1 step (measured 3.6e-7); after 5 steps there 4 of 8000
    item parameters differ by more than 1e-5, after 20 steps up to 1.9e-2:
    Adam scales a cancelling gradient sum, whose rounding differs between
    the packages, to a step of about lr."""
    inter, _, _ = mf.synthetic_interactions(2000, 1000, 8, seed=0)
    losses = []
    tu, ti = mf.train_sgd(inter, MFConfig(**cfg), num_steps=steps,
                          device=CPU, losses=losses)
    ju, ji = jmf.train_sgd(inter, JMFConfig(**cfg), num_steps=steps)
    np.testing.assert_allclose(tu, np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ti, np.asarray(ji), rtol=0, atol=1e-5)
    assert len(losses) == steps and np.isfinite(losses).all()


@pytest.fixture(scope="module")
def config3():
    """BASELINE config 3's training split: 100,000 users x 20,000 items x
    20 plays, leave-2-out, as chip_smoke.py phase 17 trains it."""
    return als_scale_1m.prepare(100_000, 20_000, 20)["train"]


def _jax_sgd_with_losses(monkeypatch, inter, cfg, steps):
    """The JAX `train_sgd`, each step's loss recorded."""
    losses, step = [], jmf.sgd_step

    def recorded(*args, **kw):
        out = step(*args, **kw)
        losses.append(float(out[2]))
        return out

    monkeypatch.setattr(jmf, "sgd_step", recorded)
    ju, ji = jmf.train_sgd(inter, JMFConfig(**cfg), num_steps=steps)
    return np.asarray(ju), np.asarray(ji), np.asarray(losses)


@pytest.mark.parametrize("steps", [1, 20, 200])
def test_train_sgd_default_lr_at_config3_matches_jax(monkeypatch, config3, steps):
    """The default lr (0.05) and batch (8192) at config 3.  Each step's loss
    within 1e-4 of JAX's over the first 20 steps (measured 1.2e-5), 2e-3
    over 200 (measured 5.7e-4).  One step: parameters to 1e-5 (measured
    4.4e-6).  After that a few entries part: where a coordinate's gradient
    cancels to below Adam's eps (1e-8), the packages' different rounding of
    that sum becomes a step of up to lr.  After 20 steps 0.29% of user and
    0.69% of item entries differ by more than 1e-5 (held: 2%); after 200,
    98% do (by ~1e-3), so there only the losses are held.  Over 200 steps
    the loss rises in both packages, 33.19 -> 156.76 (means of the first
    and last 20 steps): the reference's own course at this lr."""
    cfg = dict(embedding_dim=64, reg=0.05, alpha=10.0)
    ju, ji, jl = _jax_sgd_with_losses(monkeypatch, config3, cfg, steps)
    tl = []
    tu, ti = mf.train_sgd(config3, MFConfig(**cfg), num_steps=steps,
                          device=CPU, losses=tl)
    rel = np.abs(np.asarray(tl) - jl) / jl
    assert len(tl) == len(jl) == steps
    assert rel[:20].max() <= 1e-4 and rel.max() <= 2e-3
    if steps == 1:
        np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-5)
    elif steps == 20:
        assert (np.abs(tu - ju) > 1e-5).mean() <= 0.02
        assert (np.abs(ti - ji) > 1e-5).mean() <= 0.02
    else:
        assert jl[-20:].mean() > 4 * jl[:20].mean()
        assert tl[-20:] and np.mean(tl[-20:]) > 4 * np.mean(tl[:20])


# -------------------------------------------------------------- MIPS + eval


def _mips_inputs(seed, n, b, d, s):
    """Factor-scale rows (N(0, 1/d) entries, as `train_als` initializes),
    so scores are O(1) and 1e-6 is several fp32 ulps."""
    rng = np.random.default_rng(seed)
    items = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    items[n // 2] = items[n // 3]                 # planted ties: equal rows
    items[n - 1] = items[n // 3]
    items[5:9] = items[40]
    queries = (rng.standard_normal((b, d)) / np.sqrt(d)).astype(np.float32)
    queries[:3] = items[n // 3]
    seen = rng.integers(0, n, (b, s)).astype(np.int32)
    seen[:, 0] = n // 3                           # exclude a tied row
    seen_mask = rng.random((b, s)) < 0.8
    return queries, items, seen, seen_mask


@pytest.mark.parametrize("chunk", [64, 1000, 4096])
@pytest.mark.parametrize("exclusion", [None, "idx", "idx+mask"])
def test_mips_topk_chunked_matches_jax(chunk, exclusion):
    q, items, seen, seen_mask = _mips_inputs(chunk, 1000, 24, 16, 30)
    si = seen if exclusion else None
    sm = seen_mask if exclusion == "idx+mask" else None
    s, i = mips_topk_chunked(_t(q), _t(items), None if si is None else _t(si),
                             None if sm is None else _t(sm), k=10, chunk=chunk)
    js, ji = jmips_topk_chunked(q, items, si, sm, k=10, chunk=chunk)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    if exclusion == "idx":
        assert not np.isin(i.numpy(), seen).all(axis=1).any()


def test_mips_topk_ties_take_the_lower_index():
    q, items, _, _ = _mips_inputs(0, 1000, 8, 16, 4)
    _, i = mips_topk_chunked(_t(q), _t(items), k=3, chunk=64)
    # queries 0-2 equal row n//3, tied with rows n//2 and n-1
    assert i[:3].tolist() == [[333, 500, 999]] * 3


@pytest.mark.parametrize("n,k,chunk", [(6, 10, 64), (700, 10, 695)])
def test_mips_topk_short_chunks_match_jax(n, k, chunk):
    """Fewer than k finite columns (n < k, or everything seen): the
    answer fills with -inf slots exactly as the JAX function's."""
    q, items, _, _ = _mips_inputs(1, max(n, 50), 4, 8, 1)
    items = items[:n]
    seen = np.tile(np.arange(min(n, 8), dtype=np.int32), (4, 1))
    s, i = mips_topk_chunked(_t(q), _t(items), _t(seen), k=k, chunk=chunk)
    js, ji = jmips_topk_chunked(q, items, seen, None, k=k, chunk=chunk)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.isinf(s.numpy()), np.isinf(np.asarray(js)))


@pytest.mark.parametrize("user_chunk,item_chunk", [(4096, 131072), (500, 128)])
def test_evaluate_ranking_arrays_equal(quality, user_chunk, item_chunk):
    (_, held_idx, held_mask, seen_idx, seen_mask), (ju, ji), _ = quality
    el = np.nonzero(held_mask.any(1))[0]
    args = (ju, ji, el, held_idx[el], held_mask[el])
    kw = dict(k=10, seen_idx=seen_idx[el], seen_mask=seen_mask[el],
              user_chunk=user_chunk, item_chunk=item_chunk)
    assert (mf.evaluate_ranking_arrays(*args, **kw, device=CPU)
            == jmf.evaluate_ranking_arrays(*args, **kw))


def test_evaluate_ranking_dicts_equal(quality):
    _, (ju, ji), _ = quality
    inter, _, _ = mf.synthetic_interactions(2000, 1000, 8, seed=0)
    _, held, seen = mf.split_leave_k_out(inter, k=2, seed=0)
    for k in (5, 10):
        assert (mf.evaluate_ranking(ju, ji, held, k=k, train_mask=seen, device=CPU)
                == jmf.evaluate_ranking(ju, ji, held, k=k, train_mask=seen))


@pytest.mark.parametrize("user,exclude", [(0, None), (17, [3, 50, 999]), (1999, []),
                                          (5, [-1, -1000, 7])])
def test_recommend_for_user_equal(quality, user, exclude):
    _, (ju, ji), _ = quality
    ex = None if exclude is None else np.asarray(exclude)
    s, i = mf.recommend_for_user(ju, ji, user, k=10, exclude_items=ex, device=CPU)
    js, jidx = jmf.recommend_for_user(ju, ji, user, k=10, exclude_items=ex)
    assert np.array_equal(i, np.asarray(jidx))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-6)
    assert not np.isin(i, np.asarray(exclude or [], np.int64) % 1000).any()


@pytest.mark.parametrize("exclude", [[3, 1000], [-1001]])
def test_recommend_for_user_out_of_range_exclude_raises_as_jax(quality, exclude):
    """An excluded id outside the catalog raises numpy's IndexError in
    both packages (checked on the host, so a card never sees it)."""
    _, (ju, ji), _ = quality
    with pytest.raises(IndexError) as jerr:
        jmf.recommend_for_user(ju, ji, 3, exclude_items=np.asarray(exclude))
    with pytest.raises(IndexError) as terr:
        mf.recommend_for_user(ju, ji, 3, exclude_items=np.asarray(exclude),
                              device=CPU)
    assert str(terr.value) == str(jerr.value)


def test_recommend_for_an_unknown_user_raises(quality):
    _, (ju, ji), _ = quality
    for user in (-1, 2000):
        with pytest.raises(IndexError, match="out of range"):
            mf.recommend_for_user(ju, ji, user, device=CPU)


# -------------------------------------------------------------- artifacts


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_model_npz_loads_in_both_packages(tmp_path, quality, writer):
    _, _, (tu, ti) = quality
    path = str(tmp_path / "mf.npz")
    if writer == "torch":
        mf.save_model(path, _t(tu), _t(ti), MFConfig(**QUALITY))
    else:
        jmf.save_model(path, tu, ti, JMFConfig(**QUALITY))
    for load in (mf.load_model, jmf.load_model):
        u, i = load(path)
        assert np.array_equal(u, tu) and np.array_equal(i, ti)
    with np.load(path) as z:
        assert int(z["embedding_dim"]) == 16 and float(z["alpha"]) == 10.0


def test_params_from_jax(quality):
    _, (ju, ji), _ = quality
    u, i = mf.params_from_jax(ju, ji, CPU)
    assert u.dtype == i.dtype == torch.float32 and u.device.type == "cpu"
    assert np.array_equal(u.numpy(), ju) and np.array_equal(i.numpy(), ji)


def _write_csv(path, header, rows):
    path.write_text(header + "\n" + "\n".join(",".join(map(str, r)) for r in rows) + "\n")
    return str(path)


@pytest.mark.parametrize("fmt", ["csv", "npz"])
def test_load_interactions_equal(tmp_path, fmt):
    rng = np.random.default_rng(0)
    u, i, c = rng.integers(0, 30, 200), rng.integers(0, 20, 200), rng.integers(1, 9, 200)
    if fmt == "csv":
        path = _write_csv(tmp_path / "inter.csv", "item_id,count,user_id",
                          zip(i, c, u))
    else:
        path = str(tmp_path / "inter.npz")
        np.savez(path, user=u, item=i, count=c)
    assert_inter_equal(mf.load_interactions(path), jmf.load_interactions(path))


@pytest.mark.parametrize("header", ["user_id,item_id", "user,item_id,count",
                                    "user_id,item,plays"])
def test_load_interactions_missing_column_raises(tmp_path, header):
    path = _write_csv(tmp_path / "bad.csv", header,
                      [[1] * len(header.split(","))] * 3)
    for load in (mf.load_interactions, jmf.load_interactions):
        with pytest.raises(ValueError, match="missing column"):
            load(path)


# -------------------------------------------------------------- devices


@pytest.mark.parametrize("fn", [mf.train_als, mf.train_sgd, mf.evaluate_ranking,
                                mf.evaluate_ranking_arrays, mf.recommend_for_user,
                                mf.params_from_jax, als_scale_1m.main])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_without_a_card_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    inter, _, _ = mf.synthetic_interactions(50, 30, 4, density=0.1, seed=0)
    f = np.ones((50, 4), np.float32)
    for call in (lambda: mf.train_als(inter, MFConfig(embedding_dim=4)),
                 lambda: mf.train_sgd(inter, MFConfig(embedding_dim=4), num_steps=1),
                 lambda: mf.recommend_for_user(f, f[:30], 0),
                 lambda: mf.evaluate_ranking(f, f[:30], {0: np.asarray([1])})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -------------------------------------------------------------- config 3 generator


def test_make_clustered_bitwise_the_jax_experiment():
    spec = importlib.util.spec_from_file_location(
        "jax_experiments_als_scale_1m", EXPERIMENTS / "als_scale_1m.py")
    jexp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexp)
    for a, b in zip(als_scale_1m.make_clustered(1000, 400, 7, seed=3),
                    jexp.make_clustered(1000, 400, 7, seed=3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_als_scale_main_runs_on_the_cpu(capsys):
    out = als_scale_1m.main(2000, 400, 12, subspace=4, device=CPU)
    assert set(out["seconds"]) == {"datagen", "from_coo", "split", "transpose",
                                   "train_2", "resume_1", "eval"}
    assert 0.0 <= out["ndcg@10"] <= out["recall@10"] <= 1.0
    assert "resumed iteration 3" in capsys.readouterr().out
