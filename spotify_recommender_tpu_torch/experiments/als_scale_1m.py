"""ALS at scale on one card: the port of the JAX repo's
`experiments/als_scale_1m.py`, and the generator of BASELINE config 3's
workload (chip_smoke.py phase 17 runs it at 100,000 users x 20,000 items).

Generates clustered synthetic implicit feedback (vectorized, no per-user
loops), trains 2 ALS iterations at d = 64 with checkpoints, resumes for a
3rd (proving resume), and evaluates recall@10 / NDCG@10 on 10,000
held-out users through the chunked MIPS top-k:

    python -m spotify_recommender_tpu_torch.experiments.als_scale_1m \\
        [users] [items] [nnz_per_user] [subspace] [--device cuda|cpu]

Runs on the card unless asked for the CPU; prints one line per step with
its seconds and returns them in a dict.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict

import numpy as np

from spotify_recommender_tpu_torch.core.config import MFConfig
from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.models import mf


def make_clustered(num_users, num_items, per_user, clusters=200, seed=0):
    """Users prefer one item-cluster: measurable recall without per-user
    Python work (all sampling vectorized).  Returns COO (user, item,
    count); bitwise the JAX experiment's for the same arguments."""
    rng = np.random.default_rng(seed)
    total = num_users * per_user
    user = np.repeat(np.arange(num_users, dtype=np.int64), per_user)
    ucluster = (user % clusters).astype(np.int64)
    span = num_items // clusters
    # 80% in-cluster, 20% uniform noise
    incluster = rng.random(total) < 0.8
    offs = rng.integers(0, span, total)
    item = np.where(
        incluster, ucluster * span + offs, rng.integers(0, num_items, total)
    )
    count = 1.0 + rng.poisson(2.0, total).astype(np.float32)
    return user, item, count


def _timed(seconds: Dict[str, float], name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    seconds[name] = time.perf_counter() - t0
    return out


def prepare(num_users: int, num_items: int, per_user: int,
            seed: int = 0) -> dict:
    """The workload's host steps, each timed: `make_clustered`,
    `Interactions.from_coo`, `split_leave_k_out_arrays(k=2)` and the item
    view (`transpose`).  Returns the split arrays, the item view and
    ``seconds`` per step."""
    sec: Dict[str, float] = {}
    user, item, count = _timed(sec, "datagen", lambda: make_clustered(
        num_users, num_items, per_user, seed=seed))
    inter = _timed(sec, "from_coo", lambda: mf.Interactions.from_coo(
        user, item, count, num_users, num_items))
    train, held_idx, held_mask, seen_idx, seen_mask = _timed(
        sec, "split", lambda: mf.split_leave_k_out_arrays(inter, k=2, seed=0))
    item_view = _timed(sec, "transpose", train.transpose)
    return dict(train=train, item_view=item_view, held_idx=held_idx,
                held_mask=held_mask, seen_idx=seen_idx, seen_mask=seen_mask,
                nnz=len(user), seconds=sec)


def eval_users(data: dict, n: int = 10_000, seed: int = 1) -> np.ndarray:
    """`n` users drawn (without replacement) from those with held-out
    items."""
    has_held = np.nonzero(data["held_mask"].any(axis=1))[0]
    rng = np.random.default_rng(seed)
    return rng.choice(has_held, size=min(n, len(has_held)), replace=False)


def evaluate(users_f, items_f, data: dict, rows: np.ndarray, device) -> dict:
    """recall@10 / NDCG@10 of the factors on `rows` (see `eval_users`)."""
    return mf.evaluate_ranking_arrays(
        users_f, items_f, rows,
        data["held_idx"][rows], data["held_mask"][rows], k=10,
        seen_idx=data["seen_idx"][rows], seen_mask=data["seen_mask"][rows],
        device=device,
    )


def main(num_users: int = 1_000_000, num_items: int = 1_000_000,
         per_user: int = 16, subspace: int = 0, device="cuda") -> dict:
    dev = resolve_device(device)
    data = prepare(num_users, num_items, per_user)
    sec = data["seconds"]
    print(f"datagen: {data['nnz']:,} interactions in {sec['datagen']:.1f}s; "
          f"from_coo md={data['train'].item_idx.shape[1]}, split, transpose "
          f"item md={data['item_view'].item_idx.shape[1]}: "
          f"{sec['from_coo']:.1f}s, {sec['split']:.1f}s, "
          f"{sec['transpose']:.1f}s", flush=True)
    tag = f"iALS++ subspace={subspace}" if subspace else "full ALS"
    kw = dict(embedding_dim=64, reg=0.05, alpha=10.0)
    with tempfile.TemporaryDirectory(prefix="als1m_") as ckpt:
        def train(iterations):
            return mf.train_als(
                data["train"], MFConfig(num_iterations=iterations, **kw),
                item_view=data["item_view"], checkpoint_dir=ckpt,
                subspace=subspace, device=dev)

        _timed(sec, "train_2", lambda: train(2))
        # resume: one more iteration picks up from the checkpoint
        users_f, items_f = _timed(sec, "resume_1", lambda: train(3))
    assert np.isfinite(users_f).all() and np.isfinite(items_f).all()
    rows = eval_users(data)
    m = _timed(sec, "eval", lambda: evaluate(users_f, items_f, data, rows, dev))
    print(f"2 {tag} iterations: {sec['train_2']:.1f}s; resumed iteration 3: "
          f"{sec['resume_1']:.1f}s; eval "
          f"({len(rows)} users x {num_items:,} items): {sec['eval']:.1f}s -> "
          f"recall@10={m['recall@k']:.4f} ndcg@10={m['ndcg@k']:.4f}",
          flush=True)
    return {"seconds": sec, "recall@10": m["recall@k"], "ndcg@10": m["ndcg@k"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("users", nargs="?", type=int, default=1_000_000)
    ap.add_argument("items", nargs="?", type=int, default=1_000_000)
    ap.add_argument("per_user", nargs="?", type=int, default=16)
    ap.add_argument("subspace", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.users, a.items, a.per_user, a.subspace, a.device)
