"""Matrix factorization for implicit feedback: ALS, iALS++ and SGD trainers.

The port of the JAX package's `models/mf.py` (BASELINE config 3: 64-dim
ALS on an implicit play-count matrix, trained and evaluated by
recall@10 / NDCG@10):

- **iALS** (Hu/Koren/Volinsky 2008): alternating ridge solves with the
  Gramian trick, ``A_u = YᵀY + λI + Σ_i α·c_ui · y_i y_iᵀ``,
  ``b_u = Σ_i (1 + α·c_ui) y_i``.  Interactions are padded-ragged
  (`Interactions`); rows are solved in blocks of about 1 GB of live
  tensors, each block's normal matrices built by one `torch.bmm` and
  solved by one batched Cholesky (`torch.linalg.cholesky_ex` +
  `torch.cholesky_solve`).  A failed factorization raises.
- **iALS++** (Rendle et al., arXiv:2110.14044): the same half-step as a
  sweep of `subspace`-sized block-coordinate solves.
- **SGD**: confidence-weighted MSE on positives + sampled uniform
  negatives, `torch.optim.Adam` (optax.adam's defaults), dense gradients
  by autograd.

Evaluation scores the factors with the exact chunked MIPS top-k
(`ops/similarity.mips_topk_chunked`).  Every product is true fp32 (TF32
off on CUDA), the JAX package's `Precision.HIGHEST`.  The entry points
run on ``device="cuda"`` unless told ``"cpu"``; without a card they
raise.  Host data (`Interactions`, the splits) is numpy, bitwise the JAX
package's, and the model artifact (`save_model`) is the same `.npz`.

Not ported: the sharded half-steps (a `mesh` or `shard_tables` raises,
ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import MFConfig
from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.logging import PhaseTimer, get_logger
from spotify_recommender_tpu_torch.core.timing import Spans, span
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.topk import topk_stable

log = get_logger(__name__)

Device = Union[str, torch.device]
MESH_NOT_PORTED = ("a device mesh (sharded ALS / SGD) is not ported yet "
                   "(ROADMAP.md queue 1 item 6)")


# --------------------------------------------------------------------------
# Interaction data
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Interactions:
    """Implicit-feedback matrix in padded-ragged form.

    ``item_idx[u, j]`` = j-th item of user u (0-padded), valid where
    ``mask[u, j]``; ``confidence`` holds raw counts (0 where padded).
    """

    item_idx: np.ndarray     # (U, max_degree) int32
    confidence: np.ndarray   # (U, max_degree) float32
    mask: np.ndarray         # (U, max_degree) bool
    num_users: int
    num_items: int

    @classmethod
    def from_coo(
        cls,
        users: np.ndarray,
        items: np.ndarray,
        counts: np.ndarray,
        num_users: Optional[int] = None,
        num_items: Optional[int] = None,
        max_degree: Optional[int] = None,
    ) -> "Interactions":
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        counts = np.asarray(counts, np.float32)
        nu = int(num_users or users.max() + 1)
        ni = int(num_items or items.max() + 1)
        order = np.lexsort((items, users))
        users, items, counts = users[order], items[order], counts[order]
        degrees = np.bincount(users, minlength=nu)
        md = int(max_degree or degrees.max())
        # vectorized padded-ragged construction: the position of each
        # interaction within its user's sorted run
        starts = np.concatenate([[0], np.cumsum(degrees)[:-1]])
        pos = np.arange(len(users)) - np.repeat(starts, degrees)
        keep = pos < md
        item_idx = np.zeros((nu, md), np.int32)
        conf = np.zeros((nu, md), np.float32)
        mask = np.zeros((nu, md), bool)
        item_idx[users[keep], pos[keep]] = items[keep]
        conf[users[keep], pos[keep]] = counts[keep]
        mask[users[keep], pos[keep]] = True
        return cls(item_idx, conf, mask, nu, ni)

    def transpose(self, max_degree: Optional[int] = None) -> "Interactions":
        """Item-major view (for the item half-step of ALS)."""
        uu, jj = np.nonzero(self.mask)  # row-major: ascending user order
        return Interactions.from_coo(
            self.item_idx[uu, jj].astype(np.int64),  # items become "users"
            uu.astype(np.int64),
            self.confidence[uu, jj],
            num_users=self.num_items,
            num_items=self.num_users,
            max_degree=max_degree,
        )


def synthetic_interactions(
    num_users: int = 2000,
    num_items: int = 1000,
    latent_dim: int = 8,
    density: float = 0.02,
    seed: int = 0,
) -> Tuple[Interactions, np.ndarray, np.ndarray]:
    """Low-rank synthetic play counts (ground-truth factors returned for
    sanity checks)."""
    rng = np.random.default_rng(seed)
    tu = rng.normal(size=(num_users, latent_dim)).astype(np.float32)
    ti = rng.normal(size=(num_items, latent_dim)).astype(np.float32)
    logits = tu @ ti.T
    n_obs = int(density * num_users * num_items)
    # observation probability follows affinity (sharpened softmax sampling
    # so the preference signal is clearly recoverable by MF)
    p = np.exp(2.0 * logits)
    p /= p.sum()
    flat = rng.choice(num_users * num_items, size=n_obs, replace=False, p=p.ravel())
    users, items = np.divmod(flat, num_items)
    counts = 1.0 + rng.poisson(3.0, size=n_obs).astype(np.float32)
    inter = Interactions.from_coo(users, items, counts, num_users, num_items)
    return inter, tu, ti


# --------------------------------------------------------------------------
# ALS
# --------------------------------------------------------------------------


def _als_block_rows(n: int, md: int, d: int) -> int:
    """Row-block size keeping the half-step's live tensors ~<=1 GB: the
    batched normal matrices are (rows, D, D) and the gathered neighbor
    vectors (rows, md, D); at 1M users x d=64 the unblocked versions alone
    would want 16+ GB."""
    per_row = 4 * d * (d + 2 * max(1, md))
    return max(1024, min(n, 1_000_000_000 // per_row))


def _cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the batched SPD systems a x = b (b (r, D)); returns x and the
    count of failed factorizations, left on the device."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b[..., None], chol)[..., 0], (info != 0).sum()


def _raise_if_failed(failed: torch.Tensor, what: str) -> None:
    """The half-step's one host sync: JAX returns NaN rows silently where a
    factorization fails; the port raises."""
    nfail = int(failed)
    if nfail:
        raise torch.linalg.LinAlgError(
            f"{what}: {nfail} Cholesky factorization(s) failed (the normal "
            "matrices are not positive definite; reg must be > 0 for empty "
            "rows)")


def _block_inputs(item_idx, confidence, mask, sl, other, alpha):
    """One row block's gathered neighbours y (r, md, D), confidence weights
    w and preferences cpref (r, md)."""
    y = other[item_idx[sl].long()]                        # (r, md, D)
    msk, conf = mask[sl], confidence[sl]
    w = torch.where(msk, alpha * conf, 0.0)
    cpref = torch.where(msk, 1.0 + alpha * conf, 0.0)
    return y, w, cpref


def _als_solve(
    other: torch.Tensor,        # (M, D) fixed factor table
    item_idx: torch.Tensor,     # (N, md) int32 neighbor ids into `other`
    confidence: torch.Tensor,   # (N, md) float32
    mask: torch.Tensor,         # (N, md) bool
    reg: float,
    alpha: float,
    solve_block: int = 0,
    spans: Optional[Spans] = None,
) -> torch.Tensor:
    """One ALS half-step: re-solve every row given the fixed `other` table.

    The implicit-feedback normal equations with the Gramian trick, solved
    by batched Cholesky in `solve_block`-row blocks (0 = auto-size to ~1
    GB of live per-block tensors).  Fully masked rows solve
    (G + λI) x = 0 to 0.  Raises if a factorization fails."""
    n, md = item_idx.shape
    d = other.shape[1]
    gram = other.T @ other                                # (D, D)
    eye = reg * torch.eye(d, dtype=other.dtype, device=other.device)
    out = torch.empty((n, d), dtype=other.dtype, device=other.device)
    failed = torch.zeros((), dtype=torch.int64, device=other.device)
    block = solve_block or _als_block_rows(n, md, d)
    for s in range(0, n, block):
        sl = slice(s, s + block)
        y, w, cpref = _block_inputs(item_idx, confidence, mask, sl, other, alpha)
        # A_r = G + λI + Σ_j w_rj y_rj y_rjᵀ  (one batched product)
        a = gram[None] + torch.bmm((y * w[..., None]).transpose(1, 2), y) + eye[None]
        b = torch.bmm(cpref[:, None, :], y)[:, 0]         # (r, D)
        with span(spans, "chol"):
            out[sl], nfail = _cholesky_solve(a, b)
        failed += nfail
    _raise_if_failed(failed, "ALS half-step")
    return out


def _als_pp_solve(
    other: torch.Tensor,        # (M, D) fixed factor table
    item_idx: torch.Tensor,     # (N, md) int32 neighbor ids into `other`
    confidence: torch.Tensor,   # (N, md) float32
    mask: torch.Tensor,         # (N, md) bool
    x0: torch.Tensor,           # (N, D) current factors (warm start)
    reg: float,
    alpha: float,
    subspace: int,
    solve_block: int = 0,
    spans: Optional[Spans] = None,
) -> torch.Tensor:
    """iALS++ half-step: subspace block-coordinate descent (Rendle et al.,
    "iALS++: Speeding up Matrix Factorization with Subspace Optimization",
    arXiv:2110.14044).

    One sweep updates D/subspace coordinate blocks with `subspace`-sized
    solves, keeping a per-(row, neighbor) prediction cache corrected after
    each block: O(nnz * D * k + N * D * k^2) against the full solve's
    O(nnz * D^2 + N * D^3).  It is exact Gauss-Seidel on each row's
    quadratic, so with subspace == D it reproduces the full solve."""
    n, md = item_idx.shape
    d = other.shape[1]
    k = max(1, min(subspace, d))
    if d % k:
        raise ValueError(f"subspace {k} must divide embedding dim {d}")
    gram = other.T @ other                                # (D, D)
    eye_k = reg * torch.eye(k, dtype=other.dtype, device=other.device)
    out = torch.empty_like(x0)
    failed = torch.zeros((), dtype=torch.int64, device=other.device)
    block = solve_block or _als_block_rows(n, md, max(k, d // 4))
    for r in range(0, n, block):
        sl = slice(r, r + block)
        y, w, cpref = _block_inputs(item_idx, confidence, mask, sl, other, alpha)
        x = x0[sl]
        pred = torch.bmm(y, x[:, :, None])[..., 0]        # (r, md) cache
        for s in range(0, d, k):
            ys = y[:, :, s:s + k]                         # (r, md, k)
            a_ss = (gram[s:s + k, s:s + k][None]
                    + torch.bmm((ys * w[..., None]).transpose(1, 2), ys)
                    + eye_k[None])
            b_s = torch.bmm(cpref[:, None, :], ys)[:, 0]
            # (A x)_S = (G x)_S + sum_j w_j pred_j y_jS + lambda x_S
            ax_s = (x @ gram[:, s:s + k]
                    + torch.bmm((w * pred)[:, None, :], ys)[:, 0]
                    + reg * x[:, s:s + k])
            with span(spans, "chol"):
                delta, nfail = _cholesky_solve(a_ss, b_s - ax_s)  # (r, k)
            failed += nfail
            # out of place: the next block's (A x)_S reads the new x
            x = torch.cat([x[:, :s], x[:, s:s + k] + delta, x[:, s + k:]], 1)
            pred = pred + torch.bmm(ys, delta[..., None])[..., 0]
        out[sl] = x
    _raise_if_failed(failed, "iALS++ half-step")
    return out


def _check_single_device(mesh, shard_tables: bool = False) -> None:
    if mesh is not None or shard_tables:
        raise ValueError(MESH_NOT_PORTED)


def _on_device(dev: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    """`arrays` as tensors on `dev`; on a card, TF32 goes off first."""
    if dev.type == "cuda":
        similarity.disable_tf32()
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _init_table(rng: np.random.Generator, rows: int, d: int) -> np.ndarray:
    return (rng.normal(size=(rows, d)) / np.sqrt(d)).astype(np.float32)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def train_als(
    inter: Interactions,
    config: MFConfig,
    item_view: Optional[Interactions] = None,
    callback=None,
    mesh=None,
    shard_tables: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    subspace: int = 0,
    device: Device = "cuda",
    stats: Optional[Dict[str, list]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full alternating loop on `device`.  Returns (user_factors,
    item_factors) as numpy.

    With `checkpoint_dir`, the factor tables checkpoint every
    `checkpoint_every` iterations (`train/checkpoint.py`) and training
    resumes from the latest checkpoint if one exists.  With `subspace` > 0
    (must divide embedding_dim), half-steps use the iALS++ sweep.  With a
    `stats` dict, each iteration appends its milliseconds to
    ``stats["user_ms"]``, ``["item_ms"]`` (the two halves) and
    ``["chol_ms"]`` (the Cholesky factor + solve inside both).  A `mesh` or
    `shard_tables` raises `ValueError` (not ported)."""
    _check_single_device(mesh, shard_tables)
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    d = config.embedding_dim
    if item_view is None:
        item_view = inter.transpose()
    u_idx, u_conf, u_mask, i_idx, i_conf, i_mask = _on_device(
        dev, inter.item_idx, inter.confidence, inter.mask,
        item_view.item_idx, item_view.confidence, item_view.mask)
    users, items = _on_device(dev, _init_table(rng, inter.num_users, d),
                              _init_table(rng, inter.num_items, d))

    def half(x, other, idx, conf, mask, spans):
        if subspace:
            return _als_pp_solve(other, idx, conf, mask, x, config.reg,
                                 config.alpha, subspace, spans=spans)
        return _als_solve(other, idx, conf, mask, config.reg, config.alpha,
                          spans=spans)

    ckpt_mgr = None
    start_iter = 0
    if checkpoint_dir is not None:
        from spotify_recommender_tpu_torch.train.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(checkpoint_dir)
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            state = ckpt_mgr.restore(
                latest, template={"users": users, "items": items})
            users, items = state["users"], state["items"]
            start_iter = latest + 1
            log.info("resumed ALS from iteration %d", start_iter)

    spans = Spans(dev) if stats is not None else None
    timer = PhaseTimer()
    for it in range(start_iter, config.num_iterations):
        with timer.phase(f"iter{it}"):
            with span(spans, "user"):
                users = half(users, items, u_idx, u_conf, u_mask, spans)
            with span(spans, "item"):
                items = half(items, users, i_idx, i_conf, i_mask, spans)
            if spans is not None:
                ms = spans.read()
                for name in ("user", "item", "chol"):
                    stats.setdefault(f"{name}_ms", []).append(ms[name])
        if callback is not None:
            callback(it, users, items)
        if ckpt_mgr is not None and (
            (it + 1) % checkpoint_every == 0
            or it == config.num_iterations - 1
        ):
            ckpt_mgr.save(it, {"users": users, "items": items}, force=True)
    if ckpt_mgr is not None:
        ckpt_mgr.wait()
        ckpt_mgr.close()
    log.info("ALS done: %s", timer.report())
    return _to_numpy(users), _to_numpy(items)


# --------------------------------------------------------------------------
# SGD variant
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SGDState:
    """The SGD trainer's state: the two factor tables (leaf tensors that
    require grad) and the Adam optimizer over them."""

    users: torch.Tensor
    items: torch.Tensor
    optimizer: torch.optim.Optimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {"users": self.users, "items": self.items}


def _sgd_loss(
    params: Dict[str, torch.Tensor],
    u: torch.Tensor,           # (B,) user ids
    i_pos: torch.Tensor,       # (B,) positive item ids
    conf: torch.Tensor,        # (B,) confidence
    i_neg: torch.Tensor,       # (B, n_neg) sampled negatives
    reg: float,
    alpha: float,
) -> torch.Tensor:
    """Confidence-weighted implicit MSE (iALS objective, sampled)."""
    eu = params["users"][u]                    # (B, D)
    ep = params["items"][i_pos]                # (B, D)
    en = params["items"][i_neg]                # (B, n_neg, D)
    pos_pred = torch.sum(eu * ep, dim=1)
    neg_pred = torch.bmm(en, eu[:, :, None])[..., 0]
    w = 1.0 + alpha * conf
    loss_pos = torch.mean(w * (1.0 - pos_pred) ** 2)
    loss_neg = torch.mean(neg_pred ** 2)
    l2 = reg * (torch.mean(torch.sum(eu ** 2, 1))
                + torch.mean(torch.sum(ep ** 2, 1)))
    return loss_pos + loss_neg + l2


def sgd_step(state: SGDState, batch: Dict[str, torch.Tensor], reg: float,
             alpha: float) -> torch.Tensor:
    """One Adam step on the sampled loss; returns the loss (on the device).
    The gathers' backward accumulates with atomics on CUDA, so a rerun on
    the card equals the last only within a tolerance."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = _sgd_loss(state.params, batch["user"], batch["item"],
                     batch["conf"], batch["neg"], reg, alpha)
    loss.backward()
    state.optimizer.step()
    return loss.detach()


def train_sgd(
    inter: Interactions,
    config: MFConfig,
    num_steps: int = 1000,
    n_neg: int = 4,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 200,
    device: Device = "cuda",
    losses: Optional[List[float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """SGD/Adam training loop on `device`.  With `checkpoint_dir`, params
    and optimizer state checkpoint every `checkpoint_every` steps and
    training resumes from the latest checkpoint (the numpy batch RNG
    replays the skipped steps, so a resumed run equals an uninterrupted
    one).  Each step's loss is appended to `losses` when given.  A `mesh`
    raises `ValueError` (not ported)."""
    _check_single_device(mesh)
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    d = config.embedding_dim
    scale = 1.0 / np.sqrt(d)
    users, items = _on_device(
        dev,
        (rng.normal(size=(inter.num_users, d)) * scale).astype(np.float32),
        (rng.normal(size=(inter.num_items, d)) * scale).astype(np.float32),
    )
    users.requires_grad_(True)
    items.requires_grad_(True)
    # optax.adam's defaults
    state = SGDState(users, items, torch.optim.Adam(
        [users, items], lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8))

    # flatten observed pairs for sampling
    uu, jj = np.nonzero(inter.mask)
    users_f = uu.astype(np.int32)
    items_f = inter.item_idx[uu, jj]
    conf_f = inter.confidence[uu, jj]
    n_obs = len(users_f)
    b = min(config.batch_size, n_obs)

    ckpt_mgr = None
    start_step = 0
    if checkpoint_dir is not None:
        from spotify_recommender_tpu_torch.train.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(checkpoint_dir)
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            saved = ckpt_mgr.restore(latest, device=dev)
            with torch.no_grad():
                users.copy_(saved["params"]["users"])
                items.copy_(saved["params"]["items"])
            state.optimizer.load_state_dict(saved["opt_state"])
            start_step = latest + 1
            log.info("resumed SGD-MF from step %d", start_step)

    history = []
    for step in range(num_steps):
        sel = rng.integers(0, n_obs, size=b)
        neg = rng.integers(0, inter.num_items, size=(b, n_neg))
        if step < start_step:
            continue  # replay the RNG stream so resume == uninterrupted run
        batch = {
            "user": torch.as_tensor(users_f[sel], dtype=torch.int64, device=dev),
            "item": torch.as_tensor(items_f[sel], dtype=torch.int64, device=dev),
            "conf": torch.as_tensor(conf_f[sel], device=dev),
            "neg": torch.as_tensor(neg, dtype=torch.int64, device=dev),
        }
        history.append(sgd_step(state, batch, config.reg, config.alpha))
        if ckpt_mgr is not None and (
            (step + 1) % checkpoint_every == 0 or step == num_steps - 1
        ):
            params = {k: v.detach() for k, v in state.params.items()}
            ckpt_mgr.save(step, {"params": params,
                                 "opt_state": state.optimizer.state_dict()},
                          force=True)
    if ckpt_mgr is not None:
        ckpt_mgr.wait()
        ckpt_mgr.close()
    values = torch.stack(history).tolist() if history else [float("nan")]
    if losses is not None and history:
        losses.extend(values)
    log.info("SGD done: loss %.4f -> %.4f", values[0], values[-1])
    return _to_numpy(users), _to_numpy(items)


# --------------------------------------------------------------------------
# Evaluation: recall@k / NDCG@k through the retrieval stack
# --------------------------------------------------------------------------


def _pad_ragged(
    rows: Dict[int, np.ndarray], keys, width: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Dict-of-arrays -> (idx (len(keys), W) int32, mask) padded-ragged."""
    lens = [len(rows.get(u, ())) for u in keys]
    w = max(1, width or (max(lens) if lens else 1))
    idx = np.zeros((len(keys), w), np.int32)
    mask = np.zeros((len(keys), w), bool)
    for r, u in enumerate(keys):
        v = rows.get(u)
        if v is not None and len(v):
            d = min(len(v), w)
            idx[r, :d] = np.asarray(v[:d], np.int32)
            mask[r, :d] = True
    return idx, mask


def evaluate_ranking_arrays(
    user_factors,
    item_factors,
    eval_users: np.ndarray,      # (E,) user rows to evaluate
    held_idx: np.ndarray,        # (E, H) held-out item ids (padded)
    held_mask: np.ndarray,       # (E, H) bool
    k: int = 10,
    seen_idx: Optional[np.ndarray] = None,   # (E, S) train positives
    seen_mask: Optional[np.ndarray] = None,
    user_chunk: int = 4096,
    item_chunk: int = 131072,
    device: Device = "cuda",
) -> Dict[str, float]:
    """recall@k / NDCG@k, scoring on `device` through the chunked MIPS
    top-k (`ops/similarity.mips_topk_chunked`): O(user_chunk x item_chunk)
    peak memory, train positives masked on the device per chunk; the
    metrics are summed on the host.  The factors are numpy arrays or
    tensors."""
    dev = resolve_device(device)
    (items,) = _on_device(dev, _to_numpy(item_factors).astype(np.float32))
    e = len(eval_users)
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    cum_disc = np.concatenate([[0.0], np.cumsum(discounts)])
    recall_sum = ndcg_sum = 0.0
    n_eval = 0
    for s in range(0, e, user_chunk):
        sl = slice(s, min(s + user_chunk, e))
        u_emb = torch.as_tensor(
            _to_numpy(user_factors[eval_users[sl]]), dtype=torch.float32,
            device=dev)
        si = torch.as_tensor(seen_idx[sl], device=dev) if seen_idx is not None else None
        sm = torch.as_tensor(seen_mask[sl], device=dev) if seen_mask is not None else None
        _, top = similarity.mips_topk_chunked(
            u_emb, items, si, sm, k=k, chunk=item_chunk)
        top = top.cpu().numpy()                                # (C, k)
        hm = held_mask[sl]
        hi = np.where(hm, held_idx[sl], -1)                    # (C, H)
        hits = (top[:, :, None] == hi[:, None, :]).any(-1)     # (C, k)
        counts = hm.sum(1)                                     # (C,)
        valid = counts > 0
        denom = np.minimum(counts, k).clip(min=1)
        recall_sum += float((hits.sum(1) / denom)[valid].sum())
        ideal = cum_disc[np.minimum(counts, k)]
        ndcg = (hits * discounts[None, :]).sum(1) / np.where(
            ideal > 0, ideal, 1.0
        )
        ndcg_sum += float(ndcg[valid].sum())
        n_eval += int(valid.sum())
    return {
        "recall@k": recall_sum / max(n_eval, 1),
        "ndcg@k": ndcg_sum / max(n_eval, 1),
        "k": k,
        "num_eval_users": n_eval,
    }


def evaluate_ranking(
    user_factors,
    item_factors,
    heldout: Dict[int, np.ndarray],
    k: int = 10,
    train_mask: Optional[Dict[int, np.ndarray]] = None,
    device: Device = "cuda",
) -> Dict[str, float]:
    """recall@k and NDCG@k against held-out positives (dict API): a thin
    adapter over `evaluate_ranking_arrays`."""
    users = np.asarray(sorted(heldout.keys()), np.int64)
    held_idx, held_mask = _pad_ragged(heldout, users)
    seen_idx = seen_mask = None
    if train_mask is not None:
        seen_idx, seen_mask = _pad_ragged(train_mask, users)
    return evaluate_ranking_arrays(
        user_factors, item_factors, users, held_idx, held_mask,
        k=k, seen_idx=seen_idx, seen_mask=seen_mask, device=device,
    )


def split_leave_k_out_arrays(
    inter: Interactions, k: int = 2, seed: int = 0
) -> Tuple[Interactions, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-user split (no Python loop over users).

    Users with more than k interactions hold out exactly k uniformly-random
    ones for evaluation; others keep everything in train.  Returns
    (train, held_idx (U, k), held_mask, seen_idx (U, md), seen_mask) in the
    padded-ragged form `evaluate_ranking_arrays` consumes.
    """
    rng = np.random.default_rng(seed)
    u, md = inter.mask.shape
    degrees = inter.mask.sum(1)
    # random priority per valid slot; argsort rows -> random permutation of
    # each user's valid positions first (invalid positions sink to the end)
    r = rng.random((u, md))
    r[~inter.mask] = -1.0
    order = np.argsort(-r, axis=1, kind="stable")          # (U, md)
    rows = np.arange(u)[:, None]
    hold = np.zeros((u, md), bool)
    kk = min(k, md)
    hold[rows[:, :kk] * 0 + rows, order[:, :kk]] = True
    hold &= inter.mask
    hold[degrees <= k] = False                              # keep-all rule
    train_mask = inter.mask & ~hold

    tu, tj = np.nonzero(train_mask)
    train = Interactions.from_coo(
        tu.astype(np.int64),
        inter.item_idx[tu, tj].astype(np.int64),
        inter.confidence[tu, tj],
        inter.num_users,
        inter.num_items,
    )
    # held-out items packed left into (U, k)
    held_idx = np.zeros((u, max(1, kk)), np.int32)
    held_mask = np.zeros((u, max(1, kk)), bool)
    hu, hj = np.nonzero(hold)
    if len(hu):
        starts = np.searchsorted(hu, np.arange(u))
        pos = np.arange(len(hu)) - starts[hu]
        held_idx[hu, pos] = inter.item_idx[hu, hj]
        held_mask[hu, pos] = True
    return train, held_idx, held_mask, train.item_idx, train.mask


def split_leave_k_out(
    inter: Interactions, k: int = 2, seed: int = 0
) -> Tuple[Interactions, Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Dict-API adapter over `split_leave_k_out_arrays`."""
    train, held_idx, held_mask, seen_idx, seen_mask = (
        split_leave_k_out_arrays(inter, k=k, seed=seed)
    )
    heldout: Dict[int, np.ndarray] = {}
    train_items: Dict[int, np.ndarray] = {}
    for uu in range(inter.num_users):
        hm = held_mask[uu]
        if hm.any():
            heldout[uu] = held_idx[uu][hm].astype(np.int64)
        train_items[uu] = seen_idx[uu][seen_mask[uu]].astype(np.int64)
    return train, heldout, train_items


def recommend_for_user(
    user_factors,
    item_factors,
    user_id: int,
    k: int = 10,
    exclude_items: Optional[np.ndarray] = None,
    device: Device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items for one user by fp32 dot-product MIPS on `device`,
    ties toward the lower item index.  Returns (scores (k,), item_ids
    (k,)) as numpy."""
    if user_id < 0 or user_id >= user_factors.shape[0]:
        raise IndexError(f"user {user_id} out of range")
    dev = resolve_device(device)
    u, items = _on_device(
        dev, _to_numpy(user_factors[user_id:user_id + 1]).astype(np.float32),
        _to_numpy(item_factors).astype(np.float32))
    scores = u @ items.T
    if exclude_items is not None and len(exclude_items):
        # on the host, as numpy indexes: an id out of range raises
        # IndexError (a card would assert), a negative id wraps
        mask = np.zeros(items.shape[0], bool)
        mask[np.asarray(exclude_items, np.int64)] = True
        scores = scores.masked_fill(torch.from_numpy(mask).to(dev)[None, :],
                                    float("-inf"))
    s, idx = topk_stable(scores, min(k, items.shape[0]))
    return s[0].cpu().numpy(), idx[0].cpu().numpy()


# --------------------------------------------------------------------------
# Model artifact + CLI
# --------------------------------------------------------------------------


def params_from_jax(user_factors: np.ndarray, item_factors: np.ndarray,
                    device: Device = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's factor tables (numpy, e.g. from its `load_model`
    or `train_als`) as the port's fp32 tensors on `device`."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(t, np.float32), device=dev)
                 for t in (user_factors, item_factors))


def save_model(path: str, users, items, config: MFConfig) -> None:
    """The `.npz` artifact of the JAX package's `save_model`, same keys:
    either package loads the other's."""
    np.savez_compressed(
        path,
        user_factors=_to_numpy(users),
        item_factors=_to_numpy(items),
        embedding_dim=np.int32(config.embedding_dim),
        reg=np.float32(config.reg),
        alpha=np.float32(config.alpha),
    )
    log.info("MF model saved: %s", path)


def load_model(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["user_factors"], z["item_factors"]


def load_interactions(path: str) -> Interactions:
    """Load interactions from .npz (user/item/count arrays) or CSV
    (user_id,item_id,count header)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return Interactions.from_coo(z["user"], z["item"], z["count"])
    data = np.genfromtxt(
        path, delimiter=",", names=True, dtype=None, encoding="utf-8"
    )
    cols = set(data.dtype.names or ())
    required = ("user_id", "item_id", "count")
    missing = [c for c in required if c not in cols]
    if missing:
        # columns are addressed BY NAME (a reordered header must not
        # silently swap users/items), so all three must be present
        raise ValueError(
            f"interactions CSV {path!r} is missing column(s) {missing}; "
            f"expected header with {required}, found {sorted(cols)}"
        )
    return Interactions.from_coo(
        data["user_id"].astype(np.int64),
        data["item_id"].astype(np.int64),
        data["count"].astype(np.float32),
    )


def train_from_cli(
    interactions_path: str,
    config: MFConfig,
    output: str,
    solver: str = "als",
    checkpoint_dir: Optional[str] = None,
    subspace: int = 0,
    device: Device = "cuda",
) -> int:
    inter = load_interactions(interactions_path)
    train, heldout, seen = split_leave_k_out(inter, k=2, seed=config.seed)
    log.info(
        "MF train: %d users x %d items, solver=%s dim=%d device=%s",
        inter.num_users, inter.num_items, solver, config.embedding_dim, device,
    )
    if solver == "als":
        users, items = train_als(
            train, config, checkpoint_dir=checkpoint_dir, subspace=subspace,
            device=device,
        )
    else:
        users, items = train_sgd(
            train, config, num_steps=2000, checkpoint_dir=checkpoint_dir,
            device=device,
        )
    metrics = evaluate_ranking(users, items, heldout, k=10, train_mask=seen,
                               device=device)
    print(
        f"recall@10={metrics['recall@k']:.4f} ndcg@10={metrics['ndcg@k']:.4f} "
        f"({metrics['num_eval_users']} users)"
    )
    save_model(output, users, items, config)
    return 0
