"""Two-tower retrieval model with in-batch softmax negatives.

The port of the JAX package's `models/two_tower.py` (BASELINE config 5:
two towers, in-batch negatives, end-to-end train + serve):

- `Tower` / `TwoTower`: MLPs of `nn.Linear` + ReLU from feature vectors to
  embeddings.  The query side is L2-normalized (`max(norm, 1e-8)`); the
  item side too unless `normalize_items=False`, where its magnitude can
  carry popularity.  `compute_dtype="bfloat16"` rounds where flax's
  `nn.Dense(dtype=bfloat16)` rounds: the input and each weight and bias
  cast to bf16, the product rounded to bf16, the bias added in bf16 (two
  roundings: `addmm`'s fused bias would round once fewer), the ReLU in
  bf16, the last output cast to fp32 before the normalization.  The
  parameters, the loss and the optimizer state stay fp32.
- `info_nce_loss`: the in-batch softmax over one (b, D) x (D, b) logits
  product, query to item only, as the JAX function computes it (its
  docstring says "symmetric"; ROADMAP 3c).
- Adam with optax.adam's defaults (`torch.optim.Adam`); the pair sources
  `same_genre_pairs` and `colisten_pair_fn` are the JAX package's numpy
  code, bitwise.
- Serving: embed the catalog once (`embed_catalog`) and serve it through
  the same tiers as any catalog (`embed-catalog --two-tower`).

The parameters are a `state_dict` (``query_tower.layers.0.weight`` ...,
weights (out, in)); `params_from_jax` / `params_to_jax` carry them to and
from the JAX tree (``Dense_i`` kernels (in, out)), and the model file
(`save_model`) is the JAX package's npz with the flax-msgpack bytes
(`models/flax_msgpack.py`), so either package loads the other's.  The
initial weights (`init_params`) follow flax's distributions, but not its
`PRNGKey` stream, which torch cannot replay.  Products are true fp32 (TF32
off on CUDA).  Entry points run on ``device="cuda"`` unless told
``"cpu"``; without a card they raise.

Not ported: the data-parallel step (a `mesh` raises, ROADMAP.md queue 1
item 6).
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spotify_recommender_tpu_torch.core.config import TwoTowerConfig
from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.core.timing import Spans, span
from spotify_recommender_tpu_torch.models import flax_msgpack, mf
from spotify_recommender_tpu_torch.ops import similarity

log = get_logger(__name__)

Device = Union[str, torch.device]
Params = Dict[str, torch.Tensor]
TOWERS = ("query_tower", "item_tower")
# flax's lecun_normal: a normal truncated at +-2 std, rescaled so that the
# truncated draw has variance 1 / fan_in (jax.nn.initializers.variance_scaling)
TRUNC_STD_CORRECTION = 0.87962566103423978
MESH_NOT_PORTED = ("a device mesh (the data-parallel two-tower step) is not "
                   "ported yet (ROADMAP.md queue 1 item 6)")


class Tower(nn.Module):
    """MLP tower -> embedding (L2-normalized unless `normalize=False`)."""

    def __init__(self, in_dim: int, hidden_dims, embedding_dim: int,
                 compute_dtype: torch.dtype = torch.float32,
                 normalize: bool = True, device: Optional[Device] = None):
        super().__init__()
        dims = [in_dim, *hidden_dims, embedding_dim]
        # no init here: `init_params` or a loaded state dict fills them
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, device=device)
            for a, b in zip(dims[:-1], dims[1:]))
        self.compute_dtype = compute_dtype
        self.normalize = normalize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        for j, layer in enumerate(self.layers):
            # flax's Dense: the product rounded to the compute dtype, then
            # the bias added in it
            x = x @ layer.weight.to(dt).T + layer.bias.to(dt)
            if j < len(self.layers) - 1:
                x = torch.relu(x)
        x = x.float()
        if not self.normalize:
            return x
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / norm.clamp_min(1e-8)


class TwoTower(nn.Module):
    def __init__(self, config: TwoTowerConfig, feat_dim: int,
                 device: Optional[Device] = None):
        super().__init__()
        dt = (torch.bfloat16 if getattr(config, "compute_dtype", "float32")
              == "bfloat16" else torch.float32)
        dims = tuple(config.hidden_dims)
        self.config = config
        self.feat_dim = feat_dim
        self.query_tower = Tower(feat_dim, dims, config.embedding_dim, dt,
                                 device=device)
        # item embeddings optionally carry magnitude (popularity); the query
        # side stays unit-norm so logits remain scale-bounded
        self.item_tower = Tower(
            feat_dim, dims, config.embedding_dim, dt,
            normalize=getattr(config, "normalize_items", True), device=device)

    def forward(self, q: torch.Tensor, i: torch.Tensor):
        return self.query_tower(q), self.item_tower(i)

    def embed_query(self, q: torch.Tensor) -> torch.Tensor:
        return self.query_tower(q)

    def embed_item(self, i: torch.Tensor) -> torch.Tensor:
        return self.item_tower(i)


def init_params(config: TwoTowerConfig, feat_dim: int,
                generator: torch.Generator) -> Params:
    """Initial fp32 parameters on the CPU, in flax's distributions: each
    weight lecun_normal (a normal of std sqrt(1 / fan_in) / 0.8796...,
    truncated at +-2 std), each bias zero.  `train` takes its initial
    weights from here alone."""
    dims = [feat_dim, *config.hidden_dims, config.embedding_dim]
    out: Params = {}
    for tower in TOWERS:
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            std = math.sqrt(1.0 / a) / TRUNC_STD_CORRECTION
            w = torch.empty((b, a), dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            out[f"{tower}.layers.{j}.weight"] = w
            out[f"{tower}.layers.{j}.bias"] = torch.zeros(b)
    return out


def params_from_jax(tree) -> Params:
    """The JAX package's parameter tree (``{"params": {"query_tower" |
    "item_tower": {"Dense_i": {"kernel" (in, out), "bias"}}}}`` of numpy or
    JAX arrays, as its `model.init`, `train` or `load_model` give it) as
    the port's fp32 `state_dict` on the CPU (each kernel transposed)."""
    out: Params = {}
    for tower in TOWERS:
        dense = tree["params"][tower]
        for j in range(len(dense)):
            layer = dense[f"Dense_{j}"]
            kernel = np.asarray(layer["kernel"], np.float32)
            out[f"{tower}.layers.{j}.weight"] = torch.from_numpy(kernel.T.copy())
            out[f"{tower}.layers.{j}.bias"] = torch.from_numpy(
                np.array(layer["bias"], np.float32))
    return out


def params_to_jax(params) -> Dict:
    """`params_from_jax`'s inverse: a `state_dict` (or a `TwoTower`) as the
    JAX tree of numpy arrays, its keys in the sorted order of a trained JAX
    model's tree (so `flax_msgpack.dumps` of it is the JAX file's bytes)."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    tree: Dict = {}
    for name, t in params.items():
        tower, _, j, kind = name.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        leaf = tree.setdefault(tower, {}).setdefault(f"Dense_{j}", {})
        leaf["kernel" if kind == "weight" else "bias"] = (
            arr.T.copy() if kind == "weight" else arr.copy())

    def ordered(d):
        return {k: ordered(d[k]) if isinstance(d[k], dict) else d[k]
                for k in sorted(d)}

    return {"params": ordered(tree)}


def feat_dim_of(params: Params) -> int:
    return int(params["query_tower.layers.0.weight"].shape[1])


def make_model(params: Params, config: TwoTowerConfig,
               device: Device = "cuda") -> TwoTower:
    """A `TwoTower` on `device` holding `params` (TF32 off on a card)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        similarity.disable_tf32()
    model = TwoTower(config, feat_dim_of(params), device=dev)
    model.load_state_dict(params)
    return model


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def info_nce_loss(q_emb: torch.Tensor, i_emb: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """In-batch softmax cross entropy of (b, D) queries against their
    row-aligned (b, D) positive items, every other item of the batch a
    negative; query to item only, as the JAX function computes."""
    logits = (q_emb.float() @ i_emb.float().T) / temperature
    labels = torch.arange(q_emb.shape[0], device=q_emb.device)
    return F.cross_entropy(logits, labels)


def make_optimizer(model: nn.Module, config: TwoTowerConfig):
    # optax.adam's defaults
    return torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def train_step(model: TwoTower, optimizer: torch.optim.Optimizer,
               q_batch: torch.Tensor, i_batch: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """One Adam step on the in-batch loss; returns the loss (on the
    device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = info_nce_loss(model.embed_query(q_batch), model.embed_item(i_batch),
                         temperature)
    loss.backward()
    optimizer.step()
    return loss.detach()


@dataclasses.dataclass
class TrainResult:
    params: Params
    losses: list


def same_genre_pairs(
    features: np.ndarray,
    genre_ids: np.ndarray,
    batch_size: int,
    rng: np.random.Generator,
    noise: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Self-supervised positives: (song, other song of the same genre),
    with small feature noise on the query side as augmentation."""
    n = features.shape[0]
    anchors = rng.integers(0, n, size=batch_size)
    positives = np.empty(batch_size, np.int64)
    by_genre: Dict[int, np.ndarray] = {}
    for b, a in enumerate(anchors):
        g = int(genre_ids[a])
        pool = by_genre.get(g)
        if pool is None:
            pool = np.flatnonzero(genre_ids == g)
            by_genre[g] = pool
        positives[b] = pool[rng.integers(0, len(pool))]
    q = features[anchors] + noise * rng.standard_normal(
        (batch_size, features.shape[1])
    ).astype(np.float32)
    return q.astype(np.float32), features[positives].astype(np.float32)


def colisten_pair_fn(
    interactions,
    features: np.ndarray,
    rng: np.random.Generator,
    noise: float = 0.0,
):
    """Pair source from implicit feedback: positives are two items played
    by the same user (co-listen).  Returns a pair_fn(batch_size) for
    `train`.  `interactions` is a models.mf.Interactions; users with fewer
    than two interactions are excluded."""
    degrees = interactions.mask.sum(axis=1)
    eligible = np.nonzero(degrees >= 2)[0]
    if len(eligible) == 0:
        raise ValueError("no users with >= 2 interactions")
    item_idx = interactions.item_idx

    def pair_fn(batch_size: int):
        u = eligible[rng.integers(0, len(eligible), batch_size)]
        d = degrees[u]
        # two distinct valid positions per sampled user, vectorized:
        # a uniform in [0, d), p uniform in [0, d-1) shifted past a
        a = rng.integers(0, d)
        p = rng.integers(0, d - 1)
        p = np.where(p >= a, p + 1, p)
        q_rows = item_idx[u, a]
        p_rows = item_idx[u, p]
        q = features[q_rows].astype(np.float32)
        if noise:
            q = q + noise * rng.standard_normal(q.shape).astype(np.float32)
        return q, features[p_rows].astype(np.float32)

    return pair_fn


def train(
    features: np.ndarray,
    genre_ids: np.ndarray,
    config: TwoTowerConfig,
    pair_fn: Optional[Callable] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    mesh=None,
    device: Device = "cuda",
    stats: Optional[Dict[str, List[float]]] = None,
) -> TrainResult:
    """Train the two towers on `device`; returns the final parameters (on
    the device) and the losses of steps s % 50 == 0 and of the last step.

    With `checkpoint_dir`, params and Adam state checkpoint every
    `checkpoint_every` steps (`train/checkpoint.py`, ``step_<n>.pt``) and
    training resumes from the latest checkpoint.  As in the JAX package the
    pair stream then restarts from the seed, so a resumed run repeats the
    first batches and is not the uninterrupted run (ROADMAP 3c).  With a
    `stats` dict, each step appends its host pair sampling ms to
    ``stats["pairs_ms"]`` and its device step ms (CUDA events on a card) to
    ``stats["step_ms"]``.  A `mesh` raises `ValueError` (not ported)."""
    if mesh is not None:
        raise ValueError(MESH_NOT_PORTED)
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    feat_dim = features.shape[1]
    model = make_model(init_params(config, feat_dim,
                                   torch.Generator().manual_seed(config.seed)),
                       config, dev)
    optimizer = make_optimizer(model, config)

    ckpt_mgr = None
    start_step = 0
    if checkpoint_dir is not None:
        from spotify_recommender_tpu_torch.train.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(checkpoint_dir)
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            saved = ckpt_mgr.restore(latest, device=dev)
            model.load_state_dict(saved["params"])
            optimizer.load_state_dict(saved["opt_state"])
            start_step = latest + 1
            log.info("resumed two-tower training from step %d", start_step)
    pair_fn = pair_fn or (
        lambda b: same_genre_pairs(features, genre_ids, b, rng)
    )

    spans = Spans(dev) if stats is not None else None
    losses = []
    for s in range(start_step, config.num_steps):
        t0 = time.perf_counter()
        q, i = pair_fn(config.batch_size)
        if stats is not None:
            stats.setdefault("pairs_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
        with span(spans, "step"):
            loss = train_step(model, optimizer, torch.as_tensor(q, device=dev),
                              torch.as_tensor(i, device=dev),
                              config.temperature)
        if spans is not None:
            stats.setdefault("step_ms", []).append(spans.read()["step"])
        if s % 50 == 0 or s == config.num_steps - 1:
            losses.append(float(loss))
        if ckpt_mgr is not None and (
            (s + 1) % checkpoint_every == 0 or s == config.num_steps - 1
        ):
            ckpt_mgr.save(s, {"params": model.state_dict(),
                              "opt_state": optimizer.state_dict()}, force=True)
    if ckpt_mgr is not None:
        ckpt_mgr.wait()
        ckpt_mgr.close()
    if not losses:  # fully resumed past num_steps
        losses = [float("nan")]
    log.info("two-tower done: loss %.4f -> %.4f", losses[0], losses[-1])
    return TrainResult(params=model.state_dict(), losses=losses)


# --------------------------------------------------------------------------
# Serving and evaluation
# --------------------------------------------------------------------------


def _embed(params: Params, features: np.ndarray, config: TwoTowerConfig,
           side: str, batch: int, device: Device) -> np.ndarray:
    model = make_model(params, config, device)
    tower = model.query_tower if side == "query" else model.item_tower
    feats = np.asarray(features, np.float32)
    dev = next(model.parameters()).device
    out = []
    with torch.no_grad():
        for s in range(0, max(1, feats.shape[0]), batch):
            x = torch.as_tensor(feats[s:s + batch], device=dev)
            out.append(tower(x).cpu().numpy())
    return np.concatenate(out, axis=0)


def embed_catalog(params: Params, features: np.ndarray,
                  config: TwoTowerConfig, batch: int = 8192,
                  device: Device = "cuda") -> np.ndarray:
    """Item-tower embeddings for the whole catalog (serving-side corpus),
    `batch` rows at a time on `device`; numpy (N, D) fp32."""
    return _embed(params, features, config, "item", batch, device)


def embed_queries(params: Params, features: np.ndarray,
                  config: TwoTowerConfig, device: Device = "cuda") -> np.ndarray:
    """Query-tower embeddings of (B, F) features, in one batch."""
    feats = np.asarray(features, np.float32)
    return _embed(params, feats, config, "query", max(1, len(feats)), device)


def embed_user_profile(
    params: Params,
    liked_item_features: np.ndarray,   # (n_liked, F)
    config: TwoTowerConfig,
    weights: Optional[np.ndarray] = None,
    device: Device = "cuda",
) -> np.ndarray:
    """User/context embedding from a listening history: the query tower
    applied to the (optionally weighted) mean of liked items' features.
    Returns (D,)."""
    feats = np.asarray(liked_item_features, np.float32)
    if feats.ndim != 2 or len(feats) == 0:
        raise ValueError("liked_item_features must be a non-empty (n, F) array")
    if weights is not None:
        w = np.asarray(weights, np.float32)
        profile = (feats * w[:, None]).sum(0) / max(w.sum(), 1e-9)
    else:
        profile = feats.mean(0)
    return embed_queries(params, profile[None, :], config, device)[0]


def save_model(path: str, params, config: TwoTowerConfig,
               feat_dim: Optional[int] = None) -> None:
    """The JAX package's model file: an npz of the flax-msgpack parameter
    bytes (`params_to_jax`), the JSON config and the input width, written
    to the exact `path`.  No pickle: loading runs with
    allow_pickle=False."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    if feat_dim is None:
        feat_dim = feat_dim_of(params)
    blob = flax_msgpack.dumps(params_to_jax(params))
    with open(path, "wb") as f:
        np.savez_compressed(
            f,
            format_version=np.int32(2),
            params_msgpack=np.frombuffer(blob, np.uint8),
            config_json=np.str_(json.dumps(dataclasses.asdict(config))),
            feat_dim=np.int32(feat_dim),
        )
    log.info("two-tower model saved: %s", path)


def load_model(path: str) -> Tuple[Params, TwoTowerConfig]:
    """A model file of either package -> (`state_dict` on the CPU,
    config); the parameters must have the shapes the config and
    ``feat_dim`` give."""
    with np.load(path, allow_pickle=False) as z:
        config_raw = json.loads(str(z["config_json"][()]))
        feat_dim = int(z["feat_dim"])
        param_bytes = z["params_msgpack"].tobytes()
    cfg = dict(config_raw)
    if "hidden_dims" in cfg:
        cfg["hidden_dims"] = tuple(cfg["hidden_dims"])
    config = TwoTowerConfig(**cfg)
    params = params_from_jax(flax_msgpack.loads(param_bytes))
    want = TwoTower(config, feat_dim, device="meta").state_dict()
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != {k: tuple(v.shape) for k, v in want.items()}:
        raise ValueError(f"{path}: parameter shapes {got} do not match the "
                         f"config's model at feat_dim {feat_dim}")
    return params, config


def train_from_cli(
    catalog_path: str,
    config: TwoTowerConfig,
    output: str,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    interactions_path: Optional[str] = None,
    device: Device = "cuda",
) -> int:
    from spotify_recommender_tpu_torch.data.catalog import load_catalog

    cat = load_catalog(catalog_path)
    pair_fn = None
    if interactions_path:
        # collaborative positives (co-listen pairs) instead of the default
        # same-genre self-supervision
        inter = mf.load_interactions(interactions_path)
        if inter.num_items > len(cat):
            print(
                f"Error: interactions reference item {inter.num_items - 1} "
                f"but the catalog has only {len(cat)} rows",
                file=sys.stderr,
            )
            return 1
        pair_fn = colisten_pair_fn(
            inter, cat.features, np.random.default_rng(config.seed)
        )
    result = train(
        cat.features, cat.genre_ids, config,
        mesh=mesh, pair_fn=pair_fn, checkpoint_dir=checkpoint_dir,
        device=device,
    )
    save_model(output, result.params, config)
    print(f"two-tower trained: final loss {result.losses[-1]:.4f}")
    return 0


def evaluate_colisten(
    params: Params,
    config: TwoTowerConfig,
    features: np.ndarray,
    interactions,
    k: int = 10,
    holdout: int = 1,
    seed: int = 0,
    max_eval_users: int = 10_000,
    device: Device = "cuda",
) -> Dict[str, float]:
    """recall@k / NDCG@k of a two-tower model on held-out co-listen pairs.

    For each eligible user one interaction is held out; the QUERY is the
    tower embedding of another item the user played, and the model must
    rank the held-out item (scored by the chunked MIPS top-k that evaluates
    MF, with the user's remaining items excluded)."""
    train_i, held_idx, held_mask, seen_idx, seen_mask = (
        mf.split_leave_k_out_arrays(interactions, k=holdout, seed=seed)
    )
    item_emb = embed_catalog(params, features, config, device=device)
    rng = np.random.default_rng(seed)
    eligible = np.nonzero(held_mask.any(axis=1) & train_i.mask.any(axis=1))[0]
    if len(eligible) == 0:
        raise ValueError("no users with both train and held-out items")
    eval_users = rng.choice(
        eligible, size=min(max_eval_users, len(eligible)), replace=False
    )
    # query = tower embedding of one TRAIN item per user
    deg = train_i.mask[eval_users].sum(axis=1)
    pick = rng.integers(0, deg)
    q_rows = train_i.item_idx[eval_users, pick]
    q_emb = embed_queries(params, features[q_rows], config, device)
    return mf.evaluate_ranking_arrays(
        q_emb,
        item_emb,
        np.arange(len(eval_users)),
        held_idx[eval_users],
        held_mask[eval_users],
        k=k,
        seen_idx=seen_idx[eval_users],
        seen_mask=seen_mask[eval_users],
        device=device,
    )
