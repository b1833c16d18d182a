"""The port's two-tower model (`models/two_tower.py`, `models/flax_msgpack.py`)
on the CPU against the JAX package's `models/two_tower.py`.

The JAX model initializes from `jax.random.PRNGKey`, which torch cannot
replay, so where the two are compared step by step the port starts from
the JAX weights (`params_from_jax` of a JAX `model.init`, put in through
`init_params`).  Tolerances, each measured on an x86-64 CPU:
- embeddings in fp32 within 1e-6 (measured <= 3.6e-7); in bf16 each
  entry within one bf16 rounding of flax's (rtol 2^-7, atol 1e-6), and at
  most 0.1 % of entries beyond 1e-6: the port rounds where flax rounds, so
  entries part only where the two fp32 sums under a bf16 rounding straddle
  a rounding boundary (measured: 1 of 65,536 entries, by 1.6e-5, relative
  5.3e-3).  The JAX side is flax's eager `model.apply`: under `jax.jit`
  XLA:CPU may keep excess precision past a bf16 rounding (its
  `xla_allow_excess_precision`), at some shapes and not others (the
  jitted `embed_catalog` of 400 rows parts from the eager apply by up to
  1.7e-3, of 4096 rows not at all), so only the eager apply has fixed
  rounding points to hold the port to;
- the loss and its gradient within 1e-6; 20 Adam steps' losses within 1e-5
  each in fp32; `train`'s recorded losses over 150 steps within 1e-5
  (measured 1.2e-6).  In bf16 the first step's loss within 1e-6 and the
  next ones within 1e-2 (measured <= 4.2e-3 over 3 seeds): the towers'
  kernel gradients are bitwise flax's, but a bias gradient sums the batch
  of bf16 cotangents, which torch accumulates in fp32 and rounds once while
  XLA:CPU rounds inside its blocked bf16 sum (1.2e-2 apart on a gradient
  of ~1), the jitted step may keep excess precision, and Adam turns both
  into different steps;
- the quality row's two-tower keys with JAX's init carried over: recall@10
  within 0.005 and NDCG@10 within 0.002 of the JAX row (0.1478 / 0.0764).
  2000 Adam steps amplify rounding: the JAX package itself, its initial
  weights scaled by (1 + 1e-7 * N(0, 1)), reads 0.1443-0.1483 / 0.0756-
  0.0769 over 9 runs, so 0.002 on recall is below its own spread.  With
  the port's own initialization the row must land in 0.12-0.16 /
  0.065-0.085: JAX's six init seeds give 0.1306-0.1489 / 0.0702-0.0774.

Every test runs torch's CPU ops in one thread (`one_thread`): training
enters thousands of small OpenMP regions, whose threads, with other test
processes on the cores, wait on each other (six quality rows at once on
an 8-core x86-64 CPU: 790 s each at 8 threads, 4.7 s at one).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from spotify_recommender_tpu.core.config import TwoTowerConfig as JConfig
from spotify_recommender_tpu.models import mf as jmf
from spotify_recommender_tpu.models import two_tower as jtt
from spotify_recommender_tpu_torch import benchmark
from spotify_recommender_tpu_torch.core.config import TwoTowerConfig
from spotify_recommender_tpu_torch.models import flax_msgpack, mf
from spotify_recommender_tpu_torch.models import two_tower as tt

EMB_ATOL = 1e-6
BF16_RTOL = 2.0**-7       # one bf16 rounding of an entry
LOSS_ATOL = 1e-5
SMALL = dict(embedding_dim=16, hidden_dims=(32,), batch_size=64,
             num_steps=150, learning_rate=3e-3, seed=0)


def jconfig(cfg: TwoTowerConfig) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


def jax_init(cfg: TwoTowerConfig, feat_dim: int = 12, seed=None):
    model = jtt.TwoTower(jconfig(cfg))
    key = jax.random.PRNGKey(cfg.seed if seed is None else seed)
    return model.init(key, jnp.zeros((1, feat_dim)), jnp.zeros((1, feat_dim)))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def carried_init(monkeypatch):
    """The port's `train` starts from the JAX package's initial weights."""
    monkeypatch.setattr(tt, "init_params", lambda cfg, f, gen: (
        tt.params_from_jax(jax_init(cfg, f))))


@pytest.fixture(scope="module")
def clustered_data():
    """tests/test_two_tower.py's data: four genre clusters."""
    rng = np.random.default_rng(0)
    n, g = 400, 4
    genre_ids = np.repeat(np.arange(g), n // g).astype(np.int32)
    centers = rng.random((g, 12)).astype(np.float32)
    feats = centers[genre_ids] + 0.05 * rng.standard_normal((n, 12)).astype(
        np.float32)
    return feats.astype(np.float32), genre_ids


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def assert_embeddings_close(ours, theirs, compute_dtype):
    if compute_dtype == "float32":
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=EMB_ATOL)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=BF16_RTOL, atol=EMB_ATOL)
        assert (np.abs(ours - theirs) > EMB_ATOL).mean() <= 1e-3


def jax_embed(tree, x, cfg: TwoTowerConfig, side: str = "item"):
    """flax's eager apply of one tower (fixed bf16 rounding points)."""
    method = (jtt.TwoTower.embed_item if side == "item"
              else jtt.TwoTower.embed_query)
    return np.asarray(jtt.TwoTower(jconfig(cfg)).apply(
        tree, jnp.asarray(x), method=method))


def sorted_tree(d):
    return {k: sorted_tree(d[k]) if isinstance(d[k], dict) else np.asarray(d[k])
            for k in sorted(d)}


# --------------------------------------------------------------------------
# flax's msgpack subset
# --------------------------------------------------------------------------


@pytest.mark.parametrize("trained", [False, True])
def test_msgpack_dumps_is_byte_equal_to_flax(trained, clustered_data):
    """On a tower tree as `model.init` orders it, and as training orders
    it (jax sorts dict keys); then back through `loads`."""
    cfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,), batch_size=16,
                         num_steps=2)
    if trained:
        feats, genres = clustered_data
        tree = jtt.train(feats, genres, jconfig(cfg)).params
    else:
        tree = jax_init(cfg)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    blob = serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == blob
    assert_tree_equal(flax_msgpack.loads(blob), tree)
    if trained:
        assert flax_msgpack.dumps(tt.params_to_jax(
            tt.params_from_jax(tree))) == blob


def test_msgpack_covers_every_size_form_and_scalars():
    """Every length form of str, bin, array, map and ext; a numpy scalar
    (ext code 3) flax wrote decodes to the scalar."""
    rng = np.random.default_rng(1)
    tree = {"s" * 40: {"big": rng.random((300, 300)).astype(np.float32),
                       "wide": np.ones((70000, 1), np.int8),
                       "empty": np.zeros((0,), np.float32),
                       "ints": np.arange(-3, 3, dtype=np.int64),
                       "rank17": np.ones((1,) * 17, np.float32)},
            "x" * 300: {"k": np.ones(2, np.float16)}}
    blob = serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == blob
    back = flax_msgpack.loads(blob)
    assert_tree_equal(back, tree)
    assert_tree_equal(back, serialization.msgpack_restore(blob))
    scalar = flax_msgpack.loads(serialization.to_bytes({"a": np.float32(3.5)}))
    assert scalar["a"] == np.float32(3.5) and scalar["a"].dtype == np.float32


@pytest.mark.parametrize("bad,what", [
    (b"\x81\xa1a\xc0", "0xc0"),                      # nil
    (b"\x81\xa1a\xcb" + b"\x00" * 8, "0xcb"),        # float64
    (b"\x91\x01", "map at the top level"),
    (b"\x81\xa1a\x01\x00", "trailing"),
    (b"\x81\xa1a\xd4\x02\x00", "ext type 2"),        # a complex number
    (b"\x81\xa1a\x82\xb9__msgpack_chunked_array__\xc3\xa1b\x01", "0xc3"),
    (b"\x81\xa1a\x81\xb9__msgpack_chunked_array__\x01", "chunked"),
    (b"\x81\xa1a\xda\x00", "truncated"),
])
def test_msgpack_loads_raises_outside_the_subset(bad, what):
    with pytest.raises(ValueError, match=what):
        flax_msgpack.loads(bad)


def test_msgpack_dumps_refuses_what_flax_would_chunk(monkeypatch):
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 16)
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.dumps({"a": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="leaf"):
        flax_msgpack.dumps({"a": np.float32(1.5)})


# --------------------------------------------------------------------------
# Parameters, forward pass, model files
# --------------------------------------------------------------------------


def test_params_round_trip_and_layout():
    cfg = TwoTowerConfig(**SMALL)
    tree = jax_init(cfg)
    sd = tt.params_from_jax(tree)
    assert list(sd) == [f"{t}.layers.{j}.{k}" for t in tt.TOWERS
                        for j in range(2) for k in ("weight", "bias")]
    assert sd["query_tower.layers.0.weight"].shape == (32, 12)
    np.testing.assert_array_equal(
        sd["item_tower.layers.1.weight"].numpy(),
        np.asarray(tree["params"]["item_tower"]["Dense_1"]["kernel"]).T)
    assert_tree_equal(tt.params_to_jax(sd), sorted_tree(tree))
    model = tt.make_model(sd, cfg, "cpu")
    assert_tree_equal(tt.params_to_jax(model), sorted_tree(tree))


def test_init_params_follows_flax_distributions():
    cfg = TwoTowerConfig()
    a = tt.init_params(cfg, 12, torch.Generator().manual_seed(0))
    b = tt.init_params(cfg, 12, torch.Generator().manual_seed(0))
    c = tt.init_params(cfg, 12, torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query_tower.layers.0.weight"],
                           c["query_tower.layers.0.weight"])
    tree = jax_init(cfg)["params"]["query_tower"]
    for j, fan_in in enumerate((12, 256, 128)):
        w = a[f"query_tower.layers.{j}.weight"]
        std = np.sqrt(1.0 / fan_in) / tt.TRUNC_STD_CORRECTION
        assert w.abs().max() <= 2 * std
        assert (a[f"query_tower.layers.{j}.bias"] == 0).all()
        # the truncated draw's std is sqrt(1/fan_in), as flax's
        jstd = np.asarray(tree[f"Dense_{j}"]["kernel"]).std()
        assert abs(w.std().item() - np.sqrt(1 / fan_in)) < 0.05 / np.sqrt(fan_in)
        assert abs(jstd - np.sqrt(1 / fan_in)) < 0.05 / np.sqrt(fan_in)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize_items", [True, False])
@pytest.mark.parametrize("hidden,dim", [((32,), 16), ((16, 8), 8)])
def test_forward_equals_jax(compute_dtype, normalize_items, hidden, dim):
    cfg = TwoTowerConfig(embedding_dim=dim, hidden_dims=hidden,
                         compute_dtype=compute_dtype,
                         normalize_items=normalize_items)
    tree = jax_init(cfg, seed=3)
    model = jtt.TwoTower(jconfig(cfg))
    x = np.random.default_rng(3).random((4096, 12)).astype(np.float32)
    jq = np.asarray(model.apply(tree, jnp.asarray(x),
                                method=jtt.TwoTower.embed_query))
    ji = np.asarray(model.apply(tree, jnp.asarray(x),
                                method=jtt.TwoTower.embed_item))
    sd = tt.params_from_jax(tree)
    pq = tt.embed_queries(sd, x, cfg, device="cpu")
    pi = tt.embed_catalog(sd, x, cfg, batch=1000, device="cpu")
    assert pq.dtype == pi.dtype == np.float32
    assert_embeddings_close(pq, jq, compute_dtype)
    assert_embeddings_close(pi, ji, compute_dtype)
    np.testing.assert_allclose(np.linalg.norm(pq, axis=1), 1.0, atol=1e-6)
    if not normalize_items:
        assert np.abs(np.linalg.norm(pi, axis=1) - 1.0).max() > 0.01


def test_bf16_rounds_where_flax_rounds():
    """The bias is added after the product's bf16 rounding: `addmm`'s
    fused bias (one rounding) differs from the port on some entries, the
    port does not differ from flax."""
    cfg = TwoTowerConfig(embedding_dim=16, hidden_dims=(32,),
                         compute_dtype="bfloat16")
    tree = jax_init(cfg, seed=5)
    sd = tt.params_from_jax(tree)
    x = torch.from_numpy(np.random.default_rng(5).random((512, 12),
                                                         dtype=np.float32))
    w = sd["query_tower.layers.0.weight"].bfloat16()
    b = sd["query_tower.layers.0.bias"].bfloat16() + 0.37   # a live bias
    xb = x.bfloat16()
    port = xb @ w.T + b
    fused = torch.addmm(b, xb, w.T)
    flax_like = (xb.float() @ w.float().T).bfloat16().float() + b.float()
    assert torch.equal(port, flax_like.bfloat16())
    assert not torch.equal(port, fused)


def test_user_profile_is_the_query_tower_of_the_mean(clustered_data):
    feats, _ = clustered_data
    cfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,))
    tree = jax_init(cfg)
    sd = tt.params_from_jax(tree)
    w = np.asarray([1.0, 2.0, 0.5], np.float32)
    for weights in (None, w):
        ours = tt.embed_user_profile(sd, feats[:3], cfg, weights=weights,
                                     device="cpu")
        theirs = jtt.embed_user_profile(tree, feats[:3], jconfig(cfg),
                                        weights=weights)
        assert ours.shape == (8,)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=EMB_ATOL)
    with pytest.raises(ValueError, match="non-empty"):
        tt.embed_user_profile(sd, feats[:0], cfg, device="cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_model_files_load_in_either_package(tmp_path, compute_dtype,
                                            clustered_data):
    feats, genres = clustered_data
    cfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,), batch_size=16,
                         num_steps=3, compute_dtype=compute_dtype,
                         normalize_items=False)
    jres = jtt.train(feats, genres, jconfig(cfg))
    jtt.save_model(str(tmp_path / "jax_tt"), jres.params, jconfig(cfg))
    params, cfg2 = tt.load_model(str(tmp_path / "jax_tt"))
    assert cfg2 == cfg
    assert_tree_equal(tt.params_to_jax(params),
                      jax.tree_util.tree_map(np.asarray, jres.params))
    assert_embeddings_close(
        tt.embed_catalog(params, feats, cfg2, device="cpu"),
        jax_embed(jres.params, feats, cfg), compute_dtype)

    pres = tt.train(feats, genres, cfg, device="cpu")
    tt.save_model(str(tmp_path / "port_tt"), pres.params, cfg)
    jparams, jcfg = jtt.load_model(str(tmp_path / "port_tt"))
    assert jcfg == jconfig(cfg)
    assert_tree_equal(jax.tree_util.tree_map(np.asarray, jparams),
                      tt.params_to_jax(pres.params))
    assert_embeddings_close(
        tt.embed_catalog(pres.params, feats, cfg, device="cpu"),
        jax_embed(jparams, feats, cfg), compute_dtype)
    if compute_dtype == "float32":
        np.testing.assert_allclose(
            jtt.embed_catalog(jparams, feats, jcfg),
            tt.embed_catalog(pres.params, feats, cfg, device="cpu"),
            rtol=0, atol=EMB_ATOL)
    with np.load(tmp_path / "jax_tt") as j, np.load(tmp_path / "port_tt") as p:
        assert sorted(p.files) == sorted(j.files)
        assert str(p["config_json"]) == str(j["config_json"])
        assert int(p["format_version"]) == 2 and int(p["feat_dim"]) == 12
    # the port's bytes of the JAX model's params are the JAX file's
    tt.save_model(str(tmp_path / "again"), params, cfg2)
    with np.load(tmp_path / "jax_tt") as j, np.load(tmp_path / "again") as p:
        assert p["params_msgpack"].tobytes() == j["params_msgpack"].tobytes()


def test_load_model_checks_shapes(tmp_path):
    cfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,))
    sd = tt.params_from_jax(jax_init(cfg))
    tt.save_model(str(tmp_path / "m"), sd, dataclasses.replace(cfg,
                                                             embedding_dim=4))
    with pytest.raises(ValueError, match="shapes"):
        tt.load_model(str(tmp_path / "m"))


# --------------------------------------------------------------------------
# Loss and training
# --------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.05, 1.0])
def test_info_nce_loss_and_gradient_equal_jax(temperature):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    i = rng.standard_normal((64, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jl, (jgq, jgi) = jax.value_and_grad(
        lambda a, b: jtt.info_nce_loss(a, b, temperature), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(i))
    tq = torch.from_numpy(q).requires_grad_(True)
    ti = torch.from_numpy(i).requires_grad_(True)
    loss = tt.info_nce_loss(tq, ti, temperature)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_twenty_steps_equal_jax_step_by_step(compute_dtype, clustered_data):
    """The same carried-over weights and the same pair draws through
    optax.adam and the port's Adam: each step's loss within 1e-5 in fp32;
    in bf16 the first within 1e-6, the rest within 1e-2."""
    feats, genres = clustered_data
    cfg = TwoTowerConfig(**{**SMALL, "compute_dtype": compute_dtype})
    tree = jax_init(cfg)
    jmodel = jtt.TwoTower(jconfig(cfg))
    opt = optax.adam(cfg.learning_rate)
    jstep = jax.jit(jtt.make_train_step(jmodel, opt, cfg.temperature))
    jparams, jstate = tree, opt.init(tree)
    model = tt.make_model(tt.params_from_jax(tree), cfg, "cpu")
    optimizer = tt.make_optimizer(model, cfg)
    rng = np.random.default_rng(11)
    for step in range(20):
        q, i = tt.same_genre_pairs(feats, genres, cfg.batch_size, rng)
        jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(q),
                                    jnp.asarray(i))
        pl = tt.train_step(model, optimizer, torch.from_numpy(q),
                           torch.from_numpy(i), cfg.temperature)
        tol = (LOSS_ATOL if compute_dtype == "float32"
               else 1e-6 if step == 0 else 1e-2)
        assert abs(pl.item() - float(jl)) <= tol


def test_bf16_kernel_gradients_are_flax_bits(clustered_data):
    """One bf16 backward from the same weights and batch: every kernel's
    gradient equals flax's bit for bit; a bias gradient (a bf16 sum over
    the batch) is within 2e-2 of it (XLA:CPU rounds inside the sum)."""
    feats, genres = clustered_data
    cfg = TwoTowerConfig(**{**SMALL, "compute_dtype": "bfloat16"})
    tree = jax_init(cfg)
    jmodel = jtt.TwoTower(jconfig(cfg))
    q, i = tt.same_genre_pairs(feats, genres, 64, np.random.default_rng(11))

    def loss_fn(p):
        return jtt.info_nce_loss(
            jmodel.apply(p, jnp.asarray(q), method=jtt.TwoTower.embed_query),
            jmodel.apply(p, jnp.asarray(i), method=jtt.TwoTower.embed_item),
            cfg.temperature)

    jgrad = jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(tree))
    model = tt.make_model(tt.params_from_jax(tree), cfg, "cpu")
    tt.info_nce_loss(model.embed_query(torch.from_numpy(q)),
                     model.embed_item(torch.from_numpy(i)),
                     cfg.temperature).backward()
    pgrad = tt.params_to_jax({k: p.grad for k, p in model.named_parameters()})
    for tower in tt.TOWERS:
        for dense, g in jgrad["params"][tower].items():
            ours = pgrad["params"][tower][dense]
            np.testing.assert_array_equal(ours["kernel"], g["kernel"])
            np.testing.assert_allclose(ours["bias"], g["bias"], rtol=0,
                                       atol=2e-2)


def test_train_losses_equal_jax_from_its_init(carried_init, clustered_data):
    feats, genres = clustered_data
    cfg = TwoTowerConfig(**SMALL)
    ours = tt.train(feats, genres, cfg, device="cpu")
    theirs = jtt.train(feats, genres, jconfig(cfg))
    assert len(ours.losses) == len(theirs.losses) == 4      # 0, 50, 100, 149
    np.testing.assert_allclose(ours.losses, theirs.losses, rtol=0,
                               atol=LOSS_ATOL)
    assert ours.losses[-1] < ours.losses[0]


def test_train_from_its_own_init_learns_the_clusters(clustered_data):
    """tests/test_two_tower.py's checks, on the port's own init."""
    feats, genres = clustered_data
    cfg = TwoTowerConfig(**SMALL)
    res = tt.train(feats, genres, cfg, device="cpu")
    assert res.losses[-1] < res.losses[0]
    emb = tt.embed_catalog(res.params, feats, cfg, device="cpu")
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    sims = emb @ emb.T
    same = genres[:, None] == genres[None, :]
    intra = sims[same & ~np.eye(len(feats), dtype=bool)].mean()
    assert intra > sims[~same].mean() + 0.2
    stats = {}
    tt.train(feats, genres, dataclasses.replace(cfg, num_steps=5),
             device="cpu", stats=stats)
    assert len(stats["pairs_ms"]) == len(stats["step_ms"]) == 5


def test_resume_restarts_the_pair_stream_as_jax(carried_init, tmp_path,
                                                clustered_data):
    """10 steps checkpointed every 5, then a run to 20 from the same
    directory: it resumes at step 10 with the pair stream restarted from
    the seed, as the JAX package does, so it repeats the first batches and
    is not the uninterrupted 20-step run."""
    feats, genres = clustered_data
    cfg = TwoTowerConfig(**{**SMALL, "num_steps": 10})
    long = dataclasses.replace(cfg, num_steps=20)
    ck, jck = str(tmp_path / "port"), str(tmp_path / "jax")
    tt.train(feats, genres, cfg, checkpoint_dir=ck, checkpoint_every=5,
             device="cpu")
    resumed = tt.train(feats, genres, long, checkpoint_dir=ck,
                       checkpoint_every=5, device="cpu")
    from spotify_recommender_tpu_torch.train.checkpoint import CheckpointManager

    assert CheckpointManager(ck).all_steps() == [9, 14, 19]
    jtt.train(feats, genres, jconfig(cfg), checkpoint_dir=jck,
              checkpoint_every=5)
    jresumed = jtt.train(feats, genres, jconfig(long), checkpoint_dir=jck,
                         checkpoint_every=5)
    assert len(resumed.losses) == len(jresumed.losses) == 1     # step 19
    np.testing.assert_allclose(resumed.losses, jresumed.losses, rtol=0,
                               atol=LOSS_ATOL)
    straight = tt.train(feats, genres, long, device="cpu")
    assert abs(straight.losses[-1] - resumed.losses[-1]) > 10 * LOSS_ATOL
    # a resume past num_steps trains nothing
    assert np.isnan(tt.train(feats, genres, cfg, checkpoint_dir=ck,
                             device="cpu").losses).all()


def test_same_genre_pairs_bitwise_jax(clustered_data):
    feats, genres = clustered_data
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        ours = tt.same_genre_pairs(feats, genres, 64, a)
        theirs = jtt.same_genre_pairs(feats, genres, 64, b)
        for x, y in zip(ours, theirs):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_colisten_pair_fn_bitwise_jax(noise):
    inter, _, _ = jmf.synthetic_interactions(num_users=200, num_items=100,
                                             seed=4)
    feats = np.random.default_rng(4).random((100, 12)).astype(np.float32)
    ours = tt.colisten_pair_fn(inter, feats, np.random.default_rng(9), noise)
    theirs = jtt.colisten_pair_fn(inter, feats, np.random.default_rng(9), noise)
    for _ in range(3):
        for x, y in zip(ours(32), theirs(32)):
            np.testing.assert_array_equal(x, y)
    empty = mf.Interactions.from_coo(np.arange(5), np.arange(5), np.ones(5))
    with pytest.raises(ValueError, match=">= 2 interactions"):
        tt.colisten_pair_fn(empty, feats, np.random.default_rng(0))


def test_evaluate_colisten_equals_jax_from_equal_weights():
    inter, _, _ = jmf.synthetic_interactions(num_users=300, num_items=200,
                                             seed=2)
    feats = np.random.default_rng(2).random((200, 12)).astype(np.float32)
    cfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,),
                         normalize_items=False)
    tree = jax_init(cfg)
    ours = tt.evaluate_colisten(tt.params_from_jax(tree), cfg, feats, inter,
                                k=10, seed=1, device="cpu")
    theirs = jtt.evaluate_colisten(tree, jconfig(cfg), feats, inter, k=10,
                                   seed=1)
    assert ours["num_eval_users"] == theirs["num_eval_users"] > 100
    assert ours["recall@k"] == pytest.approx(theirs["recall@k"], abs=1e-12)
    assert ours["ndcg@k"] == pytest.approx(theirs["ndcg@k"], abs=1e-9)


# --------------------------------------------------------------------------
# The benchmark's quality row
# --------------------------------------------------------------------------


JAX_ROW = {"two_tower_recall_at_10": 0.1478, "two_tower_ndcg_at_10": 0.0764}


def test_quality_row_with_jax_init_reads_the_jax_value(carried_init):
    row = benchmark.run_quality_row(device="cpu")
    assert abs(row["two_tower_recall_at_10"]
               - JAX_ROW["two_tower_recall_at_10"]) <= 0.005
    assert abs(row["two_tower_ndcg_at_10"]
               - JAX_ROW["two_tower_ndcg_at_10"]) <= 0.002


def test_quality_row_with_its_own_init_lands_in_the_seed_spread():
    row = benchmark.run_quality_row(device="cpu")
    assert 0.12 <= row["two_tower_recall_at_10"] <= 0.16
    assert 0.065 <= row["two_tower_ndcg_at_10"] <= 0.085


# --------------------------------------------------------------------------
# Devices
# --------------------------------------------------------------------------


ENTRY_POINTS = ["train", "embed_catalog", "embed_queries", "embed_user_profile",
                "evaluate_colisten", "train_from_cli", "make_model"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_run_on_the_card_by_default(name):
    fn = getattr(tt, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cfg = TwoTowerConfig(embedding_dim=8, hidden_dims=(16,), num_steps=1,
                         batch_size=4)
    sd = tt.params_from_jax(jax_init(cfg))
    feats = np.ones((8, 12), np.float32)
    inter = mf.Interactions.from_coo(np.repeat(np.arange(4), 3),
                                     np.arange(12) % 8, np.ones(12))
    calls = {
        "train": lambda: tt.train(feats, np.zeros(8, np.int32), cfg),
        "embed_catalog": lambda: tt.embed_catalog(sd, feats, cfg),
        "embed_queries": lambda: tt.embed_queries(sd, feats, cfg),
        "embed_user_profile": lambda: tt.embed_user_profile(sd, feats, cfg),
        "evaluate_colisten": lambda: tt.evaluate_colisten(sd, cfg, feats, inter),
        "make_model": lambda: tt.make_model(sd, cfg),
    }
    if name in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[name]()


def test_a_mesh_raises(clustered_data):
    """A data-parallel step's batch must divide the data axis (JAX's
    shard_map refuses it too): 64 pairs over 3 cells."""
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh

    feats, genres = clustered_data
    with pytest.raises(ValueError, match="must divide the 'data' axis"):
        tt.train(feats, genres, TwoTowerConfig(**SMALL),
                 mesh=make_mesh(MeshConfig(data=3), devices=["cpu"] * 3))


# --------------------------------------------------------------------------
# Data parallelism (JAX `make_train_step(axis_name="data")`)
# --------------------------------------------------------------------------


def _cpu_mesh(data):
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh

    return make_mesh(MeshConfig(data=data), devices=["cpu"] * data)


def test_dp_train_losses_equal_jax_dp_from_its_init(carried_init,
                                                    clustered_data):
    """`train` over data=8 (8 x 8 pairs) against the JAX package's over
    its 8-device mesh, both from JAX's init: the recorded losses of the
    150 steps within 1.2e-6 (measured 9.5e-7)."""
    from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
    from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh

    feats, genres = clustered_data
    cfg = TwoTowerConfig(**SMALL)
    ours = tt.train(feats, genres, cfg, mesh=_cpu_mesh(8))
    theirs = jtt.train(feats, genres, jconfig(cfg),
                       mesh=jmake_mesh(JMeshConfig(data=8, catalog=1)))
    assert len(ours.losses) == len(theirs.losses) == 4
    np.testing.assert_allclose(ours.losses, theirs.losses, rtol=0, atol=1.2e-6)
    assert ours.losses[-1] < ours.losses[0]


@pytest.mark.parametrize("data", [2, 8])
def test_dp_step_is_the_single_device_step(clustered_data, data):
    """The global batch's mean loss, its gradient and the Adam step: the
    same pairs through data cells or one device, parameters within 1e-6
    after 3 steps (JAX's own data=8 run: 3.0e-8)."""
    feats, genres = clustered_data
    cfg = TwoTowerConfig(**{**SMALL, "num_steps": 3})
    st1, st8 = {}, {}
    one = tt.train(feats, genres, cfg, device="cpu", stats=st1)
    dp = tt.train(feats, genres, cfg, mesh=_cpu_mesh(data), stats=st8)
    for name, p in one.params.items():
        np.testing.assert_allclose(dp.params[name].numpy(), p.numpy(),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(st8["loss"], st1["loss"], rtol=0, atol=1e-6)
    assert len(st8["step_ms"]) == len(st8["pairs_ms"]) == 3


def test_info_nce_loss_with_an_offset_is_jax_axis_loss():
    """One slice's loss against the gathered items (labels offset by the
    slice's first row) equals JAX's `info_nce_loss` under shard_map, within
    1e-6 relative (losses of ~10-15: one fp32 rounding)."""
    from jax.sharding import PartitionSpec as P

    from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
    from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh

    rng = np.random.default_rng(0)
    # unit rows, as the towers give them
    q, i = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (
        rng.standard_normal((32, 8)).astype(np.float32),
        rng.standard_normal((32, 8)).astype(np.float32)))

    def per_slice(qs, is_):
        return jtt.info_nce_loss(qs, is_, 0.05, axis_name="data")[None]

    fn = jax.jit(jax.shard_map(
        per_slice, mesh=jmake_mesh(JMeshConfig(data=8, catalog=1)),
        in_specs=(P("data", None), P("data", None)), out_specs=P("data"),
        check_vma=False))
    theirs = np.asarray(fn(jnp.asarray(q), jnp.asarray(i)))
    ours = [tt.info_nce_loss(torch.from_numpy(q[4 * d:4 * d + 4]),
                             torch.from_numpy(i), 0.05, offset=4 * d).item()
            for d in range(8)]
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


def test_dryrun_train_step_over_eight_cells():
    """JAX `dryrun_train_step`: every cell of the mesh on one data axis."""
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh

    for m in (_cpu_mesh(1), make_mesh(MeshConfig(data=2, catalog=4),
                                      devices=["cpu"] * 8)):
        tt.dryrun_train_step(m)
