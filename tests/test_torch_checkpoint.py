"""The port's checkpoints (`train/checkpoint.py`, torch.save) and MF resume,
on the CPU: the counterpart of tests/test_checkpoint.py.  Resumed ALS and
SGD runs must equal uninterrupted ones (and, for ALS, the JAX package's
uninterrupted run)."""

import os

import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import MFConfig as JMFConfig
from spotify_recommender_tpu.models import mf as jmf
from spotify_recommender_tpu_torch.core.config import MFConfig
from spotify_recommender_tpu_torch.models import mf
from spotify_recommender_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)


@pytest.fixture
def state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
        "step": torch.tensor(7),
        "note": [1, 2.5, None, "x"],
    }


def assert_state_equal(out, ref):
    assert torch.equal(out["params"]["w"], ref["params"]["w"])
    assert torch.equal(out["params"]["b"], ref["params"]["b"])
    assert int(out["step"]) == 7 and out["note"] == ref["note"]


class TestCheckpointManager:
    def test_save_restore_round_trip(self, tmp_path, state):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        assert mgr.save(0, state)
        mgr.wait()
        assert_state_equal(mgr.restore(0, template=state), state)
        mgr.close()

    @pytest.mark.parametrize("max_to_keep", [1, 2, 3])
    def test_latest_step_and_retention(self, tmp_path, state, max_to_keep):
        mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=max_to_keep)
        for s in (1, 2, 3, 10):
            state["step"] = torch.tensor(s)
            mgr.save(s, state, force=True)
        assert mgr.latest_step() == 10
        assert mgr.all_steps() == [1, 2, 3, 10][-max_to_keep:]
        assert int(mgr.restore()["step"]) == 10       # resume-from-latest
        assert sorted(os.listdir(mgr.directory)) == sorted(
            f"step_{s}.pt" for s in mgr.all_steps())   # no temporary files

    def test_default_keeps_three(self, tmp_path, state):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        for s in range(5):
            mgr.save(s, state)
        assert mgr.all_steps() == [2, 3, 4]

    def test_restore_empty_returns_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "empty"))
        assert mgr.latest_step() is None
        assert mgr.restore() is None
        mgr.close()

    def test_other_files_are_ignored(self, tmp_path, state):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        for name in ("step_9.pt.tmp", "notes.txt", "step_x.pt"):
            (tmp_path / "ckpt" / name).write_text("")
        mgr.save(4, state)
        assert mgr.all_steps() == [4]

    def test_restore_places_tensors_on_the_device(self, tmp_path, state):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(0, state)
        out = mgr.restore(device="cpu")
        assert out["params"]["w"].device.type == "cpu"

    def test_template_keys_must_match(self, tmp_path, state):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(0, state)
        with pytest.raises(KeyError, match="do not match"):
            mgr.restore(0, template={"params": state["params"]})


class TestOneShot:
    def test_save_restore(self, tmp_path, state):
        p = str(tmp_path / "one.pt")
        save_checkpoint(p, state)
        assert_state_equal(restore_checkpoint(p, template=state), state)
        assert os.listdir(tmp_path) == ["one.pt"]


def test_mf_config_defaults_equal_jax():
    assert vars(MFConfig()) == vars(JMFConfig())


class TestMFResume:
    """ALS / SGD-MF checkpoint + resume: an interrupted-then-resumed run
    must produce the same factors as an uninterrupted one."""

    @pytest.mark.parametrize("subspace", [0, 4])
    def test_als_resume_matches_uninterrupted(self, tmp_path, subspace):
        inter, _, _ = mf.synthetic_interactions(
            num_users=120, num_items=60, latent_dim=4, density=0.06, seed=3
        )
        cfg6 = MFConfig(embedding_dim=8, num_iterations=6, reg=0.1, alpha=5.0)
        u_ref, i_ref = mf.train_als(inter, cfg6, subspace=subspace, device="cpu")
        ck = str(tmp_path / "als")
        cfg3 = MFConfig(embedding_dim=8, num_iterations=3, reg=0.1, alpha=5.0)
        mf.train_als(inter, cfg3, checkpoint_dir=ck, subspace=subspace,
                     device="cpu")
        assert CheckpointManager(ck).all_steps() == [0, 1, 2]
        # resumed: picks up at iteration 3, finishes 6
        u_res, i_res = mf.train_als(inter, cfg6, checkpoint_dir=ck,
                                    subspace=subspace, device="cpu")
        np.testing.assert_allclose(u_res, u_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(i_res, i_ref, rtol=1e-4, atol=1e-6)
        if subspace == 0:   # and the JAX package's uninterrupted run
            ju, ji = jmf.train_als(inter, JMFConfig(**vars(cfg6)))
            np.testing.assert_allclose(u_res, np.asarray(ju), rtol=0, atol=5e-5)
            np.testing.assert_allclose(i_res, np.asarray(ji), rtol=0, atol=5e-5)

    def test_als_checkpoint_every(self, tmp_path):
        inter, _, _ = mf.synthetic_interactions(80, 40, 4, density=0.08, seed=1)
        ck = str(tmp_path / "als")
        mf.train_als(inter, MFConfig(embedding_dim=4, num_iterations=5),
                     checkpoint_dir=ck, checkpoint_every=2, device="cpu")
        assert CheckpointManager(ck).all_steps() == [1, 3, 4]
        state = CheckpointManager(ck).restore()
        assert state["users"].shape == (80, 4) and state["items"].shape == (40, 4)

    def test_sgd_resume_matches_uninterrupted(self, tmp_path):
        inter, _, _ = mf.synthetic_interactions(
            num_users=120, num_items=60, latent_dim=4, density=0.06, seed=4
        )
        cfg = MFConfig(embedding_dim=8, reg=0.01, alpha=2.0,
                       learning_rate=0.05, batch_size=256, seed=0)
        u_ref, i_ref = mf.train_sgd(inter, cfg, num_steps=40, device="cpu")
        ck = str(tmp_path / "sgd")
        mf.train_sgd(inter, cfg, num_steps=20, checkpoint_dir=ck,
                     checkpoint_every=10, device="cpu")
        assert CheckpointManager(ck).all_steps() == [9, 19]
        losses = []
        u_res, i_res = mf.train_sgd(inter, cfg, num_steps=40, checkpoint_dir=ck,
                                    checkpoint_every=10, device="cpu",
                                    losses=losses)
        assert len(losses) == 20                  # steps 20-39 only
        np.testing.assert_allclose(u_res, u_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(i_res, i_ref, rtol=1e-4, atol=1e-6)

    def test_sgd_checkpoint_holds_the_optimizer_state(self, tmp_path):
        inter, _, _ = mf.synthetic_interactions(60, 30, 4, density=0.1, seed=0)
        ck = str(tmp_path / "sgd")
        mf.train_sgd(inter, MFConfig(embedding_dim=4, batch_size=64),
                     num_steps=5, checkpoint_dir=ck, device="cpu")
        state = CheckpointManager(ck).restore()
        assert set(state) == {"params", "opt_state"}
        adam = state["opt_state"]["state"]
        assert {int(adam[p]["step"]) for p in adam} == {5}
        assert state["params"]["users"].requires_grad is False
