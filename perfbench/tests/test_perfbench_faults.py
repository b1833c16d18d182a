"""A run with the timed path broken underneath it comes out not correct:
an answer altered where it is produced, half of the batch left out, and
each control put in the program's place: the TF32 reference, and the
program's own approx tier (bf16x2 scores, no certificate).  Each drives a
whole run on the CPU (the harness's look for a card skipped) at a size a
test run holds; a sound run of the same cell comes out correct."""

from __future__ import annotations

import argparse
import time

import numpy as np
import pytest
import torch

from perfbench.harness import bench, spec
from perfbench.reference import cosine_topk
from perfbench.systems import retriever_approx
from perfbench.traffic import closed_batches

CELLS = ["tiny12.b64-k5", "tinytt.b64-k5", "tiny12.b64-k300"]


def _run(root, cell, wrapper=None, seed=11):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.3, trace=0)
    return bench.run(args, time.perf_counter(), torch.device("cpu"),
                     root=root, call_wrapper=wrapper)


def altered_row(call):
    def f(q, ex):
        s, r = call(q, ex)
        r = r.copy()
        r[0, 0] = (r[0, 0] + 1234) % 4096         # another row, same score
        return s, r
    return f


def altered_score(call):
    def f(q, ex):
        s, r = call(q, ex)
        s = s.copy()
        s[-1, 0] += 1e-4
        return s, r
    return f


def half_dropped(call):
    def f(q, ex):
        s, r = call(q, ex)
        h = q.shape[0] // 2
        return s[:h], r[:h]
    return f


def half_repeated(call):
    def f(q, ex):
        s, r = call(q, ex)
        h = q.shape[0] // 2
        return np.concatenate([s[:h], s[:h]]), np.concatenate([r[:h], r[:h]])
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    assert _run(tiny_root, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [altered_row, altered_score, half_dropped,
                                   half_repeated])
def test_fault_is_not_correct(tiny_root, cell, fault):
    r = _run(tiny_root, cell, fault)
    assert r["correct"] is False
    assert r["failed"] == 0


@pytest.fixture
def made(monkeypatch):
    """What the set-up made: the catalog and the mix's k, which a control
    in the program's place answers from, as the program does."""
    out = {}
    real = closed_batches.make_pool

    def spy(features, traffic, gen):
        out["cat"], out["k"] = features, traffic["k"]
        return real(features, traffic, gen)

    monkeypatch.setattr(closed_batches, "make_pool", spy)
    return out


def tf32_reference(made, conf):
    def f(q, ex):
        s, r = cosine_topk.control_topk(made["cat"], torch.from_numpy(q),
                                        torch.from_numpy(ex), made["k"])
        return s.numpy(), r.numpy()
    return f


def approx_tier(made, conf):
    state = {}

    def f(q, ex):
        if "system" not in state:
            state["system"] = retriever_approx.build(
                conf, made["cat"].numpy(), torch.device("cpu"), made["k"])
            assert state["system"].backend == "approx"
        return retriever_approx.call(state["system"], q, ex, made["k"])
    return f


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", [tf32_reference, approx_tier])
def test_control_is_not_correct(tiny_root, cell, control, made):
    conf = spec.load_cell(cell, tiny_root).config
    r = _run(tiny_root, cell, lambda call: control(made, conf))
    assert r["correct"] is False
    assert r["check"]["bad_rows"]["value"] == 0


def test_a_raising_batch_is_counted_and_not_correct(tiny_root):
    def raising(call):
        state = {"n": 0}

        def f(q, ex):
            state["n"] += 1
            if state["n"] > 3:               # after the pool's warm-up
                raise RuntimeError("a planted fault")
            return call(q, ex)
        return f

    r = _run(tiny_root, "tiny12.b64-k5", raising)
    assert r["correct"] is False
    assert r["failed"] == r["attempted"] > 0
