"""The readers of the program's spans, `certified_host_ms` and
`card_wait_ms`: their arithmetic on the recorder's totals, a value on the
tiny CPU cells (the scan's path and k > depth x W), and nothing to read
from a system that cannot record spans, as a port without
`Retriever.record_spans` cannot."""

from __future__ import annotations

import argparse
import time
import types

import pytest
import torch

from perfbench.harness import bench
from perfbench.harness.window import Window
from perfbench.metrics import _roofline, card_wait_ms, certified_host_ms

READERS = (certified_host_ms, card_wait_ms)


def _totals(**seconds):
    """Totals as the recorder gives them: cert_start is "cert.start",
    entry_to_host "entry.to_host"."""
    return {n.replace("_", ".", 1): {"count": 1, "s": s, "self_s": s}
            for n, s in seconds.items()}


def _ctx(before, after, batches=4):
    w = Window(batches, batches * 1024, 0, 0.1, [], [])
    snaps = {"certified_host_ms": (before, after),
             "card_wait_ms": (before, after)}
    return bench.Context(1024, 10, 1_000_000, 12, w, None, snaps)


def test_the_readers_difference_over_the_window():
    before = _totals(cert_start=1.0, cert_finish=0.5, cert_sync=0.25,
                     entry_to_host=0.125)
    after = _totals(cert_start=1.004, cert_finish=0.508, cert_sync=0.256,
                    entry_to_host=0.127)
    ctx = _ctx(before, after)
    # (4 + 8 - 6) ms of host work and (6 + 2) ms of waits over 4 batches
    assert certified_host_ms.read(ctx) == pytest.approx(1.5)
    assert card_wait_ms.read(ctx) == pytest.approx(2.0)
    # recording turned on at the first snapshot: nothing before it
    ctx = _ctx({}, _totals(cert_start=0.004, entry_to_host=0.002))
    assert certified_host_ms.read(ctx) == pytest.approx(1.0)
    assert card_wait_ms.read(ctx) == pytest.approx(0.5)


@pytest.mark.parametrize("reader", READERS)
def test_nothing_to_read_is_none(reader):
    assert reader.snapshot(types.SimpleNamespace()) is None
    assert reader.snapshot(types.SimpleNamespace(certified=None)) is None
    assert reader.read(_ctx(None, None)) is None
    assert reader.read(_ctx({}, _totals(cert_start=1.0, cert_sync=1.0),
                            batches=0)) is None
    # spans of no certified batch: another system's
    assert reader.read(_ctx({}, _totals(other=1.0))) is None
    # a traced run whose reader has no snapshots at all
    ctx = bench.Context(1024, 10, 1_000_000, 12,
                        Window(4, 4096, 0, 0.1, [], []), None, {})
    assert reader.read(ctx) is None


def test_snapshot_turns_recording_on():
    calls = []

    class System:
        def record_spans(self):
            calls.append(1)
            return types.SimpleNamespace(totals=lambda: {"x": {"s": 1.0}})

    for reader in READERS:
        assert reader.snapshot(System()) == {"x": {"s": 1.0}}
    assert len(calls) == 2


@pytest.mark.parametrize("cell,k", [("tiny12.b64-k5", 5),
                                    ("tiny12.b64-k300", 300)])
def test_a_value_on_the_tiny_cpu_cell(tiny_root, cell, k):
    args = argparse.Namespace(workload=cell, seed=2**31 + 11, seconds=0.3,
                              trace=1)
    result = bench.run(args, time.perf_counter(), torch.device("cpu"),
                       root=tiny_root)
    assert result["correct"] is True
    m = result["metrics"]
    for name in ("certified_host_ms", "card_wait_ms"):
        assert m[name]["unit"] == "ms" and m[name]["value"] > 0
    # both read parts of the window's batches, so together no more than
    # the mean batch, which `step_mfu` gives over the least batch time
    mean_ms = 1e3 * _roofline.min_batch_s(64, 4096, 12, k) / (
        m["step_mfu"]["value"] / 100)
    spent_ms = m["certified_host_ms"]["value"] + m["card_wait_ms"]["value"]
    assert 0 < spent_ms <= mean_ms * (1 + 1e-6)
