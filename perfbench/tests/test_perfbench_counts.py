"""The yardstick's arithmetic: operations and bytes from the shapes, the
least time, step_mfu and scan_roofline, the trace's reduction."""

from __future__ import annotations

import types

import pytest
import torch

from perfbench.harness import bench, trace
from perfbench.harness.window import Window
from perfbench.metrics import (_roofline, device_idle, escalations_per_batch,
                               fallbacks_per_batch, scan_roofline, step_mfu)


def test_counts_from_shapes():
    assert _roofline.batch_ops(1024, 1_000_000, 12) == 2 * 1024 * 1e6 * 12
    assert _roofline.batch_bytes(1024, 1_000_000, 12, 10) == (
        4 * 1e6 * 12 + 4 * 1024 * 12 + 8 * 1024 * 10)
    # B = 1024, F = 12: operations bound (24.85 us against 14.34 us)
    assert _roofline.bound_by(1024, 1_000_000, 12, 10) == "operations"
    assert _roofline.min_batch_s(1024, 1_000_000, 12, 10) == pytest.approx(
        2 * 1024 * 1e6 * 12 / 989e12)
    # B = 512, k = 1000: bytes bound
    assert _roofline.bound_by(512, 1_000_000, 12, 1000) == "bytes"
    assert _roofline.min_batch_s(512, 1_000_000, 12, 1000) == pytest.approx(
        (4 * 1e6 * 12 + 4 * 512 * 12 + 8 * 512 * 1000) / 3.35e12)
    assert _roofline.share_pct(1.0, 0.0) is None


def _ctx(batches=100, seconds=0.65, tr=None, snaps=None):
    w = Window(batches, batches * 1024, 0, seconds, [], [])
    return bench.Context(1024, 10, 1_000_000, 12, w, tr, snaps or {})


def _trace(batches=10, kernels=None, busy=0.03, window=0.065):
    return trace.Trace(batches, window, busy, kernels or {}, {})


def test_step_mfu_and_scan_roofline():
    bound = 2 * 1024 * 1e6 * 12 / 989e12
    assert step_mfu.read(_ctx()) == pytest.approx(100 * bound / 0.0065)
    tr = _trace(kernels={
        "bin_scan::scan_kernel<128, 2, (bin_scan::Epi)0, bin_scan::Bf16x2>":
            0.025,
        "bin_scan::merge_kernel<128, 2>": 0.006,
        "at::native::elementwise_kernel<128, 4>": 0.5,
    })
    assert scan_roofline.read(_ctx(tr=tr)) == pytest.approx(
        100 * bound / 0.0031)
    # nothing to read: no metric, never a 0 share
    assert scan_roofline.read(_ctx(tr=_trace(kernels={"other": 1.0}))) is None
    assert scan_roofline.read(_ctx()) is None
    assert step_mfu.read(_ctx(batches=0)) is None


def test_device_idle_and_counters():
    assert device_idle.read(_ctx(tr=_trace())) == pytest.approx(
        100 * (1 - 0.03 / 0.065))
    assert device_idle.read(_ctx()) is None
    system = types.SimpleNamespace(
        certified=types.SimpleNamespace(fallbacks=7, escalations=40))
    assert fallbacks_per_batch.snapshot(system) == 7
    assert escalations_per_batch.snapshot(system) == 40
    ctx = _ctx(snaps={"fallbacks_per_batch": (7, 57),
                      "escalations_per_batch": (40, 340)})
    assert fallbacks_per_batch.read(ctx) == 0.5
    assert escalations_per_batch.read(ctx) == 3.0
    assert fallbacks_per_batch.snapshot(types.SimpleNamespace()) is None
    assert fallbacks_per_batch.read(_ctx()) is None


def _evt(name, start, end, dev=False, thread=1):
    return trace.Event(name, start, end, dev, thread)


def test_trace_reduce_busy_idle_and_gap_names():
    events = [
        _evt("bench.window", 100, 1100),
        _evt("bench.batch", 100, 600),
        _evt("aten::copy_", 110, 150),
        _evt("aten::index", 400, 590),
        _evt("cudaMemcpyAsync", 410, 580),
        _evt("bench.batch", 600, 1100),
        _evt("aten::nonzero", 990, 1050),
        _evt("void bin_scan::scan_kernel<128, 2>(float const*, int)",
             150, 400, True),
        _evt("void bin_scan::scan_kernel<128, 2>(float const*, int)",
             380, 420, True),                      # overlaps the first
        _evt("kernel_b(int)", 650, 1000, True),
        _evt("kernel_c(int)", 0, 50, True),        # before the window
        _evt("aten::mm", 10, 20),                  # host, before it
        _evt("aten::add", 420, 430, thread=2),     # another thread
    ]
    t = trace.reduce(events, batches=2)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((420 - 150 + 1000 - 650) * 1e-6)
    assert t.kernel_seconds == pytest.approx({
        "bin_scan::scan_kernel<128, 2>": 290e-6, "kernel_b": 350e-6})
    # gaps [100, 150], [420, 650], [1000, 1100], named at their starts
    assert t.idle_gaps == pytest.approx({
        "bench.batch > (python between ops)": 50e-6,
        "bench.batch > aten::index > cudaMemcpyAsync": 230e-6,
        "bench.batch > aten::nonzero": 100e-6,
    })
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                          ["c", 2.0]]


def test_events_of_a_cpu_session():
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.zeros(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            with record_function(trace.BATCH_SPAN):
                x.add_(1)
    ev = trace.events_of(prof)
    assert any(e.name == "aten::add_" and not e.device for e in ev)
    t = trace.reduce(ev, 1)
    assert t.busy_s == 0.0 and t.window_s > 0


def test_short_name():
    assert trace.short_name(
        "void bin_scan::scan_kernel<128, 2, (bin_scan::Epi)0>(float const*)"
    ) == "bin_scan::scan_kernel<128, 2, (bin_scan::Epi)0>"
    assert (trace.short_name("Memcpy DtoH (Device -> Pageable)")
            == "Memcpy DtoH (Device -> Pageable)")
