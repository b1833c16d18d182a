"""Which earlier work leaves `core/profiling.trace` without CUDA events.

    python3 tools/trace_bisect.py [--parallel] [case[*repeats] ...]
                                                         (one CUDA card)

Each case runs in a fresh child process: it builds a small certified
retriever on the card, runs the case's steps in order, then traces one
certified batch and counts the device events in the trace file (all
kernels, kernel 1's `scan_kernel`, kernel 2's `query_prologue_kernel`).
The trace is `profiling.trace`, or for the `raw_*` cases torch.profiler
with CUDA activity and a Chrome-trace handler as the port's trace was
before its warm-up step.  Beside the counts, `lag_us` gives the
least and the median of (kernel start - its launch's start) over the
recorded kernels that carry a correlation id: a healthy trace has them
positive; a negative one means the device's converted timestamps run
behind the host's clock (seen in sessions after a process's first, with
the lost kernels; sleeping in the session did not bring them back).
With --parallel the cases run at once.
One JSON line per case and repeat; the exit code is 0 when every case
ran, whatever it recorded.

Steps:
    session      a bare torch.profiler session with CUDA activity around
                 three batches
    port_session the same through `profiling.trace`
    experiments  the experiment kernel library loaded too (more modules
                 in the process)
    coalescer    a BatchCoalescer serving 8 queries from 8 threads, left
                 open (its dispatcher thread stays alive)
    closed       the same, closed afterwards
    thread       a batch in a thread that is joined
    backward     forward and backward of a small linear layer
    child        a child process that runs a CUDA op
    nan_guard    core/debug.nan_guard around a few ops
    op           one small torch op on the card
    sleep        three seconds without CUDA work
    trace        a `profiling.trace` of a batch, not counted
    teardown0    TEARDOWN_CUPTI=0 in the environment (kineto keeps CUPTI
                 initialized between sessions)
    warm_inside  the counted trace first runs one small torch op and a
                 synchronize inside the profiler, then the batch
    age          150 seconds without CUDA work
    warm_kernels the counted trace first launches 64 small torch ops, then
                 synchronizes, then the batch
    warm_timed   the counted trace first runs small torch ops, each
                 synchronized, for 50 ms, then the batch
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

CASES = {
    "alone": [],
    "session": ["session"],
    "session_x2": ["session", "session"],
    "coalescer": ["coalescer"],
    "session_coalescer": ["session", "coalescer"],
    "session_closed": ["session", "closed"],
    "session_thread": ["session", "thread"],
    "session_backward": ["session", "backward"],
    "backward_session": ["backward", "session"],
    "session_child": ["session", "child"],
    "session_nan_guard": ["session", "nan_guard"],
    "all": ["session", "coalescer", "backward", "child", "thread",
            "nan_guard", "session"],
    "teardown0_session_coalescer": ["teardown0", "session", "coalescer"],
    "teardown0_all": ["teardown0", "session", "coalescer", "backward",
                      "child", "thread", "nan_guard", "session"],
    "session_again": ["session"],
    "session_x3": ["session", "session", "session"],
    "teardown0_session": ["teardown0", "session"],
    "session_op": ["session", "op"],
    "session_sleep": ["session", "sleep"],
    "session_trace": ["session", "trace"],
    "session_warm_inside": ["session", "warm_inside"],
    "session_x3_warm_inside": ["session", "session", "session", "warm_inside"],
    "raw_after_session": ["session"],
    "raw_after_session_big": ["experiments", "session"],
    "after_port_session": ["port_session"],
    "after_port_session_big": ["experiments", "port_session"],
    "aged_first": ["age"],
    "aged_after_port_session": ["port_session", "age"],
    "raw_aged_after_session": ["session", "age"],
    "aged_after_session": ["session", "age"],
    "aged_warm_inside": ["port_session", "age", "warm_inside"],
    "aged_warm_kernels": ["port_session", "age", "warm_kernels"],
    "aged_warm_timed": ["port_session", "age", "warm_timed"],
}


def _raw_trace(tdir: str):
    """torch.profiler with CUDA activity and a Chrome-trace handler, as the
    port's trace was before its warm-up step."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   on_trace_ready=tensorboard_trace_handler(tdir))


def run_case(name: str, steps: list) -> dict:
    import numpy as np
    import torch

    from spotify_recommender_tpu_torch.core import debug, profiling
    from spotify_recommender_tpu_torch.ops.fused_topk import CertifiedRetriever
    from spotify_recommender_tpu_torch.serve.server import BatchCoalescer

    dev = torch.device("cuda:0")
    feats = np.random.default_rng(0).random((20011, 12), dtype=np.float32)
    cr = CertifiedRetriever(feats, None, None, dev)
    q = torch.from_numpy(feats[:64]).to(dev)
    excl = torch.arange(64, device=dev)
    cr(q, 10, excl)
    torch.cuda.synchronize()
    warm = None
    for step in steps:
        if step == "teardown0":
            os.environ["TEARDOWN_CUPTI"] = "0"
        elif step == "session":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    cr(q, 10, excl)
                torch.cuda.synchronize()
            prof.key_averages()
        elif step == "port_session":
            with tempfile.TemporaryDirectory() as tdir:
                with profiling.trace(tdir) as prof:
                    for _ in range(3):
                        cr(q, 10, excl)
            prof.key_averages()
        elif step == "experiments":
            from spotify_recommender_tpu_torch.ops.cuda import _build

            _build.library(_build.EXPERIMENTS)
        elif step in ("coalescer", "closed"):
            co = BatchCoalescer(
                lambda qq, k, ex: tuple(t.cpu().numpy() for t in cr(qq, k, ex)))
            ts = [threading.Thread(target=co.submit,
                                   args=(feats[i], i, 10)) for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            if step == "closed":
                co.close()
        elif step == "thread":
            t = threading.Thread(target=lambda: cr(q, 10, excl))
            t.start()
            t.join(timeout=60)
        elif step == "backward":
            lin = torch.nn.Linear(64, 64).to(dev)
            lin(torch.ones(32, 64, device=dev)).square().sum().backward()
        elif step == "child":
            subprocess.run([sys.executable, "-c",
                            "import torch; torch.ones(4, device='cuda').sum()"
                            ".item()"], check=True, timeout=120)
        elif step == "nan_guard":
            with debug.nan_guard():
                (torch.ones(4, device=dev) * 2).sum()
        elif step == "op":
            torch.ones(4, device=dev).add_(1)
        elif step == "sleep":
            time.sleep(3)
        elif step == "age":
            time.sleep(150)
        elif step == "trace":
            with tempfile.TemporaryDirectory() as tdir:
                with profiling.trace(tdir):
                    cr(q, 10, excl)
        elif step.startswith("warm_"):
            warm = step
        else:
            raise ValueError(f"unknown step {step}")
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tdir:
        with (_raw_trace(tdir) if name.startswith("raw_")
              else profiling.trace(tdir)):
            x = torch.ones(4, device=dev)
            if warm == "warm_inside":
                x.add_(1)
                torch.cuda.synchronize()
            elif warm == "warm_kernels":
                for _ in range(64):
                    x.add_(1)
                torch.cuda.synchronize()
            elif warm == "warm_timed":
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 0.05:
                    x.add_(1)
                    torch.cuda.synchronize()
            with profiling.annotate("certified_batch"):
                cr(q, 10, excl)
            torch.cuda.synchronize()
        [path] = Path(tdir).glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in sorted(
        (e for e in events if e.get("cat") == "kernel"),
        key=lambda e: e.get("ts", 0))]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    lags = sorted(e["ts"] - launch[e["args"]["correlation"]] for e in events
                  if e.get("cat") == "kernel"
                  and e.get("args", {}).get("correlation") in launch)
    return {
        "lag_us": [lags[0], lags[len(lags) // 2]] if lags else None,
        "first_kernels": [k.split("(")[0][-40:] for k in kernels[:4]],
        "spans": sum(e.get("name") == "certified_batch" for e in events),
        "kernel_events": len(kernels),
        "scan_kernel": sum("scan_kernel" in k for k in kernels),
        "query_prologue_kernel": sum("query_prologue_kernel" in k
                                     for k in kernels),
    }


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--case":
        print(json.dumps(run_case(sys.argv[2], CASES[sys.argv[2]])))
        return 0
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p)}
    args = sys.argv[1:]
    parallel = "--parallel" in args
    runs = [(name, rep) for arg in [a for a in args if a != "--parallel"]
            or CASES for name, _, reps in [arg.partition("*")]
            for rep in range(int(reps or 1))]
    def report(name, rep, proc):
        stdout, stderr = proc.communicate(timeout=900)
        lines = stdout.strip().splitlines()
        res = (json.loads(lines[-1]) if proc.returncode == 0 and lines
               else {"rc": proc.returncode, "stderr": stderr[-800:]})
        print(json.dumps({"case": name, "repeat": rep,
                          "steps": CASES[name], **res}), flush=True)

    procs = []
    for name, rep in runs:
        proc = subprocess.Popen([sys.executable, __file__, "--case", name],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=env)
        if parallel:
            procs.append((name, rep, proc))
        else:
            report(name, rep, proc)
    for name, rep, proc in procs:
        report(name, rep, proc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
