"""End-to-end smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's two CUDA kernel libraries (serving and experiments) and
its native CSV parser at once, from `spotify_recommender_tpu_torch/csrc`
and `native/`, holds each kernel against
its plain torch version on the card, runs the reference-style CLI on a
114,000-row catalog, and drives the main paths at the benchmark's sizes:

- phase 6: `Retriever.retrieve` (certified exact tier), 1,000,000 x 12
  items, B = 1024 catalog-row queries with self-exclusion, k = 10, and
  B = 1: the answers bitwise the fixed-order oracle's and within 1e-6 of
  the cuBLAS oracle, fallbacks and escalations per batch, a
  `torch.profiler` breakdown of a batch; kernel 1 at the batch's depth-2
  scan, the 32-query depth-3 rescan and B = 1;
- phase 7: the fused score + top-k kernel (kernel 3) at those shapes, both
  modes, k = 10 and 100 and B = 1, and on a tie-heavy catalog (each query's
  row copied to both sides of a catalog split or warp edge), bitwise equal
  to its plain version (phase 2 fails if an instance of it spills);
- phase 8: the Retriever's "pallas" backend and an exact `FusedRetriever`;
- phase 9: `StreamingRetriever` over a memory-mapped 4,000,000 x 12
  catalog directory, B = 256, window 1,048,576, and `retrieve --streaming`;
- phase 10: the certified tier under `scan="v2"` (kernel 4, W = 512) at
  the phase-6 cell and B = 1, kernel 4 against its plain version (B =
  1024, 32, 1), and kernel 1 at W = 512 (`scan_bins=512`) against its
  plain version and the oracle;
- phase 11: `FusedRetriever` over bf16 and bf16x2 storage (kernel 3's bf16
  instances) and `PrefilterRetriever`, at the phase-6 cell;
- phase 12: TPU kernels 9-12 (the prototype bin scans) against their plain
  versions at 1024 x 1M, and kernels 10-11 also at the 10M x 1024 layout
  (and B = 1) that `kernel_r3.main` runs them on; then the three
  experiment paths that run them:
  `experiments.kernel_r3.main` at 10M x 1024 (and B = 1),
  `experiments.kernel_ablation_r2e.main` and
  `experiments.certified_proto.main` at 1M x 1024;
- phase 13: TPU kernels 5-8 (kernel 3's round-2 ablation bodies): every
  case of the four launchers against its plain version, outputs and
  per-tile digest (NaN-aware), on its main's inputs (1024 queries, 1M
  rows, the case's tc), then the four mains
  `experiments.kernel_ablation_r2{,b,c,d}.main` at 1M x 1024;
- phase 14: the approx tier (`Retriever` with `dtype="bfloat16"`: kernels
  2 and 1, no rerank) at the phase-6 cell and B = 1: recall@10 against the
  fixed-order oracle >= 0.99, scores of the rows both return within
  BF16X2_EPS, no index >= N, and a batch anti-aligned with the catalog
  (every real cosine < 0) fills every slot with rows < N, recall@10 >=
  0.99; kernel 1 at the tier's shapes against its plain version (the
  "scan_v3_approx" entries);
- phase 15: serving: `benchmark.run_serve_row` at its defaults (1M items,
  32 clients x 10 requests, queue 64, certified tier; its burst's 429s as
  they happen), a fresh service's warmup and a second one, batch times at
  B = 1-32, a 128-request burst against a dispatcher held inside a batch
  (63 shed, the rest answered as direct calls), and a live `make_server`
  on port 0 whose `/recommend`, `/retrieve` (also from 8 threads at once),
  `/metrics` and `/reload` answer as direct calls do;
- phase 16: `benchmark.run_benchmark`: the headline (1M x 12, B = 1024,
  reps 3, B = 1 too), the bf16 (approx) row and the 64-dim row, whose
  answers for 64 queries equal the fixed-order oracle's index for index;
  one batch of the 64-dim tier (the "scan_v3_f64" entry's launches), and
  kernels 1 and 2 at F = 64 against their plain versions;
- phase 17: the matrix-factorization path at BASELINE config 3 (100,000
  users x 20,000 items x 20 plays, d = 64; `experiments.als_scale_1m`'s
  generator): 3 ALS iterations (each half's and the Cholesky's ms, peak
  memory, finite factors), 2 + 1 checkpointed iterations equal to 3
  within 1e-4, two iALS++ sweeps (subspace 16), recall@10 / NDCG@10 of
  10,000 held-out users through `mips_topk_chunked` (1,000 of them equal
  on the CPU up to counted near-ties within 1e-6), 200 SGD steps of 8192
  at the default lr (the loss rises there, as the JAX package's does on
  the same batches; the first 20 steps' losses within 1e-4 of the CPU
  port's) and at lr 0.01 (the loss must fall), the benchmark's MF quality
  row on the card within 0.002 of the CPU's with its data's digests
  (`benchmark.quality_data_digests`), and the item factors through
  `embed-catalog --mf` into the certified tier (1024 user queries, k = 10,
  bitwise the fixed-order oracle; kernels 1 and 2 at F = 64 against their
  plain versions, the "scan_v3_mf" entry);
- phase 18: the two-tower model (BASELINE config 5) at TwoTowerConfig's
  defaults (D 64, hidden (256, 128), batch 1024, 1000 steps) on phase 5's
  catalog: `train` per step (host pair sampling, device step), loss
  falling, peak memory; the CLI's `train-two-tower`, `embed-catalog
  --two-tower` and `recommend`; the item tower over phase 6's rows, a
  1M x 64 learned catalog, served by the certified tier (B = 1024
  query-tower queries and B = 1, bitwise the fixed-order oracle,
  fallbacks and escalations per batch beside the uniform 64-dim
  catalog's; a user profile's query) and the approx tier (recall@10 >=
  0.99, no unfilled slot); kernels 1 and 2 at those shapes against their
  plain versions (the "scan_v3_tt" and "split_bf16x2_tt" entries); the
  towers on the card against the CPU (fp32, bf16), and the quality row's
  two-tower keys from phase 17, card against CPU;
- phase 19: the data layer on a 1,000,000-row Spotify-schema CSV: the
  native parse (native/csv_parser.cpp, built with g++ in phase 2 beside
  nvcc) against the Python parse (equal tables), single-shot `preprocess`
  against `preprocess --streaming --chunk-rows 200000` in child processes
  (seconds and peak RSS, `resource.getrusage(RUSAGE_CHILDREN)`; the
  streamed `dir-v1` catalog bitwise the single-shot one), and `retrieve` /
  `--id` through the CLI over the memory-mapped directory;
- phase 20: the row-sharded catalog at BASELINE config 4's 10,000,000 x
  12 on one card: a 4-shard catalog mesh over the one device, through the
  Retriever (certified per shard: kernels 2 and 1; B = 1024 and B = 1,
  k = 10, exclusions on the shard borders), bitwise the single-card
  certified tier, with fallbacks and escalations summed over shards and a
  `torch.profiler` breakdown; kernel 3 per shard (the Retriever's backend
  for a bf16 dtype) against the same answer; a 2-D data=2 x catalog=2
  mesh; `save_sharded_catalog` / `load_sharded_catalog` / `from_artifact`
  at 10M; `retrieve --catalog <sharded dir> --mesh catalog=1` through the
  CLI; kernels 1, 2 and 3 at a shard's shapes against their plain versions
  (the "*_sharded" entries; kernel 1's plain version in column chunks).

- phase 21: the training half of sharding on a 4-cell mesh over the one
  card, and the last modules: BASELINE config 4's 10,000,000 x 64 fp32
  row-sharded embedding table (lookups of 1024 ids, a (1024, 50)
  padded-ragged block and 65,536 ids bitwise the dense gather, with their
  ms beside the byte bound; an out-of-range id raises; the backward
  bitwise a dense index_add on the owners' rows); ALS at config 3 sharded
  over `catalog=4`, replicated and `shard_tables`, against the single
  device (per-iteration and Cholesky ms, peak memory), its `shard_tables`
  item factors served by 4 certified shards bitwise the single card (the
  "*_mf_sharded" entries); data-parallel SGD (config 3) and two-tower
  (config 5) steps over `data=4` against the single device; the CLI's
  `train-mf --mesh catalog=1 --shard-tables` and `train-two-tower --mesh
  data=1,catalog=1`; `autotune.tune` at 1M x 1024 with its cache in the
  phase's directory (each candidate's batch and kernel 1; the
  "scan_v3_autotune" entry at the winner), the benchmark row reading it,
  the `autotune` subcommand; `profiling.trace` of one certified batch;
  `debug.nan_guard` at an injected NaN; `graft_entry.entry()` bitwise the
  certified tier and `dryrun_multichip(4)` over [cuda:0] x 4.

Kernel 1's entries scan the catalog's real columns (`ncols`, as the
tiers pass it); their bounds count those columns.

Every phase prints one line; any failure raises and exits non-zero.  The
next-to-last line is a JSON object of the kernels (launches on the main
path, error against the plain version, times, the card's bound for the same
work, which every time must reach, and the nearest PyTorch call's time);
the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Needs a CUDA device, nvcc and this repository's `spotify_recommender_tpu_torch`
package; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch sees no CUDA device")

from spotify_recommender_tpu_torch import (  # noqa: E402
    benchmark,
    cli,
    graft_entry,
)
from spotify_recommender_tpu_torch.core.config import (  # noqa: E402
    MeshConfig,
    MFConfig,
    RetrievalConfig,
    TwoTowerConfig,
)
from spotify_recommender_tpu_torch.core import debug, profiling  # noqa: E402
from spotify_recommender_tpu_torch.core.device import (  # noqa: E402
    device_info,
    nvidia_smi,
)
from spotify_recommender_tpu_torch.core.timing import sync_ms  # noqa: E402
from spotify_recommender_tpu_torch.core.mesh import make_mesh  # noqa: E402
from spotify_recommender_tpu_torch.data import (  # noqa: E402
    csv_ingest,
    native_ingest,
)
from spotify_recommender_tpu_torch.data.catalog import Catalog  # noqa: E402
from spotify_recommender_tpu_torch.data.sharded_catalog import (  # noqa: E402
    load_sharded_catalog,
    save_sharded_catalog,
)
from spotify_recommender_tpu_torch.experiments import (  # noqa: E402
    als_scale_1m,
    certified_proto,
    kernel_ablation_r2,
    kernel_ablation_r2b,
    kernel_ablation_r2c,
    kernel_ablation_r2d,
    kernel_ablation_r2e,
    kernel_r3,
)
from spotify_recommender_tpu_torch.models import mf, two_tower  # noqa: E402
from spotify_recommender_tpu_torch.ops import autotune, similarity  # noqa: E402
from spotify_recommender_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    ablation,
    proto_scans,
)
from spotify_recommender_tpu_torch.ops.cuda.fused import (  # noqa: E402
    _splits,
    fused_topk,
    fused_topk_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import (  # noqa: E402
    scan_v2,
    scan_v2_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (  # noqa: E402
    bin_structures,
    merge_bins,
    scan_v3,
    scan_v3_plain,
    split_plane_dots,
    top_slots,
)
from spotify_recommender_tpu_torch.ops.cuda.split import (  # noqa: E402
    split_bf16x2,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.fused_topk import (  # noqa: E402
    BF16X2_EPS,
    CertifiedRetriever,
    FusedRetriever,
    PrefilterRetriever,
    build_certified_layout,
    layout_to_device,
    prepare_and_call,
)
from spotify_recommender_tpu_torch.parallel.embedding import (  # noqa: E402
    ShardedEmbeddingTable,
)
from spotify_recommender_tpu_torch.parallel.sharding import (  # noqa: E402
    ShardedCatalog,
)
from spotify_recommender_tpu_torch.retrieval.retriever import (  # noqa: E402
    Retriever,
)
from spotify_recommender_tpu_torch.retrieval.streaming_retriever import (  # noqa: E402
    StreamingRetriever,
    host_tensor,
)
from spotify_recommender_tpu_torch.serve.server import (  # noqa: E402
    BatchCoalescer,
    ServiceOverloaded,
    make_server,
)

DEV = torch.device("cuda:0")
TOL = 1e-6   # kernel vs plain: values and bounds (same fp32 products)
# against the oracle (cuBLAS product, other summation order): exact-mode
# scores within 1e-6; prenormalized scores round the unit rows and queries
# once more each, so within 1e-5
TOL_EXACT, TOL_FAST = 1e-6, 1e-5
# bf16 storage against the oracle: each unit vector's bf16 rounding moves it
# by <= 2^-8 of its length, so a cosine moves by <= 2 * 2^-8 (Cauchy-Schwarz)
TOL_BF16 = 2 * 2.0**-8 + 1e-6
PALLAS = "spotify_recommender_tpu/ops/pallas/fused_topk.py"
CSRC = "spotify_recommender_tpu_torch/csrc"
# an H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W): the
# bound of a kernel is the larger of its operations over the peak for its
# inputs' type and its bytes (each input read once, each output written
# once) over the memory rate
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
R3_N = 10_000_000          # kernel_r3.main's catalog
PLAIN_CHUNK = 1 << 20      # columns per chunk of a plain version at R3_N


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def wall_ms(fn, reps: int) -> float:
    """Median wall milliseconds of `fn()` ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def split_queries(q: torch.Tensor) -> torch.Tensor:
    """The certified path's query preparation with the plain split:
    [qh, ql, ql, qh] of the unit queries."""
    qn = similarity.row_norms(q)
    qh, ql = split_bf16x2_plain(q / qn.clamp_min(1e-30)[:, None])
    return torch.cat([qh, ql, ql, qh], dim=1)


def compare_scan(q2, ft, depth, topc, w=128, v2=None, ncols=None):
    """Scan kernel vs plain on the same inputs: kernel 1 (over the first
    `ncols` columns, as the tiers pass it), or kernel 4 with `v2` = (qn,
    norms, excl, valid, eps); they must be bitwise equal.  Returns (max
    abs error of values and bounds, bitwise equal?, kernel outputs)."""
    if v2 is None:
        kv, ki, kb = scan_v3(q2, ft, w=w, depth=depth, topc=topc, ncols=ncols)
        pv, pi, pb = scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc,
                                   ncols=ncols)
    else:
        qn, nrm, ex, valid, eps = v2
        kv, ki, kb = scan_v2(q2, qn, ft, nrm, ex, valid, w=w, eps=eps, topc=topc)
        pv, pi, pb = scan_v2_plain(q2, qn, ft, nrm, ex, valid, w=w, eps=eps,
                                   topc=topc)
    torch.cuda.synchronize()
    what = f"scan {'v2' if v2 else 'v3'} w={w} depth {depth} topc={topc}"
    check(torch.equal(torch.isinf(kv), torch.isinf(pv))
          and torch.equal(torch.isinf(kb), torch.isinf(pb)),
          f"{what}: -inf slots differ")
    err = max(finite_diff(kv, pv), finite_diff(kb, pb))
    check(err <= TOL, f"{what}: values/bounds differ by {err}")
    # indices must agree wherever the plain values leave no near-tie
    gaps = (pv[:, :-1] - pv[:, 1:]) > TOL
    ones = torch.ones_like(gaps[:, :1])
    sep = torch.cat([ones, gaps], 1) & torch.cat([gaps, ones], 1)
    sep[:, -1] = False      # the (C+1)-th value is unknown
    check(torch.equal(ki[sep], pi[sep]), f"{what}: indices differ")
    bitwise = torch.equal(kv, pv) and torch.equal(ki, pi) and torch.equal(kb, pb)
    check(bitwise, f"{what} (B={q2.shape[0]}): not bitwise equal to plain")
    return err, bitwise, (kv, ki, kb)


def bound(flops: float, peak: str, *tensors) -> dict:
    """bound_ms and bound_by of work of `flops` operations at the `peak`
    rate that reads and writes `tensors` once each."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def dot_flops(q: torch.Tensor, ft: torch.Tensor, products: int) -> float:
    """Two operations per product, `products` per (query, column)."""
    return 2.0 * q.shape[0] * ft.shape[1] * products


def ptxas_reports(log: str) -> list:
    """(`name<template args>`, registers, spill-store bytes) of each entry
    function in an nvcc log's ptxas report."""
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = _short_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = max(spill, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def _short_name(mangled: str) -> str:
    """The innermost name of a mangled _ZN<len><name>... path, with its
    integer and bool template arguments and bf16 where it takes bf16."""
    parts, i = [], 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    rest = mangled[i:]
    args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0])
    if "bfloat16" in rest.split("EEv")[0]:
        args.append("bf16")
    return f"{parts[-1] if parts else mangled[:40]}<{','.join(args)}>"


def check_bitwise(out, plain, what: str) -> float:
    """A kernel's outputs bitwise equal to its plain version's; returns
    the max abs difference of the finite values (0)."""
    torch.cuda.synchronize()
    for o, p in zip(out, plain):
        check(o.shape == p.shape and torch.equal(o, p),
              f"{what}: kernel differs from plain in "
              f"{(o != p).sum().item()} entries")
    return max(finite_diff(o.float(), p.float()) for o, p in zip(out, plain))


def finite_diff(a, b) -> float:
    """Max |a - b| over the entries where both are finite (0 if none)."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    return (a - b)[fin].abs().max().item() if fin.any() else 0.0


def recall(i, ri) -> float:
    """Share of the oracle's top-k rows that `i` holds, per query row."""
    return (i[:, :, None] == ri[:, None, :]).any(dim=2).float().mean().item()


def compare_oracle(s, i, rs, ri, tol: float, what: str) -> Tuple[float, int]:
    """Scores within `tol` of the oracle's; indices equal at every position
    whose oracle neighbours are more than 2 * tol away (the oracle's
    cuBLAS product sums in another order, so closer values may swap).
    Returns (max score error, positions that differ at near-ties)."""
    check(s.shape == rs.shape and bool(torch.isfinite(s).all()),
          f"{what}: shape {tuple(s.shape)} or non-finite scores")
    err = (s - rs).abs().max().item()
    check(err <= tol, f"{what}: scores differ from the oracle's by {err}")
    gaps = (rs[:, :-1] - rs[:, 1:]) > 2 * tol
    ones = torch.ones_like(gaps[:, :1])
    sep = torch.cat([ones, gaps], 1) & torch.cat([gaps, ones], 1)
    sep[:, -1] = False      # the (k+1)-th oracle value is unknown
    check(torch.equal(i[sep], ri[sep]),
          f"{what}: {(i[sep] != ri[sep]).sum().item()} separated indices differ")
    return err, int((i != ri).sum().item())


def check_certified(s, i, fixed, cublas, what) -> Tuple[float, int]:
    """A certified batch is bitwise the fixed-order oracle's (`fixed`, its
    scores and indices), and within TOL_EXACT of the cuBLAS oracle
    (`cublas`) by `compare_oracle`.  Returns that comparison's (max score
    error, positions that differ at near-ties)."""
    fs, fi = fixed
    check(torch.equal(i, fi), f"{what}: certified indices differ from the "
          f"fixed-order oracle's in {(i != fi).sum().item()} of {i.numel()}")
    check(torch.equal(s, fs), f"{what}: certified scores are not the "
          f"fixed-order oracle's bits")
    return compare_oracle(s, i, *cublas, TOL_EXACT, what)


def profile_batch(fn, reps: int = 3):
    """(wall ms per call, {kernel: device ms per call}, device idle share)
    of `fn` under torch.profiler; no kernels where it saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "")[:60]
            per[name] = per.get(name, 0.0) + us / 1e3 / reps
    per = dict(sorted(per.items(), key=lambda kv: -kv[1]))
    return wall, per, max(0.0, 1.0 - sum(per.values()) / wall)


def ablation_body(mod, name):
    """The ops/cuda/ablation.Body of an ablation path's case; None for
    full_r1 (kernel 3)."""
    entry = (mod.CASES if hasattr(mod, "CASES") else mod.KERNELS)[name]
    entry = entry[0] if isinstance(entry, tuple) else entry
    return entry if isinstance(entry, ablation.Body) else None


def library_mm(q, ft):
    """(ms, call) of torch.mm of a body's operands, the dot every ablation
    body shares: fp32 with TF32 off; bf16 into fp32 where this torch's
    torch.mm takes `out_dtype`, else the fp32 upcast."""
    if q.dtype == torch.float32:
        return sync_ms(lambda: torch.mm(q, ft), 10), "torch.mm(q, ft) fp32"
    try:
        torch.mm(q[:1], ft[:, :128], out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (sync_ms(lambda: torch.mm(q.float(), ft.float()), 10),
                "torch.mm(q.float(), ft.float())")
    return (sync_ms(lambda: torch.mm(q, ft, out_dtype=torch.float32), 10),
            "torch.mm(q, ft, out_dtype=torch.float32)")


def compare_fused(args, k, exact, what):
    """Kernel 3 vs its plain version on the same inputs: bitwise."""
    kv, ki = fused_topk(*args, k=k, exact=exact)
    pv, pi = fused_topk_plain(*args, k=k, exact=exact)
    torch.cuda.synchronize()
    err = (kv - pv).nan_to_num(posinf=0.0, neginf=0.0).abs().max().item()
    check(torch.equal(kv, pv) and torch.equal(ki, pi),
          f"{what}: kernel differs from plain in {(ki != pi).sum().item()} "
          f"indices, max value diff {err}")
    return kv, ki, err


def make_songs_csv(path: Path, n_rows: int, n_genres: int, seed: int) -> None:
    """A Spotify-schema CSV (reference DataManager.cpp:121-125 columns)."""
    rng = np.random.default_rng(seed)
    vals = rng.random((n_rows, 8))
    loud = -60 + 60 * rng.random(n_rows)
    tempo = 40 + 180 * rng.random(n_rows)
    key = rng.integers(0, 12, n_rows)
    mode = rng.integers(0, 2, n_rows)
    genre = rng.integers(0, n_genres, n_rows)
    lines = [
        "track_id,track_name,artists,album_name,danceability,energy,key,"
        "loudness,mode,speechiness,acousticness,instrumentalness,liveness,"
        "valence,tempo,track_genre"
    ]
    for i in range(n_rows):
        v = vals[i]
        lines.append(
            f"tid{i:06d},Song {i},Artist {i % 997},Album {i % 113},"
            f"{v[0]:.4f},{v[1]:.4f},{key[i]},{loud[i]:.3f},{mode[i]},"
            f"{v[2]:.4f},{v[3]:.4f},{v[4]:.4f},{v[5]:.4f},{v[6]:.4f},"
            f"{tempo[i]:.3f},genre-{genre[i]}"
        )
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv} exited {rc}")
    return out.getvalue()


def check_recommendations(text: str, cat: Catalog, row: int, n: int) -> None:
    """The CLI's printed ids and scores equal the certified tier's
    fixed-order oracle's on the card."""
    ids = re.findall(r"^   ID:     (.*)$", text, flags=re.M)
    scores = [float(s) for s in re.findall(r"^   Score:  (.*)$", text, flags=re.M)]
    f = torch.from_numpy(cat.features).to(DEV)
    nrm = torch.from_numpy(cat.norms).to(DEV)
    rs, ri = similarity.exact_topk_chunked(
        f[row:row + 1], f, nrm, exclude_rows=torch.tensor([row], device=DEV), k=n,
        fixed_order=True,
    )
    want = [str(cat.track_ids[r]) for r in ri[0].tolist()]
    check(ids == want, f"cli ids {ids} != oracle {want}")
    # printed with 6 decimals: rounding 5e-7
    check(np.allclose(scores, rs[0].cpu().numpy(), rtol=0, atol=5.1e-7),
          f"cli scores {scores} vs oracle {rs[0].tolist()}")


def ablation_phase(n: int, b: int, kernels: dict, launches: dict) -> None:
    """Phase 13: TPU kernels 5-8 (kernel 3's round-2 ablation bodies) and
    the four experiment paths that run them, at their mains' n x b; adds
    each body's kernels-line entry and launches."""
    t13 = time.perf_counter()
    similarity.disable_tf32()
    paths = {"r2": kernel_ablation_r2, "r2b": kernel_ablation_r2b,
             "r2c": kernel_ablation_r2c, "r2d": kernel_ablation_r2d}
    # every case against its plain version on its main's inputs: outputs
    # and per-tile digest, NaN-aware; the first case of each body is kept
    # for its kernels-line entry
    first, n13, nan13 = {}, 0, []
    for key, mod in paths.items():
        for name, call in mod.cases(n=n, b=b, device=DEV):
            body = ablation_body(mod, name)
            if body is None:                    # full_r1: kernel 3
                err = check_bitwise(call(), call(plain=True), f"{key} {name}")
                bname = f"{key}.{name}"
            else:
                out, plain = call(digest=True), call(digest=True, plain=True)
                torch.cuda.synchronize()
                flat = [*out[:-1], *out[-1]], [*plain[:-1], *plain[-1]]
                for o, p in zip(*flat):
                    check(ablation.nan_equal(o, p), f"{key} {name}: kernel "
                          f"differs from plain in {(o != p).sum().item()} "
                          f"entries (NaN-aware)")
                err = max(finite_diff(o.float(), p.float()) for o, p in zip(*flat))
                if torch.isnan(out[0]).any():
                    nan13.append(name)
                bname = body.name
            first.setdefault(bname, (key, name, call, err, body))
            n13 += 1
    check(n13 == 35 and len(first) == 17, f"{n13} cases, {len(first)} bodies")
    t_cmp13 = time.perf_counter() - t13
    lib13 = {}
    for bname, (key, name, call, err, body) in first.items():
        q, qn, ft, cn = call.args[:4]
        inputs = [x for x in call.args if isinstance(x, torch.Tensor)]
        if bname == "r2.full_r1":
            out = call()
            # kernel 3's library entry: a product of unit operands, a top-k
            qu = q / qn.clamp_min(1e-30)
            fu = ft / cn.clamp_min(1e-30)
            lib = sync_ms(lambda: torch.topk(torch.mm(qu, fu), out[0].shape[1]),
                          10)
            del qu, fu
            how = "torch.topk(torch.mm(q/qn, ft/cn), k)"
        else:
            out = call(digest=True)
            out = (*out[:-1], *out[-1])
            if (q.data_ptr(), ft.data_ptr()) not in lib13:
                lib13[q.data_ptr(), ft.data_ptr()] = library_mm(q, ft)
            lib, how = lib13[q.data_ptr(), ft.data_ptr()]
        kernels[bname] = dict(
            source=f"{CSRC}/{'fused_topk' if body is None else 'ablation_r2'}.cu",
            replaces=f"{ablation.R2}:136" if body is None else body.replaces,
            case=name, max_abs_err=err,
            ms=sync_ms(call, 10), plain_ms=sync_ms(lambda: call(plain=True), 2),
            **bound(dot_flops(q, ft, q.shape[1]),
                    "bf16" if q.dtype == torch.bfloat16 else "fp32",
                    *inputs, *out),
            library_ms=lib, library=how,
        )
    t_time13 = time.perf_counter() - t13 - t_cmp13
    # the four paths, each with its kernels' counts set to 0 just before
    mains13 = {}
    for key, mod in paths.items():
        bodies = list(ablation.BODIES[key].values())
        for body in bodies:
            body.launches = 0
        fused_topk.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            mains13[key] = mod.main(n=n, b=b, device=DEV, reps=5)
        for body in bodies:
            launches[body.name] = body.launches
        if key == "r2":
            launches["r2.full_r1"] = fused_topk.launches
        check(all(np.isfinite(t) and t > 0 for t in mains13[key].values()),
              f"{key} main: {mains13[key]}")
    check(all(launches[nm] > 0 for nm in first),
          f"a kernel of the ablation paths did not launch: "
          f"{ {nm: launches[nm] for nm in first} }")
    print(f"phase 13 ablation bodies: {n13} cases of the four launchers at "
          f"{b} x {n} bitwise equal to their plain versions, outputs and "
          f"per-tile digests (NaN-aware; NaN outputs in {nan13}), in "
          f"{t_cmp13:.1f} s; kernels-line timing {t_time13:.1f} s; "
          + "; ".join(f"{nm} {kernels[nm]['ms']:.3f} ms (plain "
                      f"{kernels[nm]['plain_ms']:.1f}, bound "
                      f"{kernels[nm]['bound_ms']:.3f}, library "
                      f"{kernels[nm]['library_ms']:.3f})" for nm in first)
          + "; mains: " + "; ".join(
              f"{key} " + ", ".join(f"{c} {t:.3f}" for c, t in r.items())
              for key, r in mains13.items())
          + f" ms; launches { {nm: launches[nm] for nm in first} }; "
          f"{time.perf_counter() - t13:.1f} s")


def approx_phase(cat: Catalog, queries, excl, fixed, kernels: dict,
                 launches: dict) -> None:
    """Phase 14: the approx tier through the Retriever at the phase-6 cell
    and B = 1; kernel 1 at the tier's shapes against its plain version,
    as the "scan_v3_approx" entries of the kernels line."""
    n, k = len(cat), 10
    t0 = time.perf_counter()
    ra = Retriever(cat, RetrievalConfig(dtype="bfloat16"), DEV)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    check(ra.backend == "approx", f"backend {ra.backend}")
    split_bf16x2.launches = scan_v3.launches = 0
    s, i = ra.retrieve(queries, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    got = {"split_bf16x2": split_bf16x2.launches, "scan_v3": scan_v3.launches}
    check(all(v > 0 for v in got.values()),
          f"approx: a kernel of the path did not launch: {got}")
    fs, fi = fixed
    rec = recall(i, fi)
    check(rec >= 0.99, f"approx recall@{k} {rec} against the fixed-order oracle")
    both = i[:, :, None] == fi[:, None, :]
    err = (s[:, :, None] - fs[:, None, :]).abs()[both].max().item()
    check(err <= BF16X2_EPS, f"approx scores differ from the oracle's by {err}")
    check(bool(((i >= 0) & (i < n)).all())
          and not bool((i == excl[:, None]).any()),
          "approx: an index outside [0, N) or an excluded row")
    t_b = wall_ms(lambda: ra.retrieve(queries, k=k, exclude_rows=excl), 20)
    q1, e1 = queries[:1], excl[:1]
    split_bf16x2.launches = scan_v3.launches = 0
    ra.retrieve(q1, k=k, exclude_rows=e1)
    torch.cuda.synchronize()
    b1 = scan_v3.launches
    check(split_bf16x2.launches > 0 and b1 > 0, "approx B=1: a kernel did not launch")
    t_1 = wall_ms(lambda: ra.retrieve(q1, k=k, exclude_rows=e1), 20)
    # anti-aligned queries: every real cosine is < 0, so the pad columns'
    # zero planes (score 0) would fill every bin did kernel 1 scan them;
    # given the real column count it fills every slot with real rows
    sa, ia = ra.retrieve(-queries, k=k, exclude_rows=excl)
    f_dev = torch.from_numpy(cat.features).to(DEV)
    n_dev = torch.from_numpy(cat.norms).to(DEV)
    fas, fai = similarity.exact_topk_chunked(-queries, f_dev, n_dev,
                                             exclude_rows=excl, k=k,
                                             fixed_order=True)
    torch.cuda.synchronize()
    del f_dev, n_dev
    unfilled = ia == -1
    check(not bool(unfilled.any()) and bool(((ia >= 0) & (ia < n)).all())
          and bool(torch.isfinite(sa).all()),
          f"anti-aligned: {int(unfilled.sum())} of {ia.numel()} slots "
          "unfilled, or an index outside [0, N)")
    rec_anti = recall(ia, fai)
    check(rec_anti >= 0.99, f"anti-aligned recall@{k} {rec_anti} against the "
          "fixed-order oracle")
    both_a = ia[:, :, None] == fai[:, None, :]
    err_anti = (sa[:, :, None] - fas[:, None, :]).abs()[both_a].max().item()
    check(err_anti <= BF16X2_EPS, f"anti-aligned scores off by {err_anti}")
    ap = ra.approx
    dev_bytes = sum(t.numel() * t.element_size() for t in (ap.ft, ap.nrm_row))
    cert_bytes = dev_bytes + n * cat.features.shape[1] * 4 + n * 4
    launches["scan_v3_approx"] = got["scan_v3"]
    launches["scan_v3_approx_b1"] = b1
    # kernel 1 at the tier's shapes (its topc is approx_retrieve's c)
    c = min(max(k + 8, ap.config.prefilter), ap.depth * ap.w)
    q2 = split_queries(queries)
    for name, qq in (("scan_v3_approx", q2),
                     ("scan_v3_approx_b1", q2[:1].contiguous())):
        kerr, _, out = compare_scan(qq, ap.ft, ap.depth, c, w=ap.w, ncols=n)
        kernels[name] = dict(
            source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
            max_abs_err=kerr,
            ms=sync_ms(lambda: scan_v3(qq, ap.ft, w=ap.w, depth=ap.depth,
                                       topc=c, ncols=n), 20),
            plain_ms=sync_ms(lambda: scan_v3_plain(
                qq, ap.ft, w=ap.w, depth=ap.depth, topc=c, ncols=n), 3),
            **bound(dot_flops(qq, ap.ft[:, :n], qq.shape[1]), "bf16", qq,
                    ap.ft[:, :n], *out),
            library_ms=None,
        )
        del out
    print(f"phase 14 approx tier: N={n} B={queries.shape[0]} k={k}: launches "
          f"{got} (B=1: kernel 1 {b1}); recall@{k} {rec:.4f} against the "
          f"fixed-order oracle, max score diff where rows agree {err:.3g} "
          f"(limit {BF16X2_EPS}); no index >= N; batch {t_b:.3f} ms median "
          f"of 20 ({queries.shape[0] / t_b * 1e3:.0f} q/s); B=1 {t_1:.3f} ms; "
          f"anti-aligned batch: {int(unfilled.sum())} of {ia.numel()} slots "
          f"unfilled, recall@{k} {rec_anti:.4f} against the fixed-order "
          f"oracle, max score diff {err_anti:.3g}; device bytes "
          f"{dev_bytes} ({dev_bytes / cert_bytes:.3f} of the certified "
          f"tier's {cert_bytes}); kernel 1 at the tier's shapes (topc {c}) "
          f"bitwise its plain version: batch "
          f"{kernels['scan_v3_approx']['ms']:.3f} ms, B=1 "
          f"{kernels['scan_v3_approx_b1']['ms']:.4f} ms; setup {t_setup:.1f} s")


def http_json(url: str, body=None) -> dict:
    """GET `url`, or POST `body` as JSON; the decoded answer."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def held_burst(svc, feats: np.ndarray, rows: np.ndarray, max_queue: int = 64,
               k: int = 10) -> Tuple[int, int]:
    """The 429 path on the card: a coalescer whose dispatcher is held
    inside its first batch takes `max_queue` more requests and sheds the
    rest of a `max_queue` + 64 burst at enqueue; released, every accepted
    request gets a direct call's answer.  Returns (shed, answered)."""
    gate, entered = threading.Event(), threading.Event()

    def held(q, kk, ex):
        entered.set()
        check(gate.wait(timeout=120), "the held batch was never released")
        return svc._retrieve_batch(q, kk, ex)

    co = BatchCoalescer(held, window_ms=0.0, max_queue=max_queue)
    burst = max_queue + 64
    got, shed = {}, []

    def client(i):
        try:
            got[i] = co.submit(feats[rows[i]], int(rows[i]), k, timeout_s=120)
        except ServiceOverloaded:
            shed.append(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(burst)]
    try:
        threads[0].start()
        check(entered.wait(timeout=120), "the coalescer did not dispatch")
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 120
        while (len(co._pending) + len(shed) < burst - 1
               and time.monotonic() < deadline):
            time.sleep(0.001)
    finally:
        gate.set()
        for t in threads:
            if t.ident is not None:
                t.join(timeout=120)
        co.close()
    check(not any(t.is_alive() for t in threads)
          and len(shed) == burst - 1 - max_queue
          and co.stats["rejected"] == len(shed),
          f"held burst: {len(shed)} of {burst} shed, {co.stats}")
    acc = np.asarray(sorted(got))
    ws, wi = svc.retriever.retrieve_host(feats[rows[acc]], k=k,
                                         exclude_rows=rows[acc])
    check(all(np.array_equal(got[i][1], wi[j]) and np.array_equal(got[i][0], ws[j])
              for j, i in enumerate(acc)),
          "held burst: an accepted answer differs from a direct call")
    return len(shed), len(acc)


def serve_phase(feats: np.ndarray, build_s: float) -> None:
    """Phase 15: the serve row at the JAX harness's defaults, a fresh
    service's warmup and a second one, the 429 path with a held dispatcher,
    and a live HTTP server held against direct calls."""
    t15 = time.perf_counter()
    split_bf16x2.launches = scan_v3.launches = 0
    row = benchmark.run_serve_row(device=DEV)
    got = {"split_bf16x2": split_bf16x2.launches, "scan_v3": scan_v3.launches}
    check(all(v > 0 for v in got.values()),
          f"serve row: a kernel of the path did not launch: {got}")
    check(row["serve_errors"] == 0, f"serve row: {row}")
    t_row = time.perf_counter() - t15
    n, k = len(feats), 10
    srv = make_server(benchmark._serve_catalog(feats), "127.0.0.1", 0, None,
                      device=DEV)
    svc, server_thread = srv.server_service, None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # the library was built in phase 2; a new checkout's first
            # warmup adds that build to the first one here
            first = svc.warmup()
            warm = svc.warmup()
            r = svc.retriever
            rows = np.random.default_rng(15).integers(0, n, 256)
            # the coalescer's batch sizes, unpadded (the JAX service pads
            # each batch to a power of two)
            sizes = {m: wall_ms(lambda: r.retrieve_host(
                feats[rows[:m]], k=k, exclude_rows=rows[:m]), 20)
                for m in (1, 5, 8, 16, 32)}
            shed, answered = held_burst(svc, feats, rows)
            server_thread = threading.Thread(target=srv.serve_forever,
                                             daemon=True)
            server_thread.start()
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            out = http_json(f"{base}/recommend?id=tid00000042&n={k}")
            want = [x.row for x in r.recommend_by_id("tid00000042", k)]
            check([x["row"] for x in out["results"]] == want,
                  "/recommend rows differ from a direct call's")
            ws, wi = r.retrieve_host(feats[rows[:8]], k=k)
            out = http_json(f"{base}/retrieve",
                            {"queries": feats[rows[:8]].tolist(), "k": k})
            check(np.array_equal(out["rows"], wi)
                  and np.array_equal(np.asarray(out["scores"], np.float32), ws),
                  "/retrieve differs from a direct call")
            # 8 threads at once, each its own 16 queries, against serial calls
            batches = [feats[rows[16 * t:16 * t + 16]] for t in range(8)]
            serial = [r.retrieve_host(q, k=k)[1] for q in batches]
            answers = [None] * 8

            def client(t):
                answers[t] = http_json(f"{base}/retrieve",
                                       {"queries": batches[t].tolist(), "k": k})

            clients = [threading.Thread(target=client, args=(t,))
                       for t in range(8)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=120)
            check(not any(c.is_alive() for c in clients)
                  and all(a is not None and np.array_equal(a["rows"], w)
                          for a, w in zip(answers, serial)),
                  "concurrent /retrieve answers differ from serial calls")
            metrics = http_json(f"{base}/metrics")
            check("certificate_fallbacks" in metrics
                  and metrics["requests"] >= 10, f"/metrics {metrics}")
            small = str(Path(tmp) / "small.npz")
            m = min(50_000, n // 2)
            benchmark._serve_catalog(feats[:m].copy()).save(small)
            out = http_json(f"{base}/reload", {"catalog": small})
            check(out.get("num_items") == m, f"/reload {out}")
            out = http_json(f"{base}/recommend?id=tid00000042&n={k}")
            want = [x.row for x in
                    svc.retriever.recommend_by_id("tid00000042", k)]
            got_rows = [x["row"] for x in out["results"]]
            check(got_rows == want and max(got_rows) < m,
                  "/recommend after /reload differs from a direct call's")
    finally:
        if server_thread is not None:
            srv.shutdown()
        svc.close()
        srv.server_close()
    print(f"phase 15 serving: run_serve_row (1M items, 32 clients x 10 "
          f"requests, queue 64, certified tier): {row}; "
          f"launches {got}; {t_row:.1f} s; warmup (batches 8-256) of a "
          f"fresh service {first:.3f} s (+ the serving library's build, "
          f"{build_s:.1f} s in phase 2, in a new checkout: cold "
          f"{build_s + first:.2f} s), again {warm:.3f} s; held dispatcher: "
          f"{shed} of 128 shed with 429 at enqueue, {answered} answered as "
          f"direct calls; certified batch at B = "
          + ", ".join(f"{m}: {t:.3f}" for m, t in sizes.items())
          + f" ms (median of 20, no padding); HTTP /recommend, /retrieve, "
          f"/metrics (certificate_fallbacks {metrics['certificate_fallbacks']}"
          f"), /reload ({m} items) answer as direct calls; 8 concurrent "
          f"/retrieve clients equal serial calls; "
          f"{time.perf_counter() - t15:.1f} s")


def bench_phase(kernels: dict, launches: dict, n: int, b: int) -> dict:
    """Phase 16: `benchmark.run_benchmark`'s headline, bf16 and 64-dim rows
    (their JSON lines printed), then kernels 1 and 2 at F = 64 against their
    plain versions; adds kernel 1's F = 64 entry to the kernels line.
    Returns the uniform 64-dim catalog's certificate counts per batch (the
    64-dim row's fallbacks, and one batch's fallbacks and escalations)."""
    t16 = time.perf_counter()
    rows = {}
    for name, kw in (
        ("headline", dict(reps=3, also_b1=True)),
        ("bf16", dict(backend="bf16", warmup=1, iters=6)),
        ("64dim", dict(feature_dim=64, warmup=1, iters=6, verify_queries=64)),
    ):
        split_bf16x2.launches = scan_v3.launches = 0
        r = benchmark.run_benchmark(num_items=n, num_queries=b, k=10,
                                    device=DEV, **kw)
        got = {"split_bf16x2": split_bf16x2.launches,
               "scan_v3": scan_v3.launches}
        check(all(v > 0 for v in got.values()),
              f"benchmark {name}: a kernel of the path did not launch: {got}")
        rows[name] = (r, got)
        print(benchmark.to_json_line(r))
    exact = f"queries/sec/chip exact top-10 over {n} items"
    check(rows["headline"][0].metric == exact == rows["64dim"][0].metric
          and rows["bf16"][0].metric == exact.replace("exact", "approx"),
          "benchmark metric strings")
    # one batch of the 64-dim row's tier (its launches are the kernels
    # line's), then kernels 1 and 2 at its shapes against their plain
    # versions
    feats64, norms64, q64, r64 = benchmark._make_inputs(n, b, 64, 0)
    cr64 = CertifiedRetriever(feats64, norms64, None, DEV)
    del feats64, norms64
    q = torch.from_numpy(q64).to(DEV)
    split_bf16x2.launches = scan_v3.launches = 0
    cr64(q, 10, torch.from_numpy(r64).long().to(DEV))
    torch.cuda.synchronize()
    uniform64 = {"row_fallbacks": rows["64dim"][0].details[
        "certificate_fallback_queries_per_batch"],
        "fallbacks": cr64.fallbacks, "escalations": cr64.escalations}
    launches["scan_v3_f64"] = scan_v3.launches
    check(split_bf16x2.launches > 0 and scan_v3.launches > 0,
          "64-dim batch: a kernel of the path did not launch")
    dl = cr64.layout
    qu = q / similarity.row_norms(q).clamp_min(1e-30)[:, None]
    hi, lo = split_bf16x2(qu)
    phi, plo = split_bf16x2_plain(qu)
    torch.cuda.synchronize()
    check(torch.equal(hi.view(torch.int16), phi.view(torch.int16))
          and torch.equal(lo.view(torch.int16), plo.view(torch.int16)),
          "split kernel differs from plain at F=64")
    q2 = torch.cat([hi, lo, lo, hi], dim=1)
    err, _, out = compare_scan(q2, dl.ft, 2, 32, ncols=n)
    kernels["scan_v3_f64"] = dict(
        source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
        max_abs_err=err,
        ms=sync_ms(lambda: scan_v3(q2, dl.ft, w=128, depth=2, topc=32,
                                   ncols=n), 10),
        plain_ms=sync_ms(lambda: scan_v3_plain(q2, dl.ft, w=128, depth=2,
                                               topc=32, ncols=n), 1),
        **bound(dot_flops(q2, dl.ft[:, :n], q2.shape[1]), "bf16", q2,
                dl.ft[:, :n], *out),
        library_ms=None,
    )
    cols = dl.ft.shape[1]
    del dl, cr64, out
    print(f"phase 16 benchmark rows (N={n}, B={b}, k=10): "
          + "; ".join(f"{nm} {r.value} q/s, batch "
                      f"{r.details['batch_latency_ms']} ms, launches {got}"
                      for nm, (r, got) in rows.items())
          + f"; headline B=1 {rows['headline'][0].details['b1_latency_ms']} ms, "
          f"fallbacks per batch "
          f"{rows['headline'][0].details['certificate_fallback_queries_per_batch']}"
          f", 64-dim fallbacks per batch "
          f"{rows['64dim'][0].details['certificate_fallback_queries_per_batch']}"
          f"; 64-dim answers for 64 queries equal the fixed-order oracle's "
          f"index for index; at F=64 the split is bitwise its plain "
          f"version and kernel 1 ({b} x {cols}, depth 2) is bitwise "
          f"its plain version: {kernels['scan_v3_f64']['ms']:.3f} ms vs plain "
          f"{kernels['scan_v3_f64']['plain_ms']:.1f} ms; "
          f"{time.perf_counter() - t16:.1f} s")
    return uniform64


MF_USERS, MF_ITEMS, MF_PER_USER = 100_000, 20_000, 20   # BASELINE config 3
MF_EVAL_CPU = 1000       # of the 10,000 evaluated users, also on the CPU


def mips_near_ties(q, items, gi, ci, gs, cs) -> int:
    """The card's and the CPU's MIPS top-k (indices gi / ci, scores gs / cs)
    agree within 1e-6 in score, and where an index differs the two items
    score within 1e-6 of each other (fp64 dots).  Returns the differing
    slots."""
    err = (gs - cs).abs().max().item()
    check(err <= 1e-6, f"MIPS card vs CPU: scores differ by {err}")
    diff = gi != ci
    if diff.any():
        q64, it64 = q.double(), items.double()
        rows = diff.nonzero()[:, 0]
        sg = (q64[rows] * it64[gi[diff]]).sum(1)
        sc = (q64[rows] * it64[ci[diff]]).sum(1)
        gap = (sg - sc).abs().max().item()
        check(gap <= 1e-6, f"MIPS card vs CPU: an index differs at a gap "
              f"of {gap} (not a near-tie)")
    return int(diff.sum().item())


def mf_phase(kernels: dict, launches: dict) -> tuple:
    """Phase 17: the MF path at BASELINE config 3 (100,000 users x 20,000
    items, 20 plays each, d = 64): the workload's host steps, full ALS (3
    iterations, per-half and Cholesky ms, peak memory), a checkpointed
    resume, two iALS++ sweeps, evaluation on 10,000 held-out users (1,000 of
    them also on the CPU), 200 SGD steps, the benchmark's MF quality row on
    the card and the CPU, then the item factors served by the certified
    tier at F = 64 through `embed-catalog --mf` (kernels 1 and 2; the
    "scan_v3_mf" entry)."""
    t17 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    data = als_scale_1m.prepare(MF_USERS, MF_ITEMS, MF_PER_USER)
    host = data["seconds"]
    train, item_view = data["train"], data["item_view"]
    cfg = MFConfig(embedding_dim=64, num_iterations=3, reg=0.05, alpha=10.0)

    stats = {}
    t0 = time.perf_counter()
    users, items = mf.train_als(train, cfg, item_view=item_view, device=DEV,
                                stats=stats)
    als_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(np.isfinite(users).all() and np.isfinite(items).all(),
          "ALS factors are not finite")
    with tempfile.TemporaryDirectory() as ck:
        mf.train_als(train, MFConfig(**{**vars(cfg), "num_iterations": 2}),
                     item_view=item_view, checkpoint_dir=ck, device=DEV)
        t0 = time.perf_counter()
        ru, ri = mf.train_als(train, cfg, item_view=item_view,
                              checkpoint_dir=ck, device=DEV)
        resume_s = time.perf_counter() - t0
    resume_err = max(np.abs(ru - users).max(), np.abs(ri - items).max())
    check(resume_err <= 1e-4, f"resumed ALS differs by {resume_err}")
    pp = {}      # two sweeps: the first pays the 16 x 16 solver's warm-up
    mf.train_als(train, MFConfig(**{**vars(cfg), "num_iterations": 2}),
                 item_view=item_view, subspace=16, device=DEV, stats=pp)

    rows = als_scale_1m.eval_users(data)
    t0 = time.perf_counter()
    m = als_scale_1m.evaluate(users, items, data, rows, DEV)
    eval_s = time.perf_counter() - t0
    check(m["num_eval_users"] == len(rows) == 10_000
          and 0 < m["ndcg@k"] <= m["recall@k"] <= 1, f"evaluation {m}")
    sub = rows[:MF_EVAL_CPU]
    args = [torch.from_numpy(a) for a in (
        users[sub], items, data["seen_idx"][sub], data["seen_mask"][sub])]
    gs, gi = similarity.mips_topk_chunked(*[a.to(DEV) for a in args], k=10)
    cs, ci = similarity.mips_topk_chunked(*args, k=10)
    ties = mips_near_ties(args[0], args[1], gi.cpu(), ci, gs.cpu(), cs)

    # SGD, 200 steps of 8192.  At the default lr (0.05) the sampled loss
    # rises at this size, in the JAX package as in the port (both on the
    # CPU, the same batches: tests/test_torch_mf.py
    # test_train_sgd_default_lr_at_config3_matches_jax), so there the card's
    # losses are held to the CPU port's over the first 20 steps, each
    # within 1e-4 (the port vs JAX on the CPU: 1.2e-5); at lr 0.01 the loss
    # must fall
    sgd, traces = {}, {}
    for lr in (MFConfig.learning_rate, 0.01):
        traces[lr] = []
        t0 = time.perf_counter()
        mf.train_sgd(train, MFConfig(embedding_dim=64, reg=0.05, alpha=10.0,
                                     learning_rate=lr),
                     num_steps=200, device=DEV, losses=traces[lr])
        sgd[lr] = ((time.perf_counter() - t0) * 1e3 / 200,
                   np.mean(traces[lr][:20]), np.mean(traces[lr][-20:]))
        check(np.isfinite(traces[lr]).all(), f"SGD lr {lr}: loss not finite")
    cpu_losses = []
    mf.train_sgd(train, MFConfig(embedding_dim=64, reg=0.05, alpha=10.0),
                 num_steps=20, device="cpu", losses=cpu_losses)
    cpu_losses = np.asarray(cpu_losses)
    sgd_gap = float(np.max(np.abs(
        np.asarray(traces[MFConfig.learning_rate][:20]) - cpu_losses)
        / cpu_losses))
    check(sgd_gap <= 1e-4, f"SGD at lr {MFConfig.learning_rate}: a card "
          f"step's loss differs from the CPU port's by {sgd_gap} (relative)")
    sgd_ms, first, last = sgd[0.01]
    check(last < first, f"SGD loss did not fall at lr 0.01: {first} -> {last}")

    t0 = time.perf_counter()
    q_card = benchmark.run_quality_row(device=DEV)
    q_card_s = time.perf_counter() - t0
    q_cpu = benchmark.run_quality_row(device="cpu")
    q_digests = benchmark.quality_data_digests()
    # the MF keys; the two-tower keys are phase 18's
    q_gap = max(abs(q_card[key] - q_cpu[key]) for key in q_card
                if key.startswith("mf_"))
    check(q_gap <= 0.002, f"quality row: card {q_card} vs CPU {q_cpu}")

    # the item factors as a 64-dim catalog, served by the certified tier
    with tempfile.TemporaryDirectory() as tmp:
        base, model, emb = (str(Path(tmp) / f) for f in
                            ("base.npz", "mf.npz", "emb.npz"))
        benchmark._serve_catalog(
            np.zeros((MF_ITEMS, 12), np.float32)).save(base)
        mf.save_model(model, users, items, cfg)
        run_cli(["--device", "cuda", "embed-catalog", "--catalog", base,
                 "--mf", model, "-o", emb])
        cat = Catalog.load(emb)
    check(np.array_equal(cat.features, items), "embedded catalog != factors")
    retriever = Retriever(cat, None, DEV)
    q = torch.from_numpy(users[rows[:1024]]).to(DEV)
    split_bf16x2.launches = scan_v3.launches = 0
    s, i = retriever.retrieve(q, k=10)
    torch.cuda.synchronize()
    launches["scan_v3_mf"] = scan_v3.launches
    check(split_bf16x2.launches > 0 and scan_v3.launches > 0,
          "MF catalog batch: a kernel of the path did not launch")
    f_dev = torch.from_numpy(cat.features).to(DEV)
    n_dev = torch.from_numpy(cat.norms).to(DEV)
    fs, fi = similarity.exact_topk_chunked(q, f_dev, n_dev, k=10,
                                           fixed_order=True)
    check(torch.equal(i, fi) and torch.equal(s, fs),
          "MF catalog: certified answers are not the fixed-order oracle's")
    serve_ms = wall_ms(lambda: retriever.retrieve(q, k=10), 10)
    dl = retriever.certified.layout
    qu = q / similarity.row_norms(q).clamp_min(1e-30)[:, None]
    hi, lo = split_bf16x2(qu)
    phi, plo = split_bf16x2_plain(qu)
    torch.cuda.synchronize()
    check(torch.equal(hi.view(torch.int16), phi.view(torch.int16))
          and torch.equal(lo.view(torch.int16), plo.view(torch.int16)),
          "split kernel differs from plain on the MF queries")
    q2 = torch.cat([hi, lo, lo, hi], dim=1)
    nc = len(cat)
    err, _, out = compare_scan(q2, dl.ft, 2, 32, ncols=nc)
    # the bound counts the catalog's own columns, not the layout's padding
    real = dl.ft[:, :nc]
    kernels["scan_v3_mf"] = dict(
        source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
        max_abs_err=err,
        ms=sync_ms(lambda: scan_v3(q2, dl.ft, w=128, depth=2, topc=32,
                                   ncols=nc), 10),
        plain_ms=sync_ms(lambda: scan_v3_plain(q2, dl.ft, w=128, depth=2,
                                               topc=32, ncols=nc), 1),
        **bound(dot_flops(q2, real, q2.shape[1]), "bf16", q2, real, *out),
        library_ms=None,
    )
    cols = dl.ft.shape[1]
    del retriever, dl, out, f_dev

    def per_iter(st, name):
        return "/".join(f"{v:.1f}" for v in st[f"{name}_ms"])

    print(f"phase 17 MF (config 3: {MF_USERS} users x {MF_ITEMS} items, "
          f"{data['nnz']} plays, user md {train.item_idx.shape[1]}, item md "
          f"{item_view.item_idx.shape[1]}): host datagen "
          f"{host['datagen']:.2f} s, from_coo {host['from_coo']:.2f} s, split "
          f"{host['split']:.2f} s, transpose {host['transpose']:.2f} s; ALS d=64 "
          f"x3 in {als_s:.2f} s: ms per iteration user half "
          f"{per_iter(stats, 'user')}, item half {per_iter(stats, 'item')}, "
          f"Cholesky (factor + solve) inside them {per_iter(stats, 'chol')}; "
          f"peak memory {peak_gib:.2f} GiB; resume (2 + 1 iterations) equals "
          f"3 uninterrupted within {resume_err:.3g} (resumed iteration "
          f"{resume_s:.2f} s); iALS++ subspace 16, 2 iterations: user "
          f"{per_iter(pp, 'user')} ms, item {per_iter(pp, 'item')} ms, "
          f"Cholesky {per_iter(pp, 'chol')} ms; eval 10000 users: recall@10 "
          f"{m['recall@k']:.4f}, NDCG@10 {m['ndcg@k']:.4f} in {eval_s:.2f} s; "
          f"top-10 of {MF_EVAL_CPU} users equal on the CPU but {ties} slots "
          f"at near-ties (<= 1e-6); SGD 200 steps x 8192, lr 0.01: "
          f"{sgd_ms:.2f} ms per step, loss (mean of the first / last 20 "
          f"steps) {first:.4f} -> {last:.4f}; at lr {MFConfig.learning_rate} "
          f"{sgd[MFConfig.learning_rate][1]:.4f} -> "
          f"{sgd[MFConfig.learning_rate][2]:.4f}, its first 20 steps' losses "
          f"within {sgd_gap:.3g} (relative) of the CPU port's; quality row "
          f"card {q_card} in {q_card_s:.2f} s, CPU {q_cpu}, its data's "
          f"digests {q_digests}; MF catalog ({MF_ITEMS} x 64) served "
          f"by the certified tier: 1024 user queries bitwise the fixed-order "
          f"oracle, {serve_ms:.3f} ms per batch, kernels 1 (1024 x {cols}, "
          f"depth 2) and 2 bitwise their plain versions: "
          f"{kernels['scan_v3_mf']['ms']:.3f} ms vs plain "
          f"{kernels['scan_v3_mf']['plain_ms']:.1f} ms, bound "
          f"{kernels['scan_v3_mf']['bound_ms']:.4f} ms over the {len(cat)} "
          f"catalog columns ({cols - len(cat)} of padding not counted); "
          f"host numpy {np.__version__}; {time.perf_counter() - t17:.1f} s")
    return q_card, q_cpu, q_digests


# bf16 towers, card against CPU: one bf16 rounding of the row's largest
# entry (a hidden unit whose two sums straddle a rounding boundary moves
# by one bf16 step, and every output of its row with it)
TT_BF16_RTOL = 2.0**-7
# the quality row's two-tower keys, card against CPU: 2000 Adam steps
# amplify rounding, and the JAX package itself, its initial weights scaled
# by (1 + 1e-7 * N(0, 1)), reads 0.1443-0.1483 / 0.0756-0.0769 over 9 runs
# on a CPU (tests/test_torch_two_tower.py), so the two are held within that
# spread, not 0.002
TT_QUALITY_TOL = {"two_tower_recall_at_10": 0.005,
                  "two_tower_ndcg_at_10": 0.002}


def two_tower_phase(kernels: dict, launches: dict, catalog_path: str,
                    cat: Catalog, rows: np.ndarray, uniform64: dict,
                    quality: tuple) -> None:
    """Phase 18: the two-tower model (BASELINE config 5) at
    TwoTowerConfig's defaults on phase 5's 114,000-row catalog: `train`
    timed per step (host pair sampling, device step), then the CLI's
    `train-two-tower`, `embed-catalog --two-tower` and `recommend`; the
    trained item tower over phase 6's 1M x 12 rows, a 1M x 64 learned
    catalog served by the certified tier (bitwise the fixed-order oracle;
    kernels 1 and 2, the "scan_v3_tt" and "split_bf16x2_tt" entries) and
    the approx tier, at B = 1024 and B = 1, and a user profile's query;
    the towers on the card against the CPU; the quality row's two-tower
    keys from phase 17, card against CPU."""
    t18 = time.perf_counter()
    cat5 = Catalog.load(catalog_path)
    cfg = TwoTowerConfig()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' live tensors
    stats = {}
    t0 = time.perf_counter()
    res = two_tower.train(cat5.features, cat5.genre_ids, cfg, device=DEV,
                          stats=stats)
    train_s = time.perf_counter() - t0
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    losses = res.losses
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"two-tower loss did not fall: {losses}")
    pairs_ms = statistics.mean(stats["pairs_ms"])
    step_ms = statistics.mean(stats["step_ms"][1:])   # the first warms up
    del res

    # the CLI at its defaults on the same catalog
    work = Path(catalog_path).parent
    model_path, emb_path = str(work / "tt_model"), str(work / "tt_catalog.npz")
    t0 = time.perf_counter()
    out = run_cli(["--device", "cuda", "train-two-tower", "--catalog",
                   catalog_path, "-o", model_path])
    cli_train_s = time.perf_counter() - t0
    cli_loss = float(re.search(r"final loss (\S+)", out).group(1))
    check(abs(cli_loss - losses[-1]) <= 1e-3,
          f"CLI final loss {cli_loss} vs train()'s {losses[-1]}")
    model_bytes = Path(model_path).stat().st_size
    out = run_cli(["--device", "cuda", "embed-catalog", "--catalog",
                   catalog_path, "--two-tower", model_path, "-o", emb_path])
    check(f"{len(cat5)} items x {cfg.embedding_dim} dims" in out,
          f"embed-catalog: {out!r}")
    emb5 = Catalog.load(emb_path)
    out = run_cli(["--device", "cuda", "--song", "Song 4242", "-n", "5",
                   "--catalog", emb_path])
    check_recommendations(out, emb5, 4242, 5)
    params, file_cfg = two_tower.load_model(model_path)
    check(file_cfg == cfg, f"model file config {file_cfg}")
    n5 = len(cat5)
    del cat5, emb5

    # the item tower over phase 6's rows: a 1M x 64 learned catalog
    t0 = time.perf_counter()
    emb = two_tower.embed_catalog(params, cat.features, cfg, device=DEV)
    embed_ms = (time.perf_counter() - t0) * 1e3
    n, k = len(emb), 10
    check(emb.shape == (n, cfg.embedding_dim) and bool(np.isfinite(emb).all()),
          f"learned catalog {emb.shape}")
    tt_cat = dataclasses.replace(
        cat, features=emb, norms=np.linalg.norm(emb, axis=1).astype(np.float32),
        min_vals=np.zeros(emb.shape[1] - 1, np.float32),
        max_vals=np.ones(emb.shape[1] - 1, np.float32))
    q = torch.from_numpy(two_tower.embed_queries(
        params, cat.features[rows], cfg, device=DEV)).to(DEV)
    excl = torch.from_numpy(rows).to(DEV)
    t0 = time.perf_counter()
    rt = Retriever(tt_cat, None, DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cr = rt.certified
    split_bf16x2.launches = scan_v3.launches = 0
    s, i = rt.retrieve(q, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    got = {"split_bf16x2": split_bf16x2.launches, "scan_v3": scan_v3.launches}
    check(all(v > 0 for v in got.values()),
          f"two-tower batch: a kernel of the path did not launch: {got}")
    fallbacks, escalations = cr.fallbacks, cr.escalations
    f_dev = torch.from_numpy(emb).to(DEV)
    n_dev = torch.from_numpy(tt_cat.norms).to(DEV)
    fixed = similarity.exact_topk_chunked(q, f_dev, n_dev, exclude_rows=excl,
                                          k=k, fixed_order=True)
    cublas = similarity.exact_topk_chunked(q, f_dev, n_dev, exclude_rows=excl,
                                           k=k)
    score_err, ties = check_certified(s, i, fixed, cublas, "two-tower batch")
    batch_ms = wall_ms(lambda: rt.retrieve(q, k=k, exclude_rows=excl), 10)
    q1, e1 = q[:1], excl[:1]
    split_bf16x2.launches = scan_v3.launches = 0
    s1, i1 = rt.retrieve(q1, k=k, exclude_rows=e1)
    torch.cuda.synchronize()
    check(split_bf16x2.launches > 0 and scan_v3.launches > 0,
          "two-tower B=1: a kernel did not launch")
    check(torch.equal(i1, fixed[1][:1]) and torch.equal(s1, fixed[0][:1]),
          "two-tower B=1: not the fixed-order oracle's answer")
    b1_ms = wall_ms(lambda: rt.retrieve(q1, k=k, exclude_rows=e1), 20)
    # a user profile: the query tower of the mean of 5 liked rows
    prof = torch.from_numpy(two_tower.embed_user_profile(
        params, cat.features[rows[:5]], cfg, device=DEV)[None]).to(DEV)
    ps, pi = rt.retrieve(prof, k=k)
    pfs, pfi = similarity.exact_topk_chunked(prof, f_dev, n_dev, k=k,
                                             fixed_order=True)
    check(torch.equal(pi, pfi) and torch.equal(ps, pfs),
          "user profile: not the fixed-order oracle's answer")

    # the approx tier over the learned catalog
    ra = Retriever(tt_cat, RetrievalConfig(dtype="bfloat16"), DEV)
    check(ra.backend == "approx", f"backend {ra.backend}")
    sa, ia = ra.retrieve(q, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    check(not bool((ia == -1).any()) and bool(torch.isfinite(sa).all())
          and bool(((ia >= 0) & (ia < n)).all())
          and not bool((ia == excl[:, None]).any()),
          "two-tower approx: a (-inf, -1) slot, an index outside [0, N) or "
          "the excluded row")
    rec = recall(ia, fixed[1])
    check(rec >= 0.99, f"two-tower approx recall@{k} {rec}")
    both = ia[:, :, None] == fixed[1][:, None, :]
    approx_err = (sa[:, :, None] - fixed[0][:, None, :]).abs()[both].max().item()
    check(approx_err <= BF16X2_EPS,
          f"two-tower approx scores off by {approx_err}")
    approx_ms = wall_ms(lambda: ra.retrieve(q, k=k, exclude_rows=excl), 10)
    approx_b1_ms = wall_ms(lambda: ra.retrieve(q1, k=k, exclude_rows=e1), 20)
    del ra, f_dev, n_dev

    # kernels 2 and 1 at the batch's shapes, against their plain versions
    dl = cr.layout
    qu = q / similarity.row_norms(q).clamp_min(1e-30)[:, None]
    hi, lo = split_bf16x2(qu)
    phi, plo = split_bf16x2_plain(qu)
    torch.cuda.synchronize()
    check(torch.equal(hi.view(torch.int16), phi.view(torch.int16))
          and torch.equal(lo.view(torch.int16), plo.view(torch.int16)),
          "split kernel differs from plain on the two-tower queries")
    kernels["split_bf16x2_tt"] = dict(
        source=f"{CSRC}/split_bf16x2.cu", replaces=f"{PALLAS}:237",
        max_abs_err=max((hi.float() - phi.float()).abs().max().item(),
                        (lo.float() - plo.float()).abs().max().item()),
        ms=sync_ms(lambda: split_bf16x2(qu), 50),
        plain_ms=sync_ms(lambda: split_bf16x2_plain(qu), 50),
        **bound(qu.numel(), "fp32", qu, hi, lo), library_ms=None,
    )
    q2 = torch.cat([hi, lo, lo, hi], dim=1)
    err, _, out = compare_scan(q2, dl.ft, dl.depth, 32, w=dl.w, ncols=n)
    real = dl.ft[:, :n]
    kernels["scan_v3_tt"] = dict(
        source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
        max_abs_err=err,
        ms=sync_ms(lambda: scan_v3(q2, dl.ft, w=dl.w, depth=dl.depth, topc=32,
                                   ncols=n), 10),
        plain_ms=sync_ms(lambda: scan_v3_plain(q2, dl.ft, w=dl.w,
                                               depth=dl.depth, topc=32,
                                               ncols=n), 1),
        **bound(dot_flops(q2, real, q2.shape[1]), "bf16", q2, real, *out),
        library_ms=None,
    )
    launches["scan_v3_tt"] = got["scan_v3"]
    launches["split_bf16x2_tt"] = got["split_bf16x2"]
    cols = dl.ft.shape[1]
    del rt, cr, dl, out, real

    # the towers on the card against the CPU, from the same weights carried
    # through the JAX tree
    ref = two_tower.params_from_jax(two_tower.params_to_jax(
        two_tower.init_params(cfg, 12, torch.Generator().manual_seed(0))))
    x = np.random.default_rng(18).random((4096, 12), dtype=np.float32)
    gaps = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        card = two_tower.embed_catalog(ref, x, c, device=DEV)
        cpu = two_tower.embed_catalog(ref, x, c, device="cpu")
        gaps[dt] = float(np.abs(card - cpu).max())
        if dt == "float32":
            check(gaps[dt] <= 1e-5, f"fp32 towers: card vs CPU {gaps[dt]}")
        else:
            scale = np.abs(cpu).max(axis=1, keepdims=True)
            check(bool((np.abs(card - cpu)
                        <= TT_BF16_RTOL * scale + 1e-5).all()),
                  f"bf16 towers: card vs CPU beyond one bf16 rounding of "
                  f"the row's largest entry ({gaps[dt]})")

    q_card, q_cpu, digests = quality
    tt_gap = {key: abs(q_card[key] - q_cpu[key]) for key in TT_QUALITY_TOL}
    check(all(tt_gap[key] <= tol for key, tol in TT_QUALITY_TOL.items()),
          f"quality row two-tower keys: card {q_card} vs CPU {q_cpu}")
    print(f"phase 18 two-tower (config 5: D {cfg.embedding_dim}, hidden "
          f"{tuple(cfg.hidden_dims)}, batch {cfg.batch_size}, T "
          f"{cfg.temperature}, lr {cfg.learning_rate}, {cfg.num_steps} steps "
          f"of same-genre pairs on the {n5}-row catalog): train() in "
          f"{train_s:.1f} s, ms per step: host pair sampling {pairs_ms:.3f}, "
          f"device step {step_ms:.3f} (CUDA events, steps 2-{cfg.num_steps}); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (recorded "
          f"{[round(v, 4) for v in losses]}); peak memory above the earlier "
          f"phases' {held / 2**20:.1f} MiB: {peak_mib:.1f} MiB; "
          f"CLI train-two-tower in {cli_train_s:.1f} s, final loss "
          f"{cli_loss:.4f}, model file {model_bytes} bytes; embed-catalog "
          f"--two-tower then recommend --song equal the fixed-order oracle; "
          f"item tower over {n} rows in {embed_ms:.1f} ms; learned catalog "
          f"({n} x {cfg.embedding_dim}) certified, B={len(rows)} query-tower "
          f"queries: bitwise the fixed-order oracle, vs the cuBLAS oracle max "
          f"score diff {score_err:.3g}, {ties} near-tie positions differ; per "
          f"batch: fallbacks {fallbacks}, escalations {escalations} (uniform "
          f"64-dim catalog, phase 16: one batch {uniform64['fallbacks']} / "
          f"{uniform64['escalations']}, the 64-dim row "
          f"{uniform64['row_fallbacks']} fallbacks per batch); launches {got}; "
          f"batch {batch_ms:.3f} ms, B=1 {b1_ms:.3f} ms (bitwise), setup "
          f"{setup_s:.1f} s; a user profile's query bitwise the oracle; approx "
          f"tier: recall@{k} {rec:.4f}, max score diff where rows agree "
          f"{approx_err:.3g}, no (-inf, -1) slot, batch {approx_ms:.3f} ms, "
          f"B=1 {approx_b1_ms:.3f} ms; kernel 1 ({len(rows)} x {cols}, ncols "
          f"{n}, depth 2) {kernels['scan_v3_tt']['ms']:.3f} ms vs plain "
          f"{kernels['scan_v3_tt']['plain_ms']:.1f} ms, bound "
          f"{kernels['scan_v3_tt']['bound_ms']:.4f} ms, and kernel 2 "
          f"{kernels['split_bf16x2_tt']['ms']:.4f} ms, both bitwise their plain "
          f"versions; towers card vs CPU (4096 rows): fp32 max diff "
          f"{gaps['float32']:.3g}, bf16 {gaps['bfloat16']:.3g} (within one "
          f"bf16 rounding of each row's largest entry); quality row "
          f"two-tower keys card "
          f"{ {key: q_card[key] for key in TT_QUALITY_TOL} } vs CPU "
          f"{ {key: q_cpu[key] for key in TT_QUALITY_TOL} } (limits "
          f"{TT_QUALITY_TOL}), data digests {digests}; "
          f"{time.perf_counter() - t18:.1f} s")


# ---------------------------------------------------------------- phase 19

ING_ROWS = 1_000_000        # phase 19's CSV
ING_CHUNK = 200_000         # its streaming chunk


def child_rss(argv) -> Tuple[float, float]:
    """(seconds, peak RSS MiB) of `python3 argv` in a child process: a
    wrapper process runs it and reports resource.getrusage(
    RUSAGE_CHILDREN), so no earlier child of this script (nvcc, ptxas)
    enters the peak."""
    wrapper = ("import resource, subprocess, sys; "
               "rc = subprocess.run(sys.argv[1:], stdout=subprocess.DEVNULL)"
               ".returncode; print(rc, resource.getrusage("
               "resource.RUSAGE_CHILDREN).ru_maxrss)")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", wrapper, sys.executable, *argv],
        capture_output=True, text=True, check=True, timeout=900,
        cwd=Path(__file__).resolve().parent,
    ).stdout.split()
    check(out[0] == "0", f"child {argv} exited {out[0]}")
    return time.perf_counter() - t0, int(out[1]) / 1024.0


def tables_equal(a, b) -> bool:
    return (a.num_valid_rows == b.num_valid_rows
            and a.num_input_rows == b.num_input_rows
            and list(a.track_ids) == list(b.track_ids)
            and list(a.track_names) == list(b.track_names)
            and list(a.artists) == list(b.artists)
            and a.genre_names == b.genre_names
            and np.array_equal(a.genre_ids, b.genre_ids)
            and np.array_equal(a.raw_features, b.raw_features))


def ingest_phase(work: Path, gxx_s: float) -> None:
    """Phase 19: the data layer at 1M rows: the native parse against the
    Python parse, streaming against single-shot preprocessing (bitwise, in
    child processes with their peak RSS), and `retrieve` / `recommend`
    through the CLI over the streamed memory-mapped directory."""
    t19 = time.perf_counter()
    csv = work / "songs_1m.csv"
    t0 = time.perf_counter()
    make_songs_csv(csv, ING_ROWS, 114, seed=3)
    t_csv = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = csv_ingest.ingest_csv(str(csv), use_native=True)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = csv_ingest.ingest_csv(str(csv), use_native=False)
    t_py = time.perf_counter() - t0
    check(nat.num_valid_rows == ING_ROWS and tables_equal(nat, py),
          "phase 19: native and Python parses differ")
    del nat, py
    single, stream = work / "single_1m.npz", work / "stream_1m"
    cmd = ["-m", "spotify_recommender_tpu_torch", "--device", "cuda",
           "preprocess", str(csv), "-o"]
    t_stream, rss_stream = child_rss(
        cmd + [str(stream), "--streaming", "--chunk-rows", str(ING_CHUNK)])
    t_single, rss_single = child_rss(cmd + [str(single)])
    # what the child holds before it reads a row: its imports
    t_base, rss_base = child_rss(
        ["-c", "import spotify_recommender_tpu_torch.cli, "
         "spotify_recommender_tpu_torch.data.streaming"])
    ref, cat = Catalog.load(str(single)), Catalog.load(str(stream))
    check(isinstance(cat.features, np.memmap), "streamed catalog not memmapped")
    for name in ("features", "norms", "genre_ids", "min_vals", "max_vals"):
        check(np.array_equal(getattr(cat, name), getattr(ref, name)),
              f"phase 19: streamed {name} differ from single-shot")
    for name in ("track_ids", "track_names", "artists"):
        check(np.array_equal(np.asarray(getattr(cat, name), np.str_),
                             np.asarray(getattr(ref, name), np.str_)),
              f"phase 19: streamed {name} differ from single-shot")
    check(cat.genre_names == ref.genre_names, "phase 19: genre names differ")
    # the CLI over the memory-mapped directory
    rows = np.random.default_rng(19).integers(0, ING_ROWS, 16)
    np.save(work / "q19.npy", cat.features[rows])
    t0 = time.perf_counter()
    run_cli(["--device", "cuda", "retrieve", str(work / "q19.npy"), "--catalog",
             str(stream), "-k", "10", "-o", str(work / "r19.npz")])
    f = torch.from_numpy(np.array(cat.features)).to(DEV)
    nrm = torch.from_numpy(np.array(cat.norms)).to(DEV)
    fs, fi = similarity.exact_topk_chunked(
        f[torch.from_numpy(rows).to(DEV)], f, nrm, k=10, fixed_order=True)
    with np.load(work / "r19.npz") as z:
        check(np.array_equal(z["rows"], fi.cpu().numpy())
              and np.array_equal(z["scores"], fs.cpu().numpy()),
              "phase 19: retrieve over the streamed dir is not the oracle's")
    del f, nrm
    out = run_cli(["--device", "cuda", "--id", "tid000042", "--catalog",
                   str(stream)])
    check_recommendations(out, cat, 42, 10)
    t_cli = time.perf_counter() - t0
    print(f"phase 19 ingest: {ING_ROWS} rows ({csv.stat().st_size / 2**20:.1f} "
          f"MiB CSV written in {t_csv:.1f} s); g++ build of the native parser "
          f"{gxx_s:.2f} s (phase 2, beside nvcc); parse native {t_nat:.2f} s vs "
          f"Python {t_py:.2f} s, tables equal; preprocess single-shot "
          f"{t_single:.1f} s (peak RSS {rss_single:.0f} MiB) vs --streaming "
          f"--chunk-rows {ING_CHUNK} {t_stream:.1f} s (peak RSS "
          f"{rss_stream:.0f} MiB), each a child process (its imports alone: "
          f"{t_base:.1f} s, {rss_base:.0f} MiB); the streamed dir-v1 "
          f"catalog bitwise the single-shot one; retrieve (16 queries) and "
          f"--id over the memory-mapped dir equal the fixed-order oracle "
          f"({t_cli:.1f} s); {time.perf_counter() - t19:.1f} s")


# ---------------------------------------------------------------- phase 20

SHARD_N = 10_000_000        # BASELINE config 4's catalog
SHARDS = 4                  # catalog shards on the one card


def scan_v3_plain_chunked(q2, ft, *, w, depth, topc, ncols, chunk=1 << 18):
    """`scan_v3_plain` in column chunks (multiples of w): each chunk's bin
    structures, merged in column order as the kernel's merge does (bitwise
    the single walk, ops/cuda/scan_v3.split_bin_structures)."""
    parts = []
    for c0 in range(0, ft.shape[1], chunk):
        dots = split_plane_dots(q2, ft[:, c0:c0 + chunk])
        dots[:, max(0, ncols - c0):] = float("-inf")
        sv, si, bnd = bin_structures(dots, w, depth)
        parts.append((sv, torch.where(si >= 0, si + c0, si), bnd))
        del dots
    return top_slots(*merge_bins(parts, depth), topc)


def sharded_phase(kernels: dict, launches: dict, work: Path) -> None:
    """Phase 20: the row-sharded catalog at BASELINE config 4's 10M x 12 on
    one card: a 4-shard catalog mesh over the one device (the Retriever's
    certified backend: kernels 2 and 1 per shard; kernel 3 per shard), a
    2-D data=2 x catalog=2 mesh, the sharded artifact and `from_artifact`,
    and `retrieve --catalog <sharded dir> --mesh catalog=1`; adds the
    sharded entries to the kernels line."""
    t20 = time.perf_counter()
    k, b = 10, 1024
    feats, norms, _, _ = benchmark._make_inputs(SHARD_N, 1, 12)
    ids = np.arange(SHARD_N).astype(np.str_)
    cat = Catalog(feats, norms, ids, ids, ids, np.zeros(SHARD_N, np.int32),
                  ["g"], np.zeros(11, np.float32), np.ones(11, np.float32))
    t0 = time.perf_counter()
    single = CertifiedRetriever(feats, norms, None, DEV)
    torch.cuda.synchronize()
    t_single_setup = time.perf_counter() - t0
    mesh4 = make_mesh(MeshConfig(catalog=SHARDS), devices=[DEV] * SHARDS)
    t0 = time.perf_counter()
    retriever = Retriever(cat, None, DEV, mesh=mesh4)
    torch.cuda.synchronize()
    t_shard_setup = time.perf_counter() - t0
    sc = retriever.sharded
    check(retriever.backend == "sharded" and sc.backend == "certified",
          f"phase 20: backend {retriever.backend} / {sc.backend}")
    n_local = sc.n_local
    rows = np.random.default_rng(20).integers(0, SHARD_N, size=b)
    # exclusions on and beside every shard border
    border = np.array([c * n_local + o for c in range(1, SHARDS) for o in (-1, 0)
                       if c * n_local + o < SHARD_N])
    rows[:border.size] = border
    queries = torch.from_numpy(feats[rows]).to(DEV)
    excl = torch.from_numpy(rows).to(DEV)
    ref_s, ref_i = single(queries, k, excl)
    single_fb, single_esc = single.fallbacks, single.escalations

    split_bf16x2.launches = scan_v3.launches = fused_topk.launches = 0
    s, i = retriever.retrieve(queries, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    n_split, n_scan = split_bf16x2.launches, scan_v3.launches
    check(n_split >= SHARDS and n_scan >= SHARDS and fused_topk.launches == 0,
          f"phase 20: sharded batch launches split {n_split}, scan {n_scan}")
    launches["split_bf16x2_sharded"] = n_split
    launches["scan_v3_sharded"] = n_scan
    fb, esc = sc.fallbacks, sc.escalations
    check(torch.equal(i, ref_i) and torch.equal(s, ref_s),
          "phase 20: sharded certified batch differs from the single-card "
          f"tier in {(i != ref_i).sum().item()} indices")
    check(not bool((i == excl[:, None]).any()), "phase 20: an excluded row "
          "was returned")
    s1, i1 = retriever.retrieve(queries[:1], k=k, exclude_rows=excl[:1])
    check(torch.equal(i1, ref_i[:1]) and torch.equal(s1, ref_s[:1]),
          "phase 20: sharded B=1 differs from the single-card tier")
    t_cert = wall_ms(lambda: retriever.retrieve(queries, k=k,
                                                exclude_rows=excl), 10)
    t_cert1 = wall_ms(lambda: retriever.retrieve(queries[:1], k=k,
                                                 exclude_rows=excl[:1]), 20)
    t_single = wall_ms(lambda: single(queries, k, excl), 10)
    t_single1 = wall_ms(lambda: single(queries[:1], k, excl[:1]), 20)
    _, prof_kernels, idle = profile_batch(
        lambda: retriever.retrieve(queries, k=k, exclude_rows=excl))

    # kernel 3 per shard: the Retriever's backend for a non-fp32 dtype
    pallas = Retriever(cat, RetrievalConfig(dtype="bfloat16"), DEV, mesh=mesh4)
    check(pallas.sharded.backend == "pallas", "phase 20: pallas backend")
    fused_topk.launches = 0
    ps, pi = pallas.retrieve(queries, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    launches["fused_topk_sharded"] = fused_topk.launches
    check(fused_topk.launches == SHARDS,
          f"phase 20: kernel 3 launched {fused_topk.launches} times")
    p_err, p_ties = compare_oracle(ps, pi, ref_s, ref_i, TOL_EXACT,
                                   "phase 20 pallas")
    t_pal = wall_ms(lambda: pallas.retrieve(queries, k=k, exclude_rows=excl), 10)
    t_pal1 = wall_ms(lambda: pallas.retrieve(queries[:1], k=k,
                                             exclude_rows=excl[:1]), 20)

    # kernels at the sharded path's shapes (shard 0: n_local columns)
    shard0 = sc._shards[(0, str(DEV))]
    dl = shard0.layout
    qn = similarity.row_norms(queries)
    qunit = queries / qn.clamp_min(1e-30)[:, None]
    hi, lo = split_bf16x2(qunit)
    phi, plo = split_bf16x2_plain(qunit)
    check(torch.equal(hi.view(torch.int16), phi.view(torch.int16))
          and torch.equal(lo.view(torch.int16), plo.view(torch.int16)),
          "phase 20: split kernel differs from plain")
    kernels["split_bf16x2_sharded"] = dict(
        source=f"{CSRC}/split_bf16x2.cu", replaces=f"{PALLAS}:237",
        max_abs_err=0.0, ms=sync_ms(lambda: split_bf16x2(qunit), 50),
        plain_ms=sync_ms(lambda: split_bf16x2_plain(qunit), 50),
        **bound(qunit.numel(), "fp32", qunit, hi, lo), library_ms=None,
    )
    q2 = torch.cat([hi, lo, lo, hi], dim=1)
    c_top = min(max(RetrievalConfig().prefilter, k), dl.depth * dl.w)
    kv, ki, kb = scan_v3(q2, dl.ft, w=dl.w, depth=dl.depth, topc=c_top,
                         ncols=shard0.num_items)
    t0 = time.perf_counter()
    pv, pi_, pb = scan_v3_plain_chunked(q2, dl.ft, w=dl.w, depth=dl.depth,
                                        topc=c_top, ncols=shard0.num_items)
    torch.cuda.synchronize()
    plain_scan_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(kv, pv) and torch.equal(ki, pi_) and torch.equal(kb, pb),
          "phase 20: kernel 1 at the shard's shape differs from plain")
    real = dl.ft[:, :shard0.num_items]
    kernels["scan_v3_sharded"] = dict(
        source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
        max_abs_err=0.0,
        ms=sync_ms(lambda: scan_v3(q2, dl.ft, w=dl.w, depth=dl.depth,
                                   topc=c_top, ncols=shard0.num_items), 10),
        plain_ms=plain_scan_ms,
        **bound(dot_flops(q2, real, q2.shape[1]), "bf16", q2, real, kv, ki, kb),
        library_ms=None,
    )
    fr0 = pallas.sharded._shards[(0, str(DEV))]
    # shard 0's frame: its exclusions, its valid count
    fargs = (queries, qn, fr0.features_t, fr0.norms,
             torch.where(excl < n_local, excl, -1), fr0.num_items)
    fkv, fki, f_err = compare_fused(fargs, k, True, "phase 20 kernel 3 shard 0")
    t0 = time.perf_counter()
    fused_topk_plain(*fargs, k=k, exact=True)
    torch.cuda.synchronize()
    plain_fused_ms = (time.perf_counter() - t0) * 1e3
    ft0 = fr0.features_t
    kernels["fused_topk_sharded"] = dict(
        source=f"{CSRC}/fused_topk.cu", replaces=f"{PALLAS}:52",
        max_abs_err=f_err,
        ms=sync_ms(lambda: fused_topk(*fargs, k=k, exact=True), 10),
        plain_ms=plain_fused_ms,
        **bound(dot_flops(queries, ft0, ft0.shape[0]), "fp32", *fargs[:5],
                fkv, fki),
        library_ms=sync_ms(lambda: torch.topk(torch.mm(queries, ft0), k), 10),
    )
    del hi, lo, phi, plo, q2, kv, ki, kb, pv, pi_, pb, real, pallas, fr0, ft0
    del fargs, fkv, fki
    torch.cuda.empty_cache()

    # the 2-D data x catalog mesh on the same card
    mesh22 = make_mesh(MeshConfig(data=2, catalog=2), devices=[DEV] * 4)
    sc22 = ShardedCatalog(feats, norms, mesh22, use_certified=True,
                          data_axis="data")
    s22, i22 = sc22.retrieve(queries, k, excl)
    check(torch.equal(i22, ref_i) and torch.equal(s22, ref_s),
          "phase 20: 2-D mesh differs from the single-card tier")
    t_22 = wall_ms(lambda: sc22.retrieve(queries, k, excl), 10)
    fb22 = sc22.fallbacks
    del sc22
    torch.cuda.empty_cache()

    # the sharded artifact at 10M, from_artifact, and the CLI on it
    art_dir = work / "sharded_10m"
    t0 = time.perf_counter()
    save_sharded_catalog(cat, str(art_dir))
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = load_sharded_catalog(str(art_dir), mesh4)
    sca = ShardedCatalog.from_artifact(art, mesh4)
    torch.cuda.synchronize()
    t_art = time.perf_counter() - t0
    sa, ia = sca.retrieve(queries, k, excl)
    check(torch.equal(ia, ref_i) and torch.equal(sa, ref_s),
          "phase 20: from_artifact differs from the single-card tier")
    del sca
    torch.cuda.empty_cache()
    q8 = feats[rows[:8]]
    np.save(work / "q20.npy", q8)
    t0 = time.perf_counter()
    run_cli(["--device", "cuda", "retrieve", str(work / "q20.npy"), "--catalog",
             str(art_dir), "--mesh", "catalog=1", "-k", str(k), "-o",
             str(work / "r20.npz")])
    t_cli = time.perf_counter() - t0
    es, ei = single(q8, k)
    with np.load(work / "r20.npz") as z:
        check(np.array_equal(z["rows"], ei.cpu().numpy())
              and np.array_equal(z["scores"], es.cpu().numpy())
              and list(z["track_ids"][0]) == [str(r) for r in ei[0].tolist()],
              "phase 20: retrieve on the sharded dir differs")
    del single, retriever
    torch.cuda.empty_cache()
    print(f"phase 20 sharded serving: N={SHARD_N} x 12, {SHARDS} catalog shards "
          f"on one card ({n_local} rows each), B={b} k={k} with exclusions at "
          f"the shard borders: certified backend bitwise the single-card "
          f"certified tier (B={b} and B=1), launches split {n_split} scan "
          f"{n_scan}; per batch fallbacks {fb} escalations {esc} summed over "
          f"shards (single card {single_fb} / {single_esc}); batch "
          f"{t_cert:.3f} ms, B=1 {t_cert1:.3f} ms vs the single-card tier "
          f"{t_single:.3f} ms, B=1 {t_single1:.3f} ms; profile of a sharded "
          f"batch: device idle share {idle:.3f}, "
          + ", ".join(f"{nm} {ms:.4g}" for nm, ms in
                      list(prof_kernels.items())[:4]) + " ms; "
          f"pallas backend (kernel 3 per shard, {launches['fused_topk_sharded']}"
          f" launches) max score diff {p_err:.3g}, {p_ties} near-tie positions "
          f"differ, batch {t_pal:.3f} ms, B=1 {t_pal1:.3f} ms; 2-D data=2 x "
          f"catalog=2 bitwise, batch {t_22:.3f} ms, fallbacks {fb22}; "
          f"save_sharded_catalog {t_save:.1f} s, load + from_artifact "
          f"{t_art:.1f} s, bitwise; retrieve --catalog <sharded dir> --mesh "
          f"catalog=1 {t_cli:.1f} s, equal; set-up single {t_single_setup:.1f}"
          f" s, sharded {t_shard_setup:.1f} s; "
          f"{time.perf_counter() - t20:.1f} s")


# ---------------------------------------------------------------- phase 21

EMB_N, EMB_D = 10_000_000, 64   # BASELINE config 4's item table, fp32
TUNE_N, TUNE_B = 1_000_000, 1024  # the autotuner's shape: the headline's


def embedding_part(mesh4) -> str:
    """Config 4's row-sharded table over `mesh4`: lookups bitwise the dense
    gather, the range check, the backward against a dense index_add."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    dense = torch.rand((EMB_N, EMB_D), generator=gen, device=DEV)
    table = ShardedEmbeddingTable(dense, mesh4)
    check(len(table.shards) == SHARDS and all(
        sh.data_ptr() == dense[c * (EMB_N // SHARDS)].data_ptr()
        for c, sh in enumerate(table.shards)), "phase 21: shards are not views")
    rng = np.random.default_rng(21)
    block = rng.integers(0, EMB_N, (1024, 50))
    lens = rng.integers(1, 51, 1024)
    block[np.arange(50)[None, :] >= lens[:, None]] = 0     # padded-ragged
    parts = []
    for name, ids in (("1024", rng.integers(0, EMB_N, 1024)),
                      ("1024x50", block),
                      ("65536", rng.integers(0, EMB_N, 65536))):
        ids = torch.from_numpy(ids).to(DEV)
        out = table.lookup(ids)
        check(torch.equal(out, dense[ids]),
              f"phase 21: lookup of {name} ids is not the dense gather")
        ms = sync_ms(lambda: table.lookup(ids, validate=False), 20)
        ms_val = wall_ms(lambda: table.lookup(ids), 20)
        dense_ms = sync_ms(lambda: dense[ids], 20)
        nbytes = ids.numel() * ids.element_size() + out.numel() * 4
        parts.append(f"{name}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s; "
                     f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms by "
                     f"bytes), with the range check {ms_val:.4f} ms, dense "
                     f"gather {dense_ms:.4f} ms")
    try:
        table.lookup(torch.tensor([0, EMB_N], device=DEV))
        check(False, "phase 21: an out-of-range id did not raise")
    except IndexError:
        pass
    # the backward: the shards' gradients against one dense index_add
    ids = torch.randperm(EMB_N, generator=gen, device=DEV)[:65536]
    up = torch.randn((ids.numel(), EMB_D), generator=gen, device=DEV)
    for sh in table.shards:
        sh.requires_grad_(True)
    bwd_ms = []
    for _ in range(2):                    # the first call allocates
        for sh in table.shards:
            sh.grad = None
        t0 = time.perf_counter()
        (table.lookup(ids, validate=False) * up).sum().backward()
        torch.cuda.synchronize()
        bwd_ms.append((time.perf_counter() - t0) * 1e3)
    want = torch.zeros_like(dense).index_add_(0, ids, up)
    rows = EMB_N // SHARDS
    check(all(torch.equal(sh.grad, want[c * rows:(c + 1) * rows])
              for c, sh in enumerate(table.shards)),
          "phase 21: lookup gradient differs from the dense index_add")
    del table, dense, want, up
    torch.cuda.empty_cache()
    return (f"table {EMB_N} x {EMB_D} fp32 over {SHARDS} shards on one card: "
            f"lookups bitwise the dense gather, " + "; ".join(parts)
            + f"; out-of-range id raises IndexError; backward of 65536 ids "
            f"{bwd_ms[1]:.2f} ms ({bwd_ms[0]:.1f} the first call), bitwise a "
            "dense index_add on the owners' rows")


def als_part(kernels: dict, launches: dict, mesh4) -> Tuple[str, dict]:
    """Sharded ALS at config 3 on `mesh4` against the single-device run,
    then the shard_tables item factors through the sharded certified tier
    (the "*_mf_sharded" entries)."""
    data = als_scale_1m.prepare(MF_USERS, MF_ITEMS, MF_PER_USER)
    train, item_view = data["train"], data["item_view"]
    cfg = MFConfig(embedding_dim=64, num_iterations=3, reg=0.05, alpha=10.0)
    runs = {}
    for name, kw in (("single", {"device": DEV}),
                     ("replicated", {"mesh": mesh4}),
                     ("shard_tables", {"mesh": mesh4, "shard_tables": True})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        u, i = mf.train_als(train, cfg, item_view=item_view, stats=stats, **kw)
        per_iter = [a + b for a, b in zip(stats["user_ms"], stats["item_ms"])]
        runs[name] = (u, i, statistics.median(per_iter),
                      torch.cuda.max_memory_allocated() / 2**30,
                      statistics.median(stats["chol_ms"]))
    su, si = runs["single"][:2]
    errs = {}
    for name, tol in (("replicated", 1e-5), ("shard_tables", 1e-4)):
        u, i = runs[name][:2]
        check(u.shape == su.shape and i.shape == si.shape,
              f"phase 21: {name} factor shapes {u.shape} {i.shape}")
        errs[name] = float(max(np.abs(u - su).max(), np.abs(i - si).max()))
        check(errs[name] <= tol, f"phase 21: {name} ALS differs from the "
              f"single device by {errs[name]} (> {tol})")

    # the shard_tables item factors, served by the sharded certified tier
    users, items = runs["shard_tables"][:2]
    k, b = 10, 1024
    q = torch.from_numpy(users[np.random.default_rng(21).choice(
        len(users), b, replace=False)]).to(DEV)
    single = CertifiedRetriever(items, None, None, DEV)
    ref_s, ref_i = single(q, k)
    sc = ShardedCatalog(items, None, mesh4, use_certified=True)
    split_bf16x2.launches = scan_v3.launches = 0
    s, i = sc.retrieve(q, k)
    torch.cuda.synchronize()
    launches["split_bf16x2_mf_sharded"] = split_bf16x2.launches
    launches["scan_v3_mf_sharded"] = scan_v3.launches
    check(split_bf16x2.launches >= SHARDS and scan_v3.launches >= SHARDS,
          f"phase 21: sharded MF batch launches split {split_bf16x2.launches}"
          f", scan {scan_v3.launches}")
    check(torch.equal(i, ref_i) and torch.equal(s, ref_s),
          "phase 21: the sharded tier's answers over the sharded-ALS items "
          f"differ from the single card's in {(i != ref_i).sum().item()} "
          "indices")
    t_sh = wall_ms(lambda: sc.retrieve(q, k), 10)
    t_single = wall_ms(lambda: single(q, k), 10)

    # kernels 2 and 1 at shard 0's shapes against their plain versions
    shard0 = sc._shards[(0, str(DEV))]
    dl = shard0.layout
    qunit = q / similarity.row_norms(q).clamp_min(1e-30)[:, None]
    hi, lo = split_bf16x2(qunit)
    phi, plo = split_bf16x2_plain(qunit)
    check(torch.equal(hi.view(torch.int16), phi.view(torch.int16))
          and torch.equal(lo.view(torch.int16), plo.view(torch.int16)),
          "phase 21: split kernel differs from plain")
    kernels["split_bf16x2_mf_sharded"] = dict(
        source=f"{CSRC}/split_bf16x2.cu", replaces=f"{PALLAS}:237",
        max_abs_err=0.0, ms=sync_ms(lambda: split_bf16x2(qunit), 50),
        plain_ms=sync_ms(lambda: split_bf16x2_plain(qunit), 50),
        **bound(qunit.numel(), "fp32", qunit, hi, lo), library_ms=None,
    )
    q2 = torch.cat([hi, lo, lo, hi], dim=1)
    c_top = min(max(RetrievalConfig().prefilter, k), dl.depth * dl.w)
    n0 = shard0.num_items
    err, _, (kv, ki, kb) = compare_scan(q2, dl.ft, dl.depth, c_top, w=dl.w,
                                        ncols=n0)
    real = dl.ft[:, :n0]
    kernels["scan_v3_mf_sharded"] = dict(
        source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
        max_abs_err=err,
        ms=sync_ms(lambda: scan_v3(q2, dl.ft, w=dl.w, depth=dl.depth,
                                   topc=c_top, ncols=n0), 20),
        plain_ms=sync_ms(lambda: scan_v3_plain(q2, dl.ft, w=dl.w,
                                               depth=dl.depth, topc=c_top,
                                               ncols=n0), 3),
        **bound(dot_flops(q2, real, q2.shape[1]), "bf16", q2, real, kv, ki,
                kb),
        library_ms=None,
    )
    per = {name: r[2] for name, r in runs.items()}
    peak = {name: r[3] for name, r in runs.items()}
    chol = {name: r[4] for name, r in runs.items()}
    line = (f"sharded ALS (config 3, d 64, 3 iterations, catalog={SHARDS} on "
            f"one card): ms per iteration (Cholesky inside) single "
            f"{per['single']:.2f} ({chol['single']:.2f}), replicated "
            f"{per['replicated']:.2f} ({chol['replicated']:.2f}), "
            f"shard_tables {per['shard_tables']:.2f} "
            f"({chol['shard_tables']:.2f}); peak GiB {peak['single']:.2f} / "
            f"{peak['replicated']:.2f} / {peak['shard_tables']:.2f}; factors "
            f"vs single: replicated {errs['replicated']:.3g}, shard_tables "
            f"{errs['shard_tables']:.3g}; shard_tables items "
            f"({MF_ITEMS} x 64) through {SHARDS} certified shards, {b} user "
            f"queries k={k}: bitwise the single card, batch {t_sh:.3f} ms vs "
            f"{t_single:.3f} ms, fallbacks {sc.fallbacks} / "
            f"{single.fallbacks}, launches split "
            f"{launches['split_bf16x2_mf_sharded']} scan "
            f"{launches['scan_v3_mf_sharded']}")
    del single, sc
    torch.cuda.empty_cache()
    return line, {"train": train, "item_view": item_view}


def dp_part(data: dict, catalog_path: str, work: Path) -> str:
    """Data-parallel SGD (config 3) and two-tower steps (config 5) on a
    data=4 mesh over the one card, against the single-device runs; then the
    CLI's mesh options on the card."""
    dmesh = make_mesh(MeshConfig(data=SHARDS), devices=[DEV] * SHARDS)
    train = data["train"]
    sgd_cfg = MFConfig(embedding_dim=64, reg=0.05, alpha=10.0,
                       learning_rate=0.01)
    trace, ms = {}, {}
    for name, kw in (("single", {"device": DEV}), ("dp", {"mesh": dmesh})):
        mf.train_sgd(train, sgd_cfg, num_steps=2, **kw)     # warm-up
        trace[name] = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mf.train_sgd(train, sgd_cfg, num_steps=200, losses=trace[name], **kw)
        ms[name] = (time.perf_counter() - t0) * 1e3 / 200
    a, b = np.asarray(trace["dp"]), np.asarray(trace["single"])
    sgd_gap = float(np.max(np.abs(a[:20] - b[:20]) / np.abs(b[:20])))
    check(sgd_gap <= 1e-5, f"phase 21: DP SGD's first 20 losses differ from "
          f"the single device's by {sgd_gap} (relative)")
    check(np.mean(a[-20:]) < np.mean(a[:20]),
          f"phase 21: DP SGD loss did not fall: {a[:3]} ... {a[-3:]}")

    # the first step on the same pairs: its gradients (what data
    # parallelism must preserve; Adam's first step divides each by its own
    # magnitude + 1e-8, so a coordinate whose gradient is near 1e-8 turns
    # rounding into a step of up to lr, and the parameters are reported)
    cat5 = Catalog.load(catalog_path)
    cfg = TwoTowerConfig()
    first = {}
    for name, mesh in (("single", None), ("dp", dmesh)):
        model = two_tower.make_model(two_tower.init_params(
            cfg, cat5.features.shape[1], torch.Generator().manual_seed(0)),
            cfg, DEV)
        opt = two_tower.make_optimizer(model, cfg)
        q, i = two_tower.same_genre_pairs(cat5.features, cat5.genre_ids,
                                          cfg.batch_size,
                                          np.random.default_rng(0))
        loss = two_tower.train_step(model, opt, torch.from_numpy(q).to(DEV),
                                    torch.from_numpy(i).to(DEV),
                                    cfg.temperature, mesh)
        first[name] = (float(loss), dict(model.named_parameters()))
    g_gap = max((first["dp"][1][n].grad - p.grad).abs().max().item()
                for n, p in first["single"][1].items())
    p_gap = max((first["dp"][1][n] - p).abs().max().item()
                for n, p in first["single"][1].items())
    f_gap = abs(first["dp"][0] - first["single"][0])
    check(g_gap <= 1e-6 and f_gap <= 1e-6, f"phase 21: DP two-tower first "
          f"step: gradients differ by {g_gap}, losses by {f_gap}")
    del first, model, opt
    cfg = TwoTowerConfig(num_steps=200)
    tt = {}
    for name, kw in (("single", {"device": DEV}), ("dp", {"mesh": dmesh})):
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        two_tower.train(cat5.features, cat5.genre_ids, cfg, stats=st, **kw)
        tt[name] = (st, (time.perf_counter() - t0) * 1e3 / 200)
    gaps = np.abs(np.asarray(tt["dp"][0]["loss"])
                  - np.asarray(tt["single"][0]["loss"]))
    l20, l_gap = float(gaps[:20].max()), float(gaps.max())
    # Adam amplifies the slices' rounding from step to step (200 steps:
    # 2.8e-4 apart on the CPU, 3.3e-3 on the card): the first 20 losses
    # within 1e-5, the last 20 steps' means within 1e-2
    tail = abs(np.mean(tt["dp"][0]["loss"][-20:])
               - np.mean(tt["single"][0]["loss"][-20:]))
    check(l20 <= 1e-5 and tail <= 1e-2, f"phase 21: DP two-tower losses "
          f"differ by {l20} (first 20), the last 20 steps' means by {tail}")
    losses = tt["dp"][0]["loss"]
    check(losses[-1] < losses[0], f"phase 21: DP two-tower loss did not fall")

    # the CLI's mesh options on the card
    user, item, count = als_scale_1m.make_clustered(5000, 2000, 20)
    inter = work / "inter21.csv"
    np.savetxt(inter, np.stack([user, item, count.astype(np.int64)], 1),
               fmt="%d", delimiter=",", header="user_id,item_id,count",
               comments="")
    t0 = time.perf_counter()
    out = run_cli(["--device", "cuda", "train-mf", str(inter), "-o",
                   str(work / "mf21.npz"), "--iterations", "3", "--mesh",
                   "catalog=1", "--shard-tables"])
    check("recall@10=" in out, f"train-mf --shard-tables: {out!r}")
    out += run_cli(["--device", "cuda", "train-two-tower", "--catalog",
                    catalog_path, "-o", str(work / "tt21"), "--steps", "20",
                    "--mesh", "data=1,catalog=1"])
    check("two-tower trained" in out, f"train-two-tower --mesh: {out!r}")
    cli_s = time.perf_counter() - t0
    mean = statistics.mean
    return (f"DP SGD (config 3, lr 0.01, batch 8192 = {SHARDS} x 2048, 200 "
            f"steps): {ms['dp']:.2f} ms per step vs single {ms['single']:.2f};"
            f" first 20 losses within {sgd_gap:.3g} (relative) of the single "
            f"device's, loss {a[0]:.3f} -> {a[-1]:.3f}; DP two-tower (config "
            f"5, batch 1024 = {SHARDS} x 256, 200 steps): first step's "
            f"gradients within {g_gap:.3g} (parameters {p_gap:.3g}), losses "
            f"within {l20:.3g} (first 20) and {l_gap:.3g} (200; the last 20 "
            f"steps' means {tail:.3g}), "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, ms per step (wall) "
            f"{tt['dp'][1]:.2f} vs single {tt['single'][1]:.2f} (device "
            f"{mean(tt['dp'][0]['step_ms'][1:]):.2f} vs "
            f"{mean(tt['single'][0]['step_ms'][1:]):.2f}, host pairs "
            f"{mean(tt['dp'][0]['pairs_ms']):.2f}); CLI train-mf --mesh "
            f"catalog=1 --shard-tables and train-two-tower --mesh "
            f"data=1,catalog=1 (20 steps) {cli_s:.1f} s")


def autotune_part(kernels: dict, launches: dict, work: Path) -> str:
    """`autotune.tune` at 1M x 1024 with the cache in the phase's work
    directory, each candidate's kernel 1, the benchmark reading the cache,
    the `autotune` subcommand, a profiler trace, `nan_guard`, and the graft
    entry points."""
    n, b, f, k = TUNE_N, TUNE_B, 12, 10
    cache = work / "autotune.json"
    os.environ["SRT_AUTOTUNE_CACHE"] = str(cache)
    try:
        split_bf16x2.launches = scan_v3.launches = 0
        t0 = time.perf_counter()
        res = autotune.tune(n=n, b=b, f=f, k=k, device=DEV)
        tune_s = time.perf_counter() - t0
        launches["scan_v3_autotune"] = scan_v3.launches
        check(scan_v3.launches > 0 and split_bf16x2.launches > 0,
              "phase 21: autotune launched no kernel")
        check(not res.failed and res.saved and cache.exists(),
              f"phase 21: autotune failures {res.failed}, saved {res.saved}")
        row = benchmark.run_benchmark(num_items=n, num_queries=b,
                                      feature_dim=f, k=k, backend="certified",
                                      device=DEV, verify_queries=64)
        d = row.details
        win = res.config
        check(d["autotuned"] and (d["scan_depth"], d["scan_escalate"],
                                  d["scan_bins"], d["catalog_tile"]) == (
            win.scan_depth, win.scan_escalate, win.scan_bins,
            win.catalog_tile), f"phase 21: the benchmark ran {d}, the cache "
              f"holds {win}")
        paths = [str(Path(__file__).resolve().parent),
                 os.environ.get("PYTHONPATH", "")]
        env = {**os.environ, "SRT_AUTOTUNE_CACHE": str(work / "at_cli.json"),
               "PYTHONPATH": os.pathsep.join(p for p in paths if p)}
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "spotify_recommender_tpu_torch", "autotune",
             "--items", str(n), "--queries", str(b)],
            capture_output=True, text=True, env=env, timeout=600)
        cli_s = time.perf_counter() - t0
        check(out.returncode == 0 and "autotuned n=1000000" in out.stdout
              and (work / "at_cli.json").exists(),
              f"phase 21: autotune subcommand: {out.stdout[-500:]} "
              f"{out.stderr[-500:]}")
    finally:
        os.environ.pop("SRT_AUTOTUNE_CACHE")

    # each candidate's kernel 1 at its (W, depth), on the tune's inputs
    feats, norms, queries, q_rows = benchmark._make_inputs(n, b, f)
    q = torch.from_numpy(queries).to(DEV)
    q2 = split_queries(q)
    per_cand, layouts = [], {}
    for cand in res.candidates:
        cfg = RetrievalConfig(**{nm: cand[nm] for nm in autotune._TUNED})
        key = (cand["scan_bins"], cand["catalog_tile"])
        if key not in layouts:
            layouts[key] = layout_to_device(
                build_certified_layout(feats, norms, cfg), DEV)
        dl, depth = layouts[key], cand["scan_depth"]
        c_top = min(max(cfg.prefilter, k), depth * dl.w)
        k1 = sync_ms(lambda: scan_v3(q2, dl.ft, w=dl.w, depth=depth,
                                     topc=c_top, ncols=n), 10)
        per_cand.append(
            f"d{depth}/e{cand['scan_escalate']}/W{dl.w}/"
            f"tq{cand['query_tile']}/tc{cand['catalog_tile']}: batch "
            f"{cand['ms']:.3f} ms (bitwise the oracle), kernel 1 {k1:.3f} ms")
    dl = layout_to_device(build_certified_layout(feats, norms, win), DEV)
    c_top = min(max(win.prefilter, k), dl.depth * dl.w)
    err, _, (kv, ki, kb) = compare_scan(q2, dl.ft, dl.depth, c_top, w=dl.w,
                                        ncols=n)
    real = dl.ft[:, :n]
    kernels["scan_v3_autotune"] = dict(
        source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
        max_abs_err=err,
        ms=sync_ms(lambda: scan_v3(q2, dl.ft, w=dl.w, depth=dl.depth,
                                   topc=c_top, ncols=n), 10),
        plain_ms=sync_ms(lambda: scan_v3_plain(
            q2, dl.ft, w=dl.w, depth=dl.depth, topc=c_top, ncols=n), 1),
        **bound(dot_flops(q2, real, q2.shape[1]), "bf16", q2, real, kv, ki,
                kb),
        library_ms=None,
    )
    del layouts, kv, ki, kb, real

    # a profiler trace of one certified batch, with its annotate span
    excl = torch.from_numpy(q_rows).long().to(DEV)
    cr = CertifiedRetriever(feats, norms, win, DEV)
    cr(q, k, excl)
    tdir = work / "trace21"
    with profiling.trace(str(tdir)) as prof:
        with profiling.annotate("certified_batch"):
            cr(q, k, excl)
    files = list(tdir.glob("*.pt.trace.json"))
    events = (json.loads(files[0].read_text())["traceEvents"]
              if len(files) == 1 else [])
    spans = sum(e.get("name") == "certified_batch" for e in events)
    file_k1 = sum(e.get("cat") == "kernel" and "scan_kernel" in e.get("name", "")
                  for e in events)
    prof_k1 = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  and "scan_kernel" in e.key for e in prof.key_averages())
    # the span is the contract; the kernels' events are reported (CUPTI
    # decides whether a profiler run sees them)
    check(spans > 0, f"phase 21: trace files {files}: {spans} "
          f"certified_batch spans, {file_k1} kernel-1 events; the "
          f"profiler's own record {prof_k1} kernel-1 entries")
    t_med, _ = profiling.timed(cr, q, k, excl, iters=10)
    # nan_guard raises at an injected NaN on the card
    x = torch.tensor([1.0, 0.0], device=DEV)
    try:
        with debug.nan_guard():
            (x * 2).sum()
            x / x
        check(False, "phase 21: nan_guard did not raise")
    except FloatingPointError:
        pass

    # the graft entry points on the card
    split_bf16x2.launches = scan_v3.launches = 0
    fn, args = graft_entry.entry(DEV)
    gs, gi = fn(*args)
    check(scan_v3.launches > 0 and split_bf16x2.launches > 0,
          "phase 21: entry() launched no kernel")
    rs, ri = CertifiedRetriever(
        args[3].cpu().numpy(), None, RetrievalConfig(scan_bins=256,
                                                     prefilter=32), DEV)(
        args[0], 10, args[6])
    check(torch.equal(gi, ri) and torch.equal(gs, rs),
          "phase 21: entry() differs from the certified tier")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(SHARDS, DEV)
    dry_s = time.perf_counter() - t0
    return (f"autotune at {n} x {b}: {len(res.candidates)} candidates in "
            f"{tune_s:.1f} s (" + "; ".join(per_cand) + f"), winner "
            f"d{win.scan_depth}/e{win.scan_escalate}/W{win.scan_bins}/"
            f"tc{win.catalog_tile} {res.ms:.3f} ms, cache in the phase's "
            f"directory; benchmark row read it (autotuned, "
            f"{d['batch_latency_ms']} ms, {row.value} q/s); autotune "
            f"subcommand {cli_s:.1f} s; profiling.trace of one batch: "
            f"{files[0].stat().st_size} bytes, {len(events)} events, {spans} "
            f"span(s), {file_k1} kernel-1 events in the file ({prof_k1} in "
            f"the profiler's record), "
            f"timed {t_med * 1e3:.3f} ms; nan_guard raised at the NaN; "
            f"graft entry() bitwise the certified tier, "
            f"dryrun_multichip({SHARDS}) over [cuda:0] x {SHARDS} "
            f"{dry_s:.1f} s")


def training_phase(kernels: dict, launches: dict, work: Path,
                   catalog_path: str) -> None:
    """Phase 21: config 4's row-sharded embedding table, sharded ALS and
    the data-parallel steps on a 4-cell mesh over the one card, the
    autotuner, profiling, debug and the graft entry points."""
    t21 = time.perf_counter()
    mesh4 = make_mesh(MeshConfig(catalog=SHARDS), devices=[DEV] * SHARDS)
    emb = embedding_part(mesh4)
    als, data = als_part(kernels, launches, mesh4)
    dp = dp_part(data, catalog_path, work)
    del data
    torch.cuda.empty_cache()
    rest = autotune_part(kernels, launches, work)
    torch.cuda.empty_cache()
    print(f"phase 21 sharded training and the last modules: {emb}; {als}; "
          f"{dp}; {rest}; {time.perf_counter() - t21:.1f} s")


def main() -> None:
    kernels = {}

    # ---- 1. environment
    info = device_info(DEV)
    kind, count = info.device_kind, info.num_devices
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    smi = nvidia_smi("name,power.limit").splitlines()[0]
    print(f"phase 1 environment: {kind} x{count}, torch {torch.__version__}, "
          f"torch.version.cuda {info.cuda_version}, nvcc {nvcc!r}, "
          f"power limit {info.power_limit}, nvidia-smi {smi!r}")

    # ---- 2. build: the serving and the experiment library, side by side
    def build(lib):
        t = time.perf_counter()
        path = _build.build(lib)
        _build.library(lib)
        return path, time.perf_counter() - t

    def build_parser():
        # a cold build into a scratch root (the package's _build/ may hold
        # one already), then the package's own
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            native_ingest.build(Path(tmp))
            secs = time.perf_counter() - t
        native_ingest.library()
        return secs

    with concurrent.futures.ThreadPoolExecutor(len(_build.LIBRARIES) + 1) as pool:
        jobs = {lib.name: pool.submit(build, lib) for lib in _build.LIBRARIES}
        gxx_job = pool.submit(build_parser)
        built = {name: job.result() for name, job in jobs.items()}
        gxx_s = gxx_job.result()
    line, fused_regs = [], []
    for lib in _build.LIBRARIES:
        path, secs = built[lib.name]
        reports = ptxas_reports((path.parent / _build.LOG_NAME).read_text())
        regs = [r for _, r, _ in reports]
        spills = [f"{nm} {sp}" for nm, _, sp in reports if sp]
        line.append(f"{path.name} ({len(lib.sources)} sources) in {secs:.1f} s, "
                    f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                    + (f"spill stores in {', '.join(spills)}" if spills
                       else "no spill stores"))
        fused_regs += [(nm, r, sp) for nm, r, sp in reports
                       if nm.startswith("fused_partial_kernel")]
    check(len(fused_regs) == 9 and not any(sp for *_, sp in fused_regs),
          f"kernel 3's instances: {fused_regs} (9 expected, none spilling)")
    print("phase 2 build (both libraries and the native csv parser at "
          "once): " + "; ".join(line) + f"; {native_ingest.LIB_NAME} (g++) in "
          f"{gxx_s:.1f} s"
          + "; kernel 3 (fused_partial_kernel<KPL,EXACT>) registers: "
          + ", ".join(f"{nm} {r}" for nm, r, _ in fused_regs) + ", no spill")

    # ---- 3. split: kernel vs plain, bitwise
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 12)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[:16] *= np.float32(1e-30)              # tiny rows (subnormal lo values)
    x[16:24] = 0.0                           # zero rows
    xt = torch.from_numpy(x).to(DEV)
    hi, lo = split_bf16x2(xt)
    phi, plo = split_bf16x2_plain(xt)
    torch.cuda.synchronize()
    check(torch.equal(hi.view(torch.int16), phi.view(torch.int16))
          and torch.equal(lo.view(torch.int16), plo.view(torch.int16)),
          "split kernel is not bitwise equal to its plain version")
    res = (hi[24:].float() + lo[24:].float() - xt[24:]).abs().max().item()
    check(res <= 3.9e-6, f"split residual {res} on unit rows")
    print(f"phase 3 split: (4096, 12) bitwise equal to plain; max |hi+lo-x| on "
          f"unit rows {res:.3g}")

    # ---- 4. scan: kernel vs plain, and the BF16X2_EPS bound
    n4, b4 = 262_147, 64
    feats4 = rng.random((n4, 12), dtype=np.float32)
    dl4 = layout_to_device(build_certified_layout(feats4, None, RetrievalConfig()), DEV)
    q4 = torch.from_numpy(feats4[rng.integers(0, n4, b4)]).to(DEV)
    q4 += 0.01 * torch.from_numpy(rng.standard_normal((b4, 12)).astype(np.float32)).to(DEV)
    q2 = split_queries(q4)
    exact = similarity.cosine_scores_batched(
        q4, torch.from_numpy(feats4).to(DEV))
    line = []
    for depth in (2, 3):
        err, bitwise, (kv, ki, _) = compare_scan(q2, dl4.ft, depth, 32)
        eps_err = (kv - torch.gather(exact, 1, ki.long())).abs().max().item()
        check(eps_err <= BF16X2_EPS, f"scan approx error {eps_err} > BF16X2_EPS")
        line.append(f"depth {depth}: max err {err:.3g} (bitwise {bitwise}), "
                    f"max |approx-exact| {eps_err:.3g}")
    print(f"phase 4 scan: N={n4} B={b4} C=32; " + "; ".join(line)
          + f"; BF16X2_EPS {BF16X2_EPS}")
    del exact, dl4

    # ---- 5. CLI at the reference dataset's scale (114,000 rows, 114 genres);
    # its catalog stays for phase 18
    work = tempfile.TemporaryDirectory()
    csv = Path(work.name) / "songs.csv"
    n_rows = 114_000
    make_songs_csv(csv, n_rows, 114, seed=1)
    catalog = str(Path(work.name) / "songs_catalog.npz")
    t0 = time.perf_counter()
    out = run_cli(["--device", "cuda", "preprocess", str(csv), "-o", catalog])
    check(f"Valid songs: {n_rows}" in out and "Unique genres: 114" in out,
          "preprocess summary")
    t_pre = time.perf_counter() - t0
    cat = Catalog.load(catalog)
    t0 = time.perf_counter()
    out = run_cli(["--device", "cuda", "--song", "Song 4242", "-n", "5",
                   "--catalog", catalog])
    check_recommendations(out, cat, 4242, 5)
    out = run_cli(["--device", "cuda", "--id", "tid000042", "--catalog",
                   catalog])
    check_recommendations(out, cat, 42, 10)
    t_rec = time.perf_counter() - t0
    print(f"phase 5 cli: preprocess {n_rows} rows in {t_pre:.1f} s; --song and "
          f"--id equal the fixed-order oracle on the card ({t_rec:.1f} s for "
          "both)")

    # ---- 6. main path at benchmark size
    n, b, k = 1_000_000, 1024, 10
    rng0 = np.random.default_rng(0)               # benchmark.py _make_inputs
    feats = rng0.random((n, 12), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    rows = rng0.integers(0, n, size=b)
    ids = np.asarray([f"t{i}" for i in range(n)], dtype=object)
    cat = Catalog(feats, norms, ids, ids, ids, np.zeros(n, np.int32), ["g"],
                  np.zeros(11, np.float32), np.ones(11, np.float32))
    t0 = time.perf_counter()
    retriever = Retriever(cat, None, DEV)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    cr = retriever.certified
    queries = torch.from_numpy(feats[rows]).to(DEV)
    excl = torch.from_numpy(rows).to(DEV)

    split_bf16x2.launches = 0
    scan_v3.launches = 0
    s, i = retriever.retrieve(queries, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    launches = {"split_bf16x2": split_bf16x2.launches,
                "scan_v3": scan_v3.launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path did not launch: {launches}")
    fallbacks, escalations = cr.fallbacks, cr.escalations
    launches["scan_v3_rescan"] = scan_v3.launches - 1   # after the first scan

    f_dev = torch.from_numpy(feats).to(DEV)
    n_dev = torch.from_numpy(norms).to(DEV)
    fixed = similarity.exact_topk_chunked(queries, f_dev, n_dev,
                                          exclude_rows=excl, k=k,
                                          fixed_order=True)
    rs, ri = similarity.exact_topk_chunked(queries, f_dev, n_dev,
                                           exclude_rows=excl, k=k)
    torch.cuda.synchronize()
    score_err, ties = check_certified(s, i, fixed, (rs, ri), "v3 batch")
    check(fallbacks <= 15, f"v3: {fallbacks} oracle fallbacks in a batch")

    batch_ms = wall_ms(lambda: retriever.retrieve(queries, k=k, exclude_rows=excl), 20)
    plain_batch_ms = wall_ms(lambda: similarity.exact_topk_chunked(
        queries, f_dev, n_dev, exclude_rows=excl, k=k), 5)
    q1, e1 = queries[:1], excl[:1]
    split_bf16x2.launches = scan_v3.launches = 0
    retriever.retrieve(q1, k=k, exclude_rows=e1)
    torch.cuda.synchronize()
    launches["scan_v3_b1"] = scan_v3.launches
    check(split_bf16x2.launches > 0 and scan_v3.launches > 0,
          "B=1: a kernel of the main path did not launch")
    b1_ms = wall_ms(lambda: retriever.retrieve(q1, k=k, exclude_rows=e1), 20)
    prof_ms, prof_kernels, idle = profile_batch(
        lambda: retriever.retrieve(queries, k=k, exclude_rows=excl))
    print(f"phase 6 main path: N={n} B={b} k={k}: {b * k} of {b * k} indices "
          f"and scores bitwise the fixed-order oracle's on the card; vs the "
          f"cuBLAS oracle max score diff {score_err:.3g}, {ties} near-tie "
          f"positions differ; per batch: fallbacks {fallbacks}, escalations "
          f"{escalations}; launches {launches}; batch {batch_ms:.3f} ms median "
          f"of 20 ({b / batch_ms * 1e3:.0f} q/s); plain path (oracle "
          f"exact_topk_chunked) {plain_batch_ms:.3f} ms; B=1 latency "
          f"{b1_ms:.3f} ms; setup {t_setup:.1f} s; profile of a batch "
          f"({prof_ms:.3f} ms wall, device idle share {idle:.3f}): "
          + (", ".join(f"{nm} {ms:.4g}" for nm, ms in prof_kernels.items())
             or "no device time seen") + " ms; kernel 2's device time "
          + str(next((round(ms, 6) for nm, ms in prof_kernels.items()
                      if nm.startswith("split_bf16x2_kernel")), "not seen"))
          + " ms")

    # ---- kernels at the main path's shapes: vs plain, and timed
    qn = similarity.row_norms(queries)
    qunit = queries / qn.clamp_min(1e-30)[:, None]
    hi, lo = split_bf16x2(qunit)
    phi, plo = split_bf16x2_plain(qunit)
    check(torch.equal(hi.view(torch.int16), phi.view(torch.int16))
          and torch.equal(lo.view(torch.int16), plo.view(torch.int16)),
          "split kernel differs from plain at the main path's shape")
    split_err = max((hi.float() - phi.float()).abs().max().item(),
                    (lo.float() - plo.float()).abs().max().item())
    kernels["split_bf16x2"] = dict(
        source="spotify_recommender_tpu_torch/csrc/split_bf16x2.cu",
        replaces=f"{PALLAS}:237", max_abs_err=split_err,
        ms=sync_ms(lambda: split_bf16x2(qunit), 50),
        plain_ms=sync_ms(lambda: split_bf16x2_plain(qunit), 50),
        # one subtraction per element; three tensors moved
        **bound(qunit.numel(), "fp32", qunit, hi, lo), library_ms=None,
    )
    q2 = torch.cat([hi, lo, lo, hi], dim=1)
    ft = cr.layout.ft
    # kernel 1 at the batch's depth-2 scan, the depth-3 rescan of 32
    # queries and B = 1, over the catalog's n real columns as the tier
    # passes them: each bitwise its plain version, timed, bounded over the
    # real columns
    shapes = {"scan_v3": (q2, 2), "scan_v3_rescan": (q2[:32].contiguous(), 3),
              "scan_v3_b1": (q2[:1].contiguous(), 2)}
    real = ft[:, :n]
    for name, (qq, depth) in shapes.items():
        err, _, out = compare_scan(qq, ft, depth, 32, ncols=n)
        kernels[name] = dict(
            source="spotify_recommender_tpu_torch/csrc/scan_v3.cu",
            replaces=f"{PALLAS}:1069", max_abs_err=err,
            ms=sync_ms(lambda: scan_v3(qq, ft, w=128, depth=depth, topc=32,
                                       ncols=n), 20),
            plain_ms=sync_ms(lambda: scan_v3_plain(qq, ft, w=128, depth=depth,
                                                   topc=32, ncols=n), 3),
            **bound(dot_flops(qq, real, qq.shape[1]), "bf16", qq, real, *out),
            library_ms=None,
        )
    # the same batch scan over all Np columns (no ncols), timed in this run
    t_all_cols = sync_ms(lambda: scan_v3(q2, ft, w=128, depth=2, topc=32), 20)
    t_scan = {nm: kernels[nm]["ms"] for nm in shapes}
    check(t_scan["scan_v3_b1"] <= 0.1 * t_scan["scan_v3"]
          and t_scan["scan_v3_rescan"] <= 0.25 * t_scan["scan_v3"],
          f"the split does not pay: {t_scan}")
    print(f"kernels at main-path shapes: split {tuple(qunit.shape)} "
          f"{kernels['split_bf16x2']['ms']:.4f} ms vs plain "
          f"{kernels['split_bf16x2']['plain_ms']:.4f} ms; kernel 1 bitwise "
          f"equal to plain, ({b} x {ft.shape[1]}) depth 2 "
          f"{t_scan['scan_v3']:.3f} ms, the 32-query depth-3 rescan "
          f"{t_scan['scan_v3_rescan']:.4f} ms "
          f"({t_scan['scan_v3_rescan'] / t_scan['scan_v3']:.3f} of it), B=1 "
          f"{t_scan['scan_v3_b1']:.4f} ms "
          f"({t_scan['scan_v3_b1'] / t_scan['scan_v3']:.3f} of it), each over "
          f"the {n} real columns; the batch scan over all {ft.shape[1]} "
          f"columns (no ncols) {t_all_cols:.3f} ms; plain "
          + ", ".join(f"{nm} {kernels[nm]['plain_ms']:.1f}" for nm in shapes)
          + " ms")

    # ---- 7. kernel 3 at the main path's shapes, both modes
    unit = feats / np.maximum(norms, 1e-30)[:, None]      # FusedRetriever's
    modes = {
        True: (queries, f_dev.t().contiguous(), TOL_EXACT),
        False: (qunit, torch.from_numpy(np.ascontiguousarray(unit.T)).to(DEV),
                TOL_FAST),
    }
    line, fused_err, fused_times = [], 0.0, {}
    # the nearest PyTorch has to kernel 3: two calls, a product and a top-k,
    # on the prenormalized operands (TF32 off)
    lib_fp32 = sync_ms(lambda: torch.topk(torch.mm(qunit, modes[False][1]), k),
                       10)
    # a tie-heavy catalog: each query's own row copied to both sides of a
    # catalog split edge or of a warp's 32-column edge (columns e - 1 and
    # e), so its best scores tie across the edge
    split_cols = _splits(b, n, DEV)[1]
    edges = list(range(split_cols, n, split_cols))
    edges += sorted(rng0.choice(np.arange(32, n, 32), b - len(edges),
                                replace=False).tolist())
    at = torch.tensor(edges, device=DEV)
    dup = f_dev.clone()
    dup[at - 1] = dup[at] = queries
    n_dup = similarity.row_norms(dup)
    ties = {True: (queries, qn, dup.t().contiguous(), n_dup, excl, n),
            False: (qunit, qn, (dup / n_dup.clamp_min(1e-30)[:, None]).t()
                    .contiguous(), n_dup, excl, n)}
    del dup
    tie_top, k100 = {}, {}
    for exact, (qq, ft3, tol) in modes.items():
        args = (qq, qn, ft3, n_dev, excl, n)
        kv, ki, err = compare_fused(args, k, exact, f"fused exact={exact}")
        fused_err = max(fused_err, err)
        oerr, near = compare_oracle(kv, ki, rs, ri, tol, f"fused exact={exact}")
        k100[exact] = compare_fused(args, 100, exact,
                                    f"fused exact={exact} k=100")
        err100 = k100[exact][2]
        tv, _, err_t = compare_fused(ties[exact], k, exact,
                                      f"fused exact={exact}, tie-heavy")
        fused_err = max(fused_err, err100, err_t)
        # queries whose two best are equal values at two columns
        tie_top[exact] = int((tv[:, 0] == tv[:, 1]).sum().item())
        check(tie_top[exact] >= b // 2, f"tie-heavy: {tie_top[exact]} ties")
        t_k = sync_ms(lambda: fused_topk(*args, k=k, exact=exact), 20)
        t_p = sync_ms(lambda: fused_topk_plain(*args, k=k, exact=exact), 3)
        t_100 = sync_ms(lambda: fused_topk(*args, k=100, exact=exact), 10)
        t_1 = sync_ms(lambda: fused_topk(qq[:1], qn[:1], ft3, n_dev, excl[:1],
                                         n, k=k, exact=exact), 50)
        t_tie = sync_ms(lambda: fused_topk(*ties[exact], k=k, exact=exact), 10)
        fused_times[exact] = (t_k, t_p)
        if exact:          # exact products need fp32, outside the tensor cores
            fused_bound = bound(dot_flops(qq, ft3, ft3.shape[0]), "fp32",
                                *args[:5], kv, ki)
        line.append(
            f"exact={exact}: bitwise equal to plain at k={k}, k=100 and on "
            f"the tie-heavy catalog ({tie_top[exact]} queries tie at the top); "
            f"vs oracle max score diff {oerr:.3g}, {near} near-tie positions "
            f"differ; kernel {t_k:.3f} ms vs plain {t_p:.3f} ms; k=100 "
            f"{t_100:.3f} ms; B=1 {t_1:.4f} ms; tie-heavy {t_tie:.3f} ms")
    del ties
    kv, ki, _ = k100[True]
    rs100, ri100 = similarity.exact_topk_chunked(queries, f_dev, n_dev,
                                                 exclude_rows=excl, k=100)
    oerr100, ties100 = compare_oracle(kv, ki, rs100, ri100, TOL_EXACT, "k=100")
    small = (queries, qn, modes[True][1][:, :64], n_dev[:64], excl, 5)
    kv, ki, err2 = compare_fused(small, k, True, "fused, 5 valid columns")
    check(bool(((ki == -1).sum(dim=1) >= k - 5).all())
          and torch.equal(ki == -1, kv == float("-inf")),
          "unfilled slots are not (-inf, -1)")
    fused_err = max(fused_err, err2)
    print(f"phase 7 fused kernel: N={n} B={b} k={k}; " + "; ".join(line)
          + f"; k=100 vs oracle {oerr100:.3g} ({ties100} near-tie diffs); 5 "
          f"valid columns, k={k}: bitwise equal, unfilled slots (-inf, -1)")

    # ---- 8. the "pallas" backend and an exact FusedRetriever
    rp = Retriever(cat, RetrievalConfig(exact_scores=False), DEV)
    check(rp.backend == "pallas", f"backend {rp.backend}")
    fr = FusedRetriever(feats, norms, None, DEV)
    line, fused_launches = [], 0
    for what, fn, tol in (
        ("pallas backend", rp.retrieve, TOL_FAST),
        ("exact FusedRetriever", fr, TOL_EXACT),
    ):
        fused_topk.launches = 0
        s8, i8 = fn(queries, k=k, exclude_rows=excl)
        torch.cuda.synchronize()
        launched = fused_topk.launches
        check(launched > 0, f"{what}: the fused kernel did not launch")
        fused_launches += launched
        oerr, ties = compare_oracle(s8, i8, rs, ri, tol, what)
        t_b = wall_ms(lambda: fn(queries, k=k, exclude_rows=excl), 20)
        t_1 = wall_ms(lambda: fn(q1, k=k, exclude_rows=e1), 20)
        line.append(
            f"{what}: {launched} launch, vs oracle max score diff {oerr:.3g}, "
            f"{ties} near-tie positions differ; batch {t_b:.3f} ms median of "
            f"20 ({b / t_b * 1e3:.0f} q/s); B=1 {t_1:.3f} ms")
    print(f"phase 8 fused retrievers: N={n} B={b} k={k}; " + "; ".join(line))
    del rp, fr, retriever, cr, modes, f_dev

    # ---- 9. the streaming tier at the JAX benchmark's shape
    n9, b9, w9 = 4_000_000, 256, 1 << 20        # benchmark.py:401-404
    rng9 = np.random.default_rng(0)
    feats9 = rng9.random((n9, 12), dtype=np.float32)
    q9 = feats9[rng9.integers(0, n9, b9)]
    ids9 = np.arange(n9).astype("U7")
    with tempfile.TemporaryDirectory() as tmp:
        cdir = str(Path(tmp) / "catalog")
        t0 = time.perf_counter()
        Catalog(feats9, None, ids9, ids9, ids9, np.zeros(n9, np.int32), ["g"],
                np.zeros(11, np.float32), np.ones(11, np.float32)).save_dir(cdir)
        cat9 = Catalog.load_dir(cdir)
        t_save = time.perf_counter() - t0
        check(isinstance(cat9.features, np.memmap), "features are not memory-mapped")
        sr = StreamingRetriever(cat9.features, cat9.norms, None, DEV, window=w9)
        fused_topk.launches = 0
        s9, i9 = sr(q9, k)
        torch.cuda.synchronize()
        launched = fused_topk.launches
        check(launched > 0, "streaming: the fused kernel did not launch")
        fused_launches += launched
        q9d = torch.from_numpy(q9).to(DEV)
        f9 = torch.from_numpy(feats9).to(DEV)
        r9s, r9i = similarity.exact_topk_chunked(
            q9d, f9, torch.from_numpy(np.asarray(cat9.norms)).to(DEV), k=k)
        oerr9, ties9 = compare_oracle(s9, i9, r9s, r9i, TOL_EXACT, "streaming")
        t_s = wall_ms(lambda: sr(q9, k), 5)
        gbps = n9 * 12 * 4 / t_s / 1e6
        # the parts of one window: host copy out of the memmap, bare pinned
        # upload, kernel at B = 256
        pinned = torch.empty((w9, 12), pin_memory=True)
        t_host = statistics.median(
            _host_ms(lambda: pinned.copy_(host_tensor(cat9.features[:w9])))
            for _ in range(5))
        rows_d = torch.empty((w9, 12), device=DEV)
        t_h2d = sync_ms(lambda: rows_d.copy_(pinned, non_blocking=True), 10)
        link = w9 * 12 * 4 / t_h2d / 1e6
        none9 = torch.full((b9,), -1, dtype=torch.int64, device=DEV)
        win_norms = similarity.row_norms(f9[:w9])
        t_win = sync_ms(lambda: prepare_and_call(
            q9d, none9, f9[:w9].t(), win_norms, w9, k=k, eps=1e-8,
            exact=True), 10)
        # the alternative layout: transpose the window on the device first
        win_t = f9[:w9].t().contiguous()
        t_tr = sync_ms(lambda: f9[:w9].t().contiguous(), 10)
        t_win_t = sync_ms(lambda: prepare_and_call(
            q9d, none9, win_t, win_norms, w9, k=k, eps=1e-8, exact=True), 10)
        del f9, win_t
        qpath, opath = Path(tmp) / "q.npy", Path(tmp) / "out.npz"
        np.save(qpath, q9)
        run_cli(["--device", "cuda", "retrieve", str(qpath), "--catalog", cdir,
                 "--streaming", "-k", str(k), "-o", str(opath)])
        with np.load(opath) as z:
            check(np.array_equal(z["rows"], i9.cpu().numpy()),
                  "retrieve --streaming rows differ from the library call's")
    print(f"phase 9 streaming: N={n9} memmap dir (written and loaded in "
          f"{t_save:.1f} s) B={b9} window {w9} k={k}: {launched} launches, vs "
          f"oracle max score diff {oerr9:.3g}, {ties9} near-tie positions "
          f"differ; batch {t_s:.3f} ms median of 5 ({gbps:.3f} GB/s streamed); "
          f"one window: host copy {t_host:.3f} ms, bare pinned H2D {t_h2d:.3f} "
          f"ms ({link:.3f} GB/s), kernel at B={b9} {t_win:.3f} ms on the "
          f"row-major window (a transposed copy: {t_win_t:.3f} ms + "
          f"{t_tr:.3f} ms to transpose); "
          f"streaming_link_efficiency {gbps / link:.3f}; retrieve --streaming "
          "rows equal the library call's")

    # ---- 10. the v2 certified tier (kernel 4) and kernel 1 at W = 512
    f_dev = torch.from_numpy(feats).to(DEV)
    t0 = time.perf_counter()
    r10 = Retriever(cat, RetrievalConfig(scan="v2"), DEV)
    torch.cuda.synchronize()
    t_setup10 = time.perf_counter() - t0
    dl10 = r10.certified.layout
    check((dl10.scan, dl10.w, dl10.depth) == ("v2", 512, 3),
          f"v2 layout {dl10.scan} W={dl10.w} depth {dl10.depth}")
    split_bf16x2.launches = scan_v2.launches = 0
    s10, i10 = r10.retrieve(queries, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    launches_v2 = {"split_bf16x2": split_bf16x2.launches,
                   "scan_v2": scan_v2.launches}
    check(all(v > 0 for v in launches_v2.values()),
          f"a kernel of the v2 path did not launch: {launches_v2}")
    fb10, esc10 = r10.certified.fallbacks, r10.certified.escalations
    err10, ties10 = check_certified(s10, i10, fixed, (rs, ri), "v2 batch")
    check(fb10 < 27, f"v2: {fb10} oracle fallbacks in a batch")
    batch10 = wall_ms(lambda: r10.retrieve(queries, k=k, exclude_rows=excl), 20)
    split_bf16x2.launches = scan_v2.launches = 0
    r10.retrieve(q1, k=k, exclude_rows=e1)
    torch.cuda.synchronize()
    launches["scan_v2_b1"] = scan_v2.launches
    check(scan_v2.launches > 0, "v2 B=1: kernel 4 did not launch")
    b1_10 = wall_ms(lambda: r10.retrieve(q1, k=k, exclude_rows=e1), 20)
    # kernel 4 against its plain version: compact at the path's shapes, and
    # the full structures over the first 65,536 columns of 64 queries
    v2args = (qn, dl10.nrm_row, excl, n, 1e-8)
    err4, bit4, _ = compare_scan(q2, dl10.ft, 3, 32, w=512, v2=v2args)
    m = 65536
    errf, bitf, (fv, _, fb) = compare_scan(
        q2[:64].contiguous(), dl10.ft[:, :m], 3, 0, w=512,
        v2=(qn[:64], dl10.nrm_row[:m], excl[:64], m, 1e-8))
    check(fv.shape == (64, 3 * 512) and fb.shape == (64, 512), "full shapes")
    # kernel 4 at the batch, at 32 queries and at B = 1
    v2shapes = {"scan_v2": b, "scan_v2_b32": 32, "scan_v2_b1": 1}
    for name, m4 in v2shapes.items():
        v2call = (q2[:m4].contiguous(), qn[:m4], dl10.ft, dl10.nrm_row,
                  excl[:m4], n)
        if m4 != b:
            err4 = compare_scan(v2call[0], dl10.ft, 3, 32, w=512,
                                v2=(qn[:m4], dl10.nrm_row, excl[:m4], n,
                                    1e-8))[0]
        entry = dict(
            source=f"{CSRC}/scan_v2.cu", replaces=f"{PALLAS}:834",
            max_abs_err=max(err4, errf),
            ms=sync_ms(lambda: scan_v2(*v2call, w=512, eps=1e-8, topc=32), 20),
            plain_ms=sync_ms(lambda: scan_v2_plain(*v2call, w=512, eps=1e-8,
                                                   topc=32), 3),
            **bound(dot_flops(v2call[0], dl10.ft, q2.shape[1]), "bf16",
                    *v2call[:5], *scan_v2(*v2call, w=512, eps=1e-8, topc=32)),
            library_ms=None,
        )
        if name == "scan_v2_b32":       # no path runs it: printed, not listed
            t_v2_b32 = entry["ms"]
        else:
            kernels[name] = entry
    launches.update(scan_v2=launches_v2["scan_v2"])
    launches["split_bf16x2"] += launches_v2["split_bf16x2"]
    del r10, dl10
    # kernel 1 at W = 512: a certified batch and the kernel against plain
    r512 = Retriever(cat, RetrievalConfig(scan_bins=512), DEV)
    ft512 = r512.certified.layout.ft
    check(r512.certified.layout.w == 512, "scan_bins=512 layout")
    scan_v3.launches = 0
    s512, i512 = r512.retrieve(queries, k=k, exclude_rows=excl)
    torch.cuda.synchronize()
    launched512 = scan_v3.launches
    check(launched512 > 0, "W=512: the scan kernel did not launch")
    check_certified(s512, i512, fixed, (rs, ri), "W=512 batch")
    fb512, esc512 = r512.certified.fallbacks, r512.certified.escalations
    errw2, bitw2, _ = compare_scan(q2, ft512, 2, 32, w=512, ncols=n)
    errw3, bitw3, _ = compare_scan(q2[:32].contiguous(), ft512, 3, 32, w=512,
                                   ncols=n)
    kernels["scan_v3_w512"] = dict(
        source=f"{CSRC}/scan_v3.cu", replaces=f"{PALLAS}:1069",
        max_abs_err=max(errw2, errw3),
        ms=sync_ms(lambda: scan_v3(q2, ft512, w=512, depth=2, topc=32,
                                   ncols=n), 10),
        plain_ms=sync_ms(lambda: scan_v3_plain(q2, ft512, w=512, depth=2,
                                               topc=32, ncols=n), 3),
        **bound(dot_flops(q2, ft512[:, :n], q2.shape[1]), "bf16", q2,
                ft512[:, :n], *scan_v3(q2, ft512, w=512, depth=2, topc=32,
                                       ncols=n)),
        library_ms=None,
    )
    launches["scan_v3_w512"] = launched512
    batch512 = wall_ms(lambda: r512.retrieve(queries, k=k, exclude_rows=excl), 5)
    print(f"phase 10 v2 certified tier: N={n} B={b} k={k} W=512 depth 3: "
          f"{b * k} of {b * k} indices and scores bitwise the fixed-order "
          f"oracle's on the card; vs the cuBLAS oracle max score diff "
          f"{err10:.3g}, {ties10} near-tie positions differ; per batch: "
          f"fallbacks {fb10}, escalations {esc10}; launches "
          f"{launches_v2}; batch {batch10:.3f} ms median of 20 "
          f"({b / batch10 * 1e3:.0f} q/s); B=1 {b1_10:.3f} ms; setup "
          f"{t_setup10:.1f} s; kernel 4 ({b} x {ft512.shape[1]}, C=32) "
          f"{kernels['scan_v2']['ms']:.3f} ms vs plain "
          f"{kernels['scan_v2']['plain_ms']:.3f} ms, max err {err4:.3g} "
          f"(bitwise {bit4}), at 32 queries {t_v2_b32:.4f} ms, at B=1 "
          f"{kernels['scan_v2_b1']['ms']:.4f} ms (bitwise); full structures "
          f"(64 x {m}) max err {errf:.3g} "
          f"(bitwise {bitf}); kernel 1 at W=512: certified batch bitwise the "
          f"fixed-order oracle's ({launched512} launches, {fb512} fallbacks, {esc512} "
          f"escalations per batch, {batch512:.3f} ms), depth 2 "
          f"{kernels['scan_v3_w512']['ms']:.3f} ms vs plain "
          f"{kernels['scan_v3_w512']['plain_ms']:.3f} ms (bitwise {bitw2}), "
          f"depth 3 on 32 queries bitwise {bitw3}")
    del r512, ft512

    # ---- 11. kernel 3 over bf16 and bf16x2 storage, and the prefilter
    line = []
    for dtype, kname in (("bfloat16", "fused_topk_bf16"),
                         ("bfloat16x2", "fused_topk_bf16x2")):
        fr11 = FusedRetriever(feats, norms, RetrievalConfig(
            dtype=dtype, exact_scores=False), DEV)
        fused_topk.launches = 0
        s11, i11 = fr11(queries, k, excl)
        torch.cuda.synchronize()
        launches[kname] = fused_topk.launches
        check(launches[kname] > 0, f"{dtype}: the fused kernel did not launch")
        tol = TOL_BF16 if dtype == "bfloat16" else BF16X2_EPS
        agree = i11 == ri
        oerr = (s11 - rs)[agree].abs().max().item()
        check(oerr <= tol, f"{dtype}: scores differ from the oracle's by {oerr}")
        rec = recall(i11, ri)
        if dtype == "bfloat16":
            qb = qunit.to(torch.bfloat16)
        else:
            qb = torch.cat([hi, lo, lo, hi], dim=1)
        args = (qb, qn, fr11.features_t, fr11.norms, excl, n)
        kv, ki, kerr = compare_fused(args, k, False, f"fused {dtype}")
        kerr = max(kerr, compare_fused(args, 100, False,
                                       f"fused {dtype} k=100")[2])
        t100 = sync_ms(lambda: fused_topk(*args, k=100, exact=False), 10)
        t1k = sync_ms(lambda: fused_topk(qb[:1], qn[:1], *args[2:4], excl[:1],
                                         n, k=k, exact=False), 50)
        if dtype == "bfloat16":        # a bf16 product and a top-k
            lib = sync_ms(lambda: torch.topk(torch.mm(qb, fr11.features_t), k),
                          10)
        else:   # [qh, ql, ql, qh] x [hi; lo; hi; lo]: exact products in fp32
            ft4 = torch.cat([fr11.features_t] * 2)
            lib = sync_ms(lambda: torch.topk(torch.mm(qb.float(), ft4.float()),
                                             k), 10)
            del ft4
        kernels[kname] = dict(
            source=f"{CSRC}/fused_topk.cu", replaces=f"{PALLAS}:52",
            max_abs_err=kerr,
            ms=sync_ms(lambda: fused_topk(*args, k=k, exact=False), 20),
            plain_ms=sync_ms(lambda: fused_topk_plain(*args, k=k, exact=False), 3),
            **bound(dot_flops(qb, fr11.features_t, qb.shape[1]), "bf16",
                    *args[:5], kv, ki),
            library_ms=lib,
        )
        t_b = wall_ms(lambda: fr11(queries, k, excl), 20)
        t_1 = wall_ms(lambda: fr11(q1, k, e1), 20)
        line.append(
            f"{dtype}: {launches[kname]} launch, bitwise equal to plain at "
            f"k={k} and k=100, kernel {kernels[kname]['ms']:.3f} ms vs plain "
            f"{kernels[kname]['plain_ms']:.3f} ms, k=100 {t100:.3f} ms, B=1 "
            f"{t1k:.4f} ms; recall@{k} {rec:.4f}, max "
            f"score diff where indices agree {oerr:.3g} (limit {tol:.3g}); "
            f"batch {t_b:.3f} ms ({b / t_b * 1e3:.0f} q/s); B=1 {t_1:.3f} ms")
        del fr11
    pr = PrefilterRetriever(feats, norms, None, DEV, prefilter=64)
    fused_topk.launches = 0
    sp, ip = pr(queries, k, excl)
    torch.cuda.synchronize()
    check(fused_topk.launches > 0, "prefilter: the fused kernel did not launch")
    launches["fused_topk_bf16"] += fused_topk.launches
    rec_p = recall(ip, ri)
    check(rec_p >= 0.99, f"prefilter recall@{k} {rec_p}")
    agree = ip == ri
    perr = (sp - rs)[agree].abs().max().item()
    check(perr <= TOL_EXACT, f"prefilter scores differ from the oracle's by {perr}")
    t_pb = wall_ms(lambda: pr(queries, k, excl), 20)
    t_p1 = wall_ms(lambda: pr(q1, k, e1), 20)
    print(f"phase 11 bf16 tiers: N={n} B={b} k={k}; " + "; ".join(line)
          + f"; PrefilterRetriever(prefilter=64): recall@{k} {rec_p:.4f}, max "
          f"score diff where indices agree {perr:.3g}, batch {t_pb:.3f} ms "
          f"({b / t_pb * 1e3:.0f} q/s), B=1 {t_p1:.3f} ms")
    del pr, f_dev

    kernels["fused_topk"] = dict(
        source=f"{CSRC}/fused_topk.cu",
        replaces=f"{PALLAS}:52", max_abs_err=fused_err,
        ms=fused_times[True][0], plain_ms=fused_times[True][1],
        **fused_bound, library_ms=lib_fp32,
    )
    launches["fused_topk"] = fused_launches

    # ---- 12. TPU kernels 9-12 and the three experiment paths that run them
    t12 = time.perf_counter()
    # the kernels against their plain versions at 1024 x 1M: kernel_r3's
    # split layout (qw = 48) and the prototype's [qh, ql] / [hi; lo]
    # (qw = 24), with the phase-6 queries' norms and self-exclusions
    q48, ft48 = kernel_r3.split_layout(1 << 20, b, DEV)
    ft24, nrm24 = certified_proto.layout(feats, norms, DEV)
    q24 = torch.cat(split_bf16x2_plain(qunit), dim=1)
    qn1, excl1 = qn[:, None], excl.int()[:, None]
    errs = {}
    errs["mxu_only"] = check_bitwise(
        (proto_scans.mxu_only(q48, ft48),),
        (proto_scans.mxu_only_plain(q48, ft48),), "mxu_only")
    for w in (256, 512):
        single = proto_scans.scan_d1(q48, ft48, w=w)
        errs["scan_d1"] = max(errs.get("scan_d1", 0.0), check_bitwise(
            single, proto_scans.scan_d1_plain(q48, ft48, w=w),
            f"scan_d1 W={w}"))
        errs["scan_d1_split"] = max(
            errs.get("scan_d1_split", 0.0),
            check_bitwise(proto_scans.scan_d1_split(q48, ft48, w=w), single,
                          f"scan_d1_split W={w} B={b}"),
            check_bitwise(proto_scans.scan_d1_split(q48[:1], ft48, w=w),
                          proto_scans.scan_d1(q48[:1], ft48, w=w),
                          f"scan_d1_split W={w} B=1"))
        args24 = (q24, qn1, ft24, nrm24, excl1, n)
        errs["proto_scan"] = max(errs.get("proto_scan", 0.0), check_bitwise(
            proto_scans.proto_scan(*args24, w=w),
            proto_scans.proto_scan_plain(*args24, w=w), f"proto_scan W={w}"))
        del single
    args3 = (q24, qn1, ft24, nrm24)
    errs["scan3"] = check_bitwise(proto_scans.scan3(*args3),
                                  proto_scans.scan3_plain(*args3), "scan3")
    # and at the shapes kernel_r3.main gives them: its 10M layout (the same
    # seed), W = 512, B = 1024 and, for both scan_d1 schedules, B = 1; the
    # plain versions run in column chunks of 1M (the max over chunks, and
    # the chunks' depth-1 structures merged in column order)
    q10, ft10 = kernel_r3.split_layout(R3_N, b, DEV)
    mxu_ref = torch.stack([
        proto_scans.mxu_only_plain(q10, ft10[:, c:c + PLAIN_CHUNK])
        for c in range(0, ft10.shape[1], PLAIN_CHUNK)]).amax(0)
    errs["mxu_only"] = max(errs["mxu_only"], check_bitwise(
        (proto_scans.mxu_only(q10, ft10),), (mxu_ref,), f"mxu_only {R3_N}"))
    for qq in (q10, q10[:1]):
        ref = proto_scans.scan_d1_split_plain(qq, ft10, w=kernel_r3.W,
                                              slice_=PLAIN_CHUNK)
        for name in ("scan_d1", "scan_d1_split"):
            errs[name] = max(errs[name], check_bitwise(
                getattr(proto_scans, name)(qq, ft10, w=kernel_r3.W), ref,
                f"{name} N={R3_N} B={qq.shape[0]}"))
    del q10, ft10, mxu_ref, ref
    t_cmp10 = time.perf_counter() - t12
    calls = {   # name: (line replaced, kernel, plain, query, planes, inputs)
        "mxu_only": ("kernel_r3.py:53", lambda: proto_scans.mxu_only(q48, ft48),
                     lambda: proto_scans.mxu_only_plain(q48, ft48),
                     q48, ft48, (q48, ft48)),
        "scan_d1": ("kernel_r3.py:151",
                    lambda: proto_scans.scan_d1(q48, ft48, w=512),
                    lambda: proto_scans.scan_d1_plain(q48, ft48, w=512),
                    q48, ft48, (q48, ft48)),
        "scan_d1_split": ("kernel_r3.py:151",
                          lambda: proto_scans.scan_d1_split(q48, ft48, w=512),
                          lambda: proto_scans.scan_d1_split_plain(q48, ft48,
                                                                  w=512),
                          q48, ft48, (q48, ft48)),
        "scan3": ("kernel_ablation_r2e.py:26",
                  lambda: proto_scans.scan3(*args3),
                  lambda: proto_scans.scan3_plain(*args3), q24, ft24, args3),
        "proto_scan": ("certified_proto.py:18",
                       lambda: proto_scans.proto_scan(*args24, w=512),
                       lambda: proto_scans.proto_scan_plain(*args24, w=512),
                       q24, ft24, args24[:5]),
    }
    for name, (line_, fn, plain_fn, qq, ftq, inputs) in calls.items():
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        kernels[name] = dict(
            source=f"{CSRC}/proto_scans.cu", replaces=f"experiments/{line_}",
            max_abs_err=errs[name], ms=sync_ms(fn, 10),
            plain_ms=sync_ms(plain_fn, 2),
            **bound(dot_flops(qq, ftq, qq.shape[1]), "bf16", *inputs, *out),
            library_ms=None,
        )
    del q48, ft48, ft24, nrm24, calls, args3, args24
    t_cmp = time.perf_counter() - t12

    # the three paths, each with its kernels' counts set to 0 just before
    quiet = io.StringIO()
    for fn in (proto_scans.mxu_only, proto_scans.scan_d1,
               proto_scans.scan_d1_split):
        fn.launches = 0
    with contextlib.redirect_stdout(quiet):
        r3 = kernel_r3.main(n=R3_N, b=b, device=DEV, reps=5)
    for fn in (proto_scans.mxu_only, proto_scans.scan_d1,
               proto_scans.scan_d1_split):
        launches[fn.__name__] = fn.launches
    check(r3["split_equal"] == [True, True],
          f"kernel_r3: scan_d1_split differs from scan_d1 {r3['split_equal']}")
    proto_scans.scan3.launches = 0
    with contextlib.redirect_stdout(quiet):
        r2e = kernel_ablation_r2e.main(n=n, b=b, device=DEV)
    launches["scan3"] = proto_scans.scan3.launches
    proto_scans.proto_scan.launches = 0
    with contextlib.redirect_stdout(quiet):
        cpr = certified_proto.main(n=n, b=b, device=DEV)
    launches["proto_scan"] = proto_scans.proto_scan.launches
    new = ("mxu_only", "scan_d1", "scan_d1_split", "scan3", "proto_scan")
    check(all(launches[nm] > 0 for nm in new),
          f"a kernel of the experiment paths did not launch: "
          f"{ {nm: launches[nm] for nm in new} }")
    check(all(np.isfinite(v) and v > 0 for v in r2e.values()), f"r2e {r2e}")
    chk = cpr["check"]
    check(chk["exact_match"] >= 0.9 * chk["b"]
          and all(cpr[f"w{w}"]["cert_ok"] > 0 for w in (512, 256)),
          f"certified_proto: {cpr}")
    gbps = {nm: r3["catalog_bytes"] / r3[nm] / 1e6
            for nm in ("mxu_only", "scan_d3_topc", "scan_d1", "scan_d1_split")}
    print(f"phase 12 prototype scans: kernels vs plain at {b} x 1M bitwise "
          f"equal (scan_d1 / split / proto_scan at W=256 and 512, split also "
          f"at B=1; mxu_only W=128; scan3 W=256), and at kernel_r3's "
          f"{R3_N} x {b} (mxu_only; scan_d1 / split W=512 at B={b} and B=1, "
          f"plain in 1M-column chunks), in {t_cmp10:.1f} s (with timing "
          f"{t_cmp:.1f} s); "
          f"kernel_r3 at N={r3['n']} (Np={r3['np']}) B={b} W=512: "
          + ", ".join(f"{nm} {r3[nm]:.3f} ms ({b / r3[nm] * 1e3:.0f} q/s, "
                      f"{gbps[nm]:.1f} GB/s)" for nm in gbps)
          + f"; B=1 scan_d1 {r3['scan_d1_b1']:.3f} ms, scan_d1_split "
          f"{r3['scan_d1_split_b1']:.3f} ms; split bitwise equal to the single "
          f"walk at B={b} and B=1; r2e: "
          + ", ".join(f"{nm} {v:.3f} ms" for nm, v in r2e.items())
          + f"; certified_proto at N={n} B={b}: "
          + ", ".join(f"W={w} {cpr[f'w{w}']['ms']:.3f} ms per batch, "
                      f"{cpr[f'w{w}']['enqueued_ms']:.3f} ms enqueued, cert_ok "
                      f"{cpr[f'w{w}']['cert_ok']}/{b}" for w in (512, 256))
          + f"; oracle check (W={chk['w']}, 40000 x {chk['b']}): "
          f"{chk['exact_match']}/{chk['b']} exact-match, cert_ok "
          f"{chk['cert_ok']}/{chk['b']}, mismatches-with-cert-ok "
          f"{chk['mismatch_cert_ok']}; launches "
          f"{ {nm: launches[nm] for nm in new} }; "
          f"{time.perf_counter() - t12:.1f} s")

    # ---- 13. TPU kernels 5-8 and the four experiment paths that run them
    ablation_phase(n, b, kernels, launches)

    # ---- 14-16. the approx tier, serving and the benchmark entry, with the
    # earlier phases' cached blocks returned to the card (a serving process
    # starts without them; with them, new allocations stall on cudaFree)
    torch.cuda.empty_cache()
    approx_phase(cat, queries, excl, fixed, kernels, launches)
    serve_phase(feats, built[_build.SERVING.name][1])
    uniform64 = bench_phase(kernels, launches, n, b)
    torch.cuda.empty_cache()
    quality = mf_phase(kernels, launches)
    del fixed
    torch.cuda.empty_cache()
    two_tower_phase(kernels, launches, catalog, cat, rows, uniform64, quality)
    torch.cuda.empty_cache()

    # ---- 19-20. the data layer at 1M rows; the sharded catalog at 10M
    ingest_phase(Path(work.name), gxx_s)
    torch.cuda.empty_cache()
    sharded_phase(kernels, launches, Path(work.name))
    torch.cuda.empty_cache()

    # ---- 21. sharded training, autotune, profiling, debug, graft entry
    training_phase(kernels, launches, Path(work.name), catalog)
    work.cleanup()

    low = {nm: (kv["ms"], kv["bound_ms"]) for nm, kv in kernels.items()
           if not kv["ms"] >= kv["bound_ms"]}
    check(not low, f"kernel times under their bound (work dropped?): {low}")
    print(nvidia_smi("name,power.limit").splitlines()[0])
    print(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "launches": launches[nm], **kv}
        for nm, kv in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
