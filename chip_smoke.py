"""End-to-end smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `spotify_recommender_tpu_torch/csrc`,
holds each against its plain torch version on the card, runs the
reference-style CLI on a 114,000-row catalog, and drives the main path
(`Retriever.retrieve`, certified exact tier) at the benchmark's size:
1,000,000 x 12 items, B = 1024 catalog-row queries with self-exclusion,
k = 10.  Every phase prints one line; any failure raises and exits
non-zero.  The next-to-last line is a JSON object of the kernels (launches
on the main path, error against the plain version, times); the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Needs a CUDA device, nvcc and this repository's `spotify_recommender_tpu_torch`
package; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch sees no CUDA device")

from spotify_recommender_tpu_torch import cli  # noqa: E402
from spotify_recommender_tpu_torch.core.config import RetrievalConfig  # noqa: E402
from spotify_recommender_tpu_torch.core.device import (  # noqa: E402
    device_info,
    nvidia_smi,
)
from spotify_recommender_tpu_torch.data.catalog import Catalog  # noqa: E402
from spotify_recommender_tpu_torch.ops import similarity  # noqa: E402
from spotify_recommender_tpu_torch.ops.cuda import _build  # noqa: E402
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (  # noqa: E402
    scan_v3,
    scan_v3_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.split import (  # noqa: E402
    split_bf16x2,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.fused_topk import (  # noqa: E402
    BF16X2_EPS,
    build_certified_layout,
    layout_to_device,
)
from spotify_recommender_tpu_torch.retrieval.retriever import (  # noqa: E402
    Retriever,
)

DEV = torch.device("cuda:0")
TOL = 1e-6   # kernel vs plain: values and bounds (same fp32 products)
PALLAS = "spotify_recommender_tpu/ops/pallas/fused_topk.py"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn()` between CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def compare_scan(q2, ft, depth, topc):
    """Scan kernel vs plain on the same inputs.  Returns (max abs error of
    values and bounds, bitwise equal?, kernel outputs)."""
    kv, ki, kb = scan_v3(q2, ft, w=128, depth=depth, topc=topc)
    pv, pi, pb = scan_v3_plain(q2, ft, w=128, depth=depth, topc=topc)
    torch.cuda.synchronize()
    err = max((kv - pv).abs().max().item(), (kb - pb).abs().max().item())
    check(err <= TOL, f"scan depth {depth}: values/bounds differ by {err}")
    # indices must agree wherever the plain values leave no near-tie
    gaps = (pv[:, :-1] - pv[:, 1:]) > TOL
    ones = torch.ones_like(gaps[:, :1])
    sep = torch.cat([ones, gaps], 1) & torch.cat([gaps, ones], 1)
    sep[:, -1] = False      # the (C+1)-th value is unknown
    check(torch.equal(ki[sep], pi[sep]), f"scan depth {depth}: indices differ")
    bitwise = torch.equal(kv, pv) and torch.equal(ki, pi) and torch.equal(kb, pb)
    return err, bitwise, (kv, ki, kb)


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
    """The CLI's printed ids and scores equal the oracle's on the card."""
    ids = re.findall(r"^   ID:     (.*)$", text, flags=re.M)
    scores = [float(s) for s in re.findall(r"^   Score:  (.*)$", text, flags=re.M)]
    f = torch.from_numpy(cat.features).to(DEV)
    nrm = torch.from_numpy(cat.norms).to(DEV)
    rs, ri = similarity.exact_topk_chunked(
        f[row:row + 1], f, nrm, exclude_rows=torch.tensor([row], device=DEV), k=n
    )
    want = [str(cat.track_ids[r]) for r in ri[0].tolist()]
    check(ids == want, f"cli ids {ids} != oracle {want}")
    # printed with 6 decimals: rounding 5e-7 plus rerank-vs-oracle 1e-6
    check(np.allclose(scores, rs[0].cpu().numpy(), rtol=0, atol=1.5e-6),
          f"cli scores {scores} vs oracle {rs[0].tolist()}")


def main() -> None:
    kernels = {}

    # ---- 1. environment
    info = device_info(DEV)
    name, count = info.device_kind, info.num_devices
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    smi = nvidia_smi("name,power.limit").splitlines()[0]
    print(f"phase 1 environment: {name} x{count}, torch {torch.__version__}, "
          f"torch.version.cuda {info.cuda_version}, nvcc {nvcc!r}, "
          f"power limit {info.power_limit}, nvidia-smi {smi!r}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"phase 2 build: {lib.name} from {len(_build.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s")

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

    # ---- 5. CLI at the reference dataset's scale (114,000 rows, 114 genres)
    with tempfile.TemporaryDirectory() as tmp:
        csv = Path(tmp) / "songs.csv"
        n_rows = 114_000
        make_songs_csv(csv, n_rows, 114, seed=1)
        catalog = str(Path(tmp) / "songs_catalog.npz")
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
          f"--id equal the oracle on the card ({t_rec:.1f} s for both)")

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

    f_dev = torch.from_numpy(feats).to(DEV)
    n_dev = torch.from_numpy(norms).to(DEV)
    rs, ri = similarity.exact_topk_chunked(queries, f_dev, n_dev,
                                           exclude_rows=excl, k=k)
    torch.cuda.synchronize()
    check(torch.equal(i, ri), "certified indices differ from the oracle's "
          f"in {(i != ri).sum().item()} of {b * k}")
    check(torch.isfinite(s).all().item() and s.shape == (b, k), "scores")
    score_err = (s - rs).abs().max().item()
    check(score_err <= 1e-6, f"scores differ from the oracle's by {score_err}")

    batch_ms = wall_ms(lambda: retriever.retrieve(queries, k=k, exclude_rows=excl), 20)
    plain_batch_ms = wall_ms(lambda: similarity.exact_topk_chunked(
        queries, f_dev, n_dev, exclude_rows=excl, k=k), 5)
    q1, e1 = queries[:1], excl[:1]
    b1_ms = wall_ms(lambda: retriever.retrieve(q1, k=k, exclude_rows=e1), 20)
    print(f"phase 6 main path: N={n} B={b} k={k}: {b * k} of {b * k} indices "
          f"equal the oracle's on the card (max score diff {score_err:.3g}); "
          f"fallbacks {fallbacks}, escalations {escalations}; launches "
          f"{launches}; batch {batch_ms:.3f} ms median of 20 "
          f"({b / batch_ms * 1e3:.0f} q/s); plain path (oracle "
          f"exact_topk_chunked) {plain_batch_ms:.3f} ms; B=1 latency "
          f"{b1_ms:.3f} ms; setup {t_setup:.1f} s")

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
    )
    q2 = torch.cat([hi, lo, lo, hi], dim=1)
    ft = cr.layout.ft
    err2, bit2, _ = compare_scan(q2, ft, 2, 32)
    err3, bit3, _ = compare_scan(q2[:32].contiguous(), ft, 3, 32)   # escalation
    kernels["scan_v3"] = dict(
        source="spotify_recommender_tpu_torch/csrc/scan_v3.cu",
        replaces=f"{PALLAS}:1069", max_abs_err=max(err2, err3),
        ms=sync_ms(lambda: scan_v3(q2, ft, w=128, depth=2, topc=32), 10),
        plain_ms=sync_ms(lambda: scan_v3_plain(q2, ft, w=128, depth=2, topc=32), 3),
    )
    print(f"kernels at main-path shapes: split {tuple(qunit.shape)} "
          f"{kernels['split_bf16x2']['ms']:.4f} ms vs plain "
          f"{kernels['split_bf16x2']['plain_ms']:.4f} ms; scan depth 2 "
          f"({b} x {ft.shape[1]}) {kernels['scan_v3']['ms']:.3f} ms vs plain "
          f"{kernels['scan_v3']['plain_ms']:.3f} ms (bitwise {bit2}); escalation "
          f"shape depth 3 (32 queries) bitwise {bit3}")

    print(nvidia_smi("name,power.limit").splitlines()[0])
    print(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "launches": launches[nm], **kv}
        for nm, kv in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
