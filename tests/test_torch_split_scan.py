"""The catalog-split bin scan of kernels 1 and 4, the fixed-order oracle of
the certified tier, and the two kernel libraries, on the CPU.

- The split and its merge, repeated in torch (`split_bin_structures`: the
  per-slice `bin_structures`, then `merge_bins`), are bitwise the single
  walk that `scan_v3_plain` / `scan_v2_plain` take: ties on both sides of a
  slice edge, a slice of padding or of masked (-inf) columns, a ragged last
  slice, B = 1.
- `split_slice` / `scan_slice` keep to the kernels' limits.
- `fixed_order_dots` of gathered rows is bitwise the oracle's dots, so a
  certified batch with duplicates and near-ties in its top-(k+1) certifies
  and equals the fixed-order oracle index for index, and the JAX oracle on
  the duplicates and wherever its neighbouring scores are 2e-6 apart.
- The serving library holds no experiment kernel, and no user-path module
  imports the experiment wrappers.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.ops import similarity as tsim
from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda import scan_v3 as s3
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import DEPTH, scan_v2_plain
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2_plain
from spotify_recommender_tpu_torch.ops.fused_topk import (
    CertifiedRetriever,
    exact_scores,
)

CPU = torch.device("cpu")
PKG = pathlib.Path(__file__).resolve().parents[1] / "spotify_recommender_tpu_torch"


def split_case(seed, w, np_, b, slice_):
    """(q2, ft) over `np_` columns: uniform unit rows as split planes, the
    last 3w columns zero (padding); at every slice edge e the w columns
    before it are copied to the w after it, so each bin ties across the
    edge."""
    rng = np.random.default_rng(seed)
    feats = rng.random((np_, 12), dtype=np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    for e in range(slice_, np_ - w + 1, slice_):
        feats[e:e + w] = feats[e - w:e]
    feats[np_ - 3 * w:] = 0.0
    hi, lo = split_bf16x2_plain(torch.from_numpy(feats))
    ft = torch.cat([hi, lo], 1).t().contiguous()
    q = feats[rng.integers(0, np_ - 3 * w, b)] + 0.05 * rng.standard_normal(
        (b, 12)).astype(np.float32)
    qn = tsim.row_norms(torch.from_numpy(q))
    qh, ql = split_bf16x2_plain(torch.from_numpy(q) / qn[:, None])
    return torch.cat([qh, ql, ql, qh], 1), qn, ft


def assert_equal(got, want):
    for g, x in zip(got, want):
        assert g.shape == x.shape and torch.equal(g, x)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("w", [128, 384, 512])
@pytest.mark.parametrize("b", [1, 7])
def test_split_merge_bitwise_equals_v3_plain(depth, w, b):
    """Slices of 3w columns over 17w (a ragged last slice of 2w, which with
    the 3w zero columns before it is all padding), against the single
    walk: full structures and the compact top-C."""
    np_, slice_ = 17 * w, 3 * w
    q2, _, ft = split_case(depth * 10 + w + b, w, np_, b, slice_)
    scores = s3.split_plane_dots(q2, ft)
    split = s3.split_bin_structures(scores, w, depth, slice_)
    assert_equal(split, s3.bin_structures(scores, w, depth))
    topc = min(32, depth * w)
    assert_equal(s3.top_slots(*split, topc),
                 s3.scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc))
    # the copies tie their originals: each tied pair keeps the lower column
    # first within its bin
    v, i, _ = split
    top = v.view(b, depth, w)[:, 0]
    assert (i.view(b, depth, w)[:, 0] < np_).all() and torch.isfinite(top).all()


@pytest.mark.parametrize("w", [128, 384, 512])
@pytest.mark.parametrize("topc", [32, 0])
def test_split_merge_bitwise_equals_v2_plain(w, topc):
    """Kernel 4's scores (guard, clip, masks): the columns from `valid` on
    are -inf, so the last slices are all masked; exclusions hit a slice
    edge's tied pair."""
    np_, slice_, b = 17 * w, 4 * w, 5
    q2, qn, ft = split_case(w + topc, w, np_, b, slice_)
    norms = tsim.row_norms(ft[:12].float().t() + ft[12:].float().t())
    valid = np_ - 5 * w        # slices [12w, 16w) and [16w, 17w) all masked
    excl = torch.tensor([-1, slice_, slice_ - w, 3, 2 * slice_])
    dots = s3.split_plane_dots(q2, ft)
    scores = torch.where(qn[:, None] * norms[None, :] > 1e-8,
                         dots.clamp(-1.0, 1.0), 0.0)
    cols = torch.arange(np_)[None, :]
    scores = scores.masked_fill((cols >= valid) | (cols == excl[:, None]),
                                float("-inf"))
    split = s3.split_bin_structures(scores, w, DEPTH, slice_)
    plain = scan_v2_plain(q2, qn, ft, norms, excl, valid, w=w, eps=1e-8,
                          topc=topc)
    assert_equal(split if topc == 0 else s3.top_slots(*split, topc), plain)
    last = s3.bin_structures(scores[:, 3 * slice_:], w, DEPTH)
    assert torch.isinf(last[0]).all() and (last[1] == -1).all()


def test_merge_of_an_empty_slice_is_the_identity():
    w, depth = 128, 2
    scores = torch.randn(3, 4 * w)
    part = s3.bin_structures(scores, w, depth)
    empty = s3.bin_structures(torch.full((3, w), float("-inf")), w, depth)
    assert_equal(s3.merge_bins([part, empty], depth), part)
    assert_equal(s3.merge_bins([empty, part], depth), part)


@pytest.mark.parametrize("b,np_,w,depth", [
    (1, 1_048_576, 128, 2), (32, 1_048_576, 128, 3), (1024, 1_048_576, 128, 2),
    (1024, 1_048_576, 512, 3), (1, 10_027_008, 512, 3), (1, 1 << 31, 128, 4),
    (5, 384, 384, 1), (100_000, 65_536, 128, 2),
])
def test_scan_slice_keeps_the_kernel_limits(b, np_, w, depth):
    """A multiple of w, at most 65,535 slices, the scratch under the cap
    (or one slice), and enough blocks for the card where the catalog has
    the columns."""
    slice_ = s3.scan_slice(b, np_, w, depth, CPU)
    slices = -(-np_ // slice_)
    assert slice_ % w == 0 and 1 <= slices <= s3.MAX_SLICES
    assert slice_ >= min(np_, s3.MIN_SLICE_GROUPS * w)
    scratch = slices * 4 * b * (2 * depth * w + w)
    assert scratch <= s3.SCRATCH_CAP or slices == 1
    tiles = -(-b // s3.queries_per_block(w))
    if (np_ // w >= 8 * s3.MIN_SLICE_GROUPS * s3.H100_SMS
            and scratch <= s3.SCRATCH_CAP // 2):
        assert tiles * slices >= s3.H100_SMS


def test_split_slice_at_the_main_path_shapes():
    # 1024 queries, W = 128: 64 tiles, ~17 slices, ~44 MB of scratch
    s = s3.scan_slice(1024, 1_048_576, 128, 2, CPU)
    assert -(-1_048_576 // s) == 17
    # the 32-query rescan and B = 1 split the catalog much finer, down to
    # slices of MIN_SLICE_GROUPS w-column groups
    for b in (32, 1):
        slice_ = s3.scan_slice(b, 1_048_576, 128, 3, CPU)
        assert slice_ == s3.MIN_SLICE_GROUPS * 128
        assert -(-1_048_576 // slice_) == 512


def test_fixed_order_dots_of_gathered_rows_equal_the_oracle():
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((5000, 12), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((9, 12), dtype=np.float32))
    rows = torch.from_numpy(rng.integers(0, 5000, (9, 40)))
    full = tsim.fixed_order_dots(q[:, None, :], feats[None, :, :])
    got = tsim.fixed_order_dots(q[:, None, :], feats[rows])
    assert torch.equal(got, torch.gather(full, 1, rows))
    # the ascending sum, one rounding per multiply and per add
    want = q[:, None, 0] * feats[rows][..., 0]
    for j in range(1, 12):
        want = want + q[:, None, j] * feats[rows][..., j]
    assert torch.equal(got, want)
    # and the rerank's cosine is the fixed-order oracle's, bit for bit
    norms = tsim.row_norms(feats)
    qn = tsim.row_norms(q)
    oracle = tsim.cosine_scores_batched(q, feats, norms, fixed_order=True)
    assert torch.equal(exact_scores(q, qn, rows, feats, norms, 1e-8),
                       torch.gather(oracle, 1, rows))


def tie_catalog(seed, n=8192, b=16, k=10):
    """Uniform rows and queries near catalog rows; each query's best row
    copied exactly twice and scaled by 1 + 1e-3 once (a cosine within a few
    ulp), all in other bins: every query's top-(k+1) holds exact duplicates
    and near-ties."""
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    q = feats[rng.integers(0, n, b)] + 0.01 * rng.standard_normal(
        (b, 12)).astype(np.float32)
    scores = (q @ feats.T) / np.linalg.norm(q, axis=1)[:, None] \
        / np.linalg.norm(feats, axis=1)[None, :]
    best = scores.argmax(axis=1)
    free = iter(rng.permutation(np.setdiff1d(np.arange(n), best)))
    for j, r in enumerate(best):
        for scale in (1.0, 1.0, np.float32(1.001)):
            c = next(free)
            while c % 128 in {r % 128} or c in best:
                c = next(free)
            feats[c] = feats[r] * scale
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    return feats, norms, q


def test_certified_ties_certify_and_equal_the_fixed_order_oracle():
    feats, norms, q = tie_catalog(21)
    k = 10
    tq, tf, tn = map(torch.from_numpy, (q, feats, norms))
    os_, oi = tsim.exact_topk_iterative(tq, tf, tn, k=k + 1, fixed_order=True)
    # the gap check (adjacent top-(k+1) scores more than 2e-6 apart) would
    # have sent every query to the oracle
    assert ((os_[:, :-1] - os_[:, 1:]) <= 2e-6).any(dim=1).all()
    cr = CertifiedRetriever(feats, norms, RetrievalConfig(), CPU)
    s, i = cr(q, k)
    assert cr.fallbacks == 0
    assert torch.equal(i, oi[:, :k]) and torch.equal(s, os_[:, :k])
    js, ji = map(np.asarray, exact_topk(jnp.asarray(q), jnp.asarray(feats),
                                        jnp.asarray(norms), k=k))
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=1e-6)
    # exact duplicates: equal scores, lowest index first, in both
    si = i.numpy()
    for row in range(len(q)):
        for a in range(k - 1):
            if s[row, a] == s[row, a + 1] and (
                    feats[si[row, a]] == feats[si[row, a + 1]]).all():
                assert si[row, a] < si[row, a + 1]
                assert {si[row, a], si[row, a + 1]} <= set(ji[row])
    gap = np.diff(js, axis=1) < -2e-6
    edge = np.ones((len(q), 1), bool)
    sep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
    sep[:, -1] = False          # the (k+1)-th JAX score is not known here
    np.testing.assert_array_equal(si[sep], ji[sep])


def test_serving_library_excludes_the_experiment_kernels():
    serving, experiments = _build.SERVING, _build.EXPERIMENTS
    assert not {"proto_scans.cu", "ablation_r2.cu"} & set(serving.sources)
    assert {"proto_scans.cu", "ablation_r2.cu"} <= set(experiments.sources)
    assert not {"srt_mxu_only", "srt_scan_d1", "srt_scan_d1_split",
                "srt_proto_scan", "srt_ablation"} & set(serving.signatures)
    # every C entry point is bound by the one library that compiles it
    for path in sorted(_build.CSRC_DIR.glob("*.cu")):
        names = set(ast.literal_eval(repr(n)) for n in
                    __import__("re").findall(r'extern "C" [^(]* (srt_\w+)\(',
                                             path.read_text()))
        owners = [lib for lib in _build.LIBRARIES if path.name in lib.sources]
        assert owners, path.name
        for lib in owners:
            assert names - {"srt_error_string"} <= set(lib.signatures)
    assert _build.source_hash(serving) != _build.source_hash(experiments)


USER_PATH = ["ops/fused_topk.py", "ops/cuda/split.py", "ops/cuda/scan_v3.py",
             "ops/cuda/scan_v2.py", "ops/cuda/fused.py", "cli.py",
             *[str(p.relative_to(PKG)) for p in (PKG / "retrieval").glob("*.py")]]


@pytest.mark.parametrize("rel", USER_PATH)
def test_user_path_modules_do_not_import_the_experiments(rel):
    tree = ast.parse((PKG / rel).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {f"{node.module}.{a.name}" for a in node.names}
            names.add(node.module or "")
    bad = {n for n in names if "proto_scans" in n or "ablation" in n
           or "experiments" in n}
    assert not bad, bad


def test_user_path_loads_no_experiment_module():
    script = textwrap.dedent("""
        import sys
        import spotify_recommender_tpu_torch.cli
        import spotify_recommender_tpu_torch.retrieval.retriever
        import spotify_recommender_tpu_torch.retrieval.streaming_retriever
        bad = [m for m in sys.modules if m.startswith(
            "spotify_recommender_tpu_torch.") and any(
            s in m for s in ("proto_scans", "ablation", "experiments"))]
        print("BAD" if bad else "OK", bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK"), out.stdout
