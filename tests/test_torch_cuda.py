"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`; each test skips (from a fixture) where torch sees no CUDA
device.  The card's machine has no JAX, so run this file without the
suite's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q

These repeat, at a small size, the kernel phases of chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from test_torch_fused_large_k_select import KINDS as LARGE_KINDS
from test_torch_fused_large_k_select import large_inputs
from test_torch_fused_select import tie_inputs

from spotify_recommender_tpu_torch.core.config import COSINE_EPS, RetrievalConfig
from spotify_recommender_tpu_torch.experiments import (
    kernel_ablation_r2,
    kernel_ablation_r2b,
    kernel_ablation_r2c,
    kernel_ablation_r2d,
    kernel_r3,
)
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.cuda import ablation, proto_scans
from spotify_recommender_tpu_torch.ops.cuda import _build
from spotify_recommender_tpu_torch.ops.cuda.fused import (
    LARGE_SCRATCH_CEILING,
    SMALL_K_MAX,
    _large_plan,
    _splits,
    copy_width,
    fused_route,
    fused_topk,
    fused_topk_large,
    fused_topk_plain,
    query_tile,
    tile,
)
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import scan_v2, scan_v2_plain
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (
    ROUNDS_MAX_TOPC,
    scan_route,
    scan_slice,
    scan_v3,
    scan_v3_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.split import (
    query_prologue,
    query_prologue_plain,
    split_bf16x2,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.fused_topk import (
    BF16X2_EPS,
    ApproxRetriever,
    CertifiedRetriever,
    FusedRetriever,
    PrefilterRetriever,
    build_certified_layout,
    layout_to_device,
    prepare_and_call,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    similarity.disable_tf32()
    return torch.device("cuda")


def _split_rows(rng, m=4096, f=12):
    x = rng.standard_normal((m, f)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[7] = 0.0                                          # zero row
    x[8] *= np.float32(1e-30)                           # tiny row
    x[9] *= np.float32(3e37)                            # huge row
    return x


def test_split_bitwise_equals_plain(cuda):
    x = torch.from_numpy(_split_rows(np.random.default_rng(0))).to(cuda)
    before = split_bf16x2.launches
    hi, lo = split_bf16x2(x)
    torch.cuda.synchronize()
    assert split_bf16x2.launches == before + 1
    phi, plo = split_bf16x2_plain(x)
    # bitwise: both round to nearest even from the same fp32 values
    assert torch.equal(hi.view(torch.int16), phi.view(torch.int16))
    assert torch.equal(lo.view(torch.int16), plo.view(torch.int16))
    unit = torch.ones(x.shape[0], dtype=torch.bool, device=cuda)
    unit[7:10] = False
    res = (hi.float() + lo.float() - x)[unit].abs().max().item()
    assert res < 1e-5, res      # ~2^-18 on unit vectors; ~2^-9 if lo were lost


@pytest.mark.parametrize("f", [12, 64])
@pytest.mark.parametrize("b", [1, 7, 1024])
def test_query_prologue_bitwise_equals_plain(cuda, b, f):
    """Kernel 2's prologue against its plain version, NaN and inf queries
    and a NaN norm included: every bit, NaN payloads too."""
    rng = np.random.default_rng(b * f)
    q = rng.standard_normal((b, f)).astype(np.float32)
    if b >= 7:
        q[1] *= np.float32(1e-30)                   # tiny row
        q[2] *= np.float32(3e37)                    # huge row
        q[3] = 0.0                                  # zero row
        q[4, 0] = np.nan                            # NaN query
        q[5, 1] = np.inf                            # inf query
        q[6, 1:] *= np.float32(1e-36)               # subnormal lo values
    q = torch.from_numpy(q).to(cuda)
    qn = similarity.row_norms(q)
    if b >= 7:
        qn[0] = float("nan")                        # a NaN norm propagates
    before = query_prologue.launches
    out = query_prologue(q, qn)
    torch.cuda.synchronize()
    assert query_prologue.launches == before + 1
    ref = query_prologue_plain(q, qn)
    assert out.shape == (b, 4 * f) and out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


def test_query_prologue_rejects_bad_inputs(cuda):
    q = torch.ones((8, 12), device=cuda)
    qn = similarity.row_norms(q)
    before = query_prologue.launches
    with pytest.raises(TypeError):
        query_prologue(q.half(), qn)
    with pytest.raises(TypeError):
        query_prologue(q, qn.double())
    with pytest.raises(ValueError):                 # non-contiguous queries
        query_prologue(torch.ones((12, 8), device=cuda).t(), qn)
    with pytest.raises(ValueError):                 # non-contiguous norms
        query_prologue(q, torch.ones((8, 2), device=cuda)[:, 0])
    with pytest.raises(ValueError):                 # norms on the host
        query_prologue(q, qn.cpu())
    with pytest.raises(ValueError):
        query_prologue(q, qn[:4])
    assert query_prologue.launches == before


def _scan_inputs(cuda, n, b, seed, config=RetrievalConfig()):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    lay = build_certified_layout(feats, None, config)
    q = torch.from_numpy(
        feats[rng.integers(0, n, b)]
        + 0.01 * rng.standard_normal((b, 12)).astype(np.float32)
    ).to(cuda)
    qn = similarity.row_norms(q)
    qh, ql = split_bf16x2_plain(q / qn[:, None])
    q2 = torch.cat([qh, ql, ql, qh], dim=1)
    return feats, lay, q, q2


@pytest.mark.parametrize("depth", [2, 3])
def test_scan_equals_plain(cuda, depth):
    # N not a multiple of the kernel's tile; B not a multiple of its 16
    _, lay, _, q2 = _scan_inputs(cuda, 20011, 40, seed=depth)
    ft = layout_to_device(lay, cuda).ft
    before = scan_v3.launches
    ov, oi, ob = scan_v3(q2, ft, w=128, depth=depth, topc=32)
    torch.cuda.synchronize()
    assert scan_v3.launches == before + 1
    pv, pi, pb = scan_v3_plain(q2, ft, w=128, depth=depth, topc=32)
    # the plain version sums the products in the kernel's order: bitwise
    assert torch.equal(oi, pi)
    assert torch.equal(ov, pv)
    assert torch.equal(ob, pb)


@pytest.mark.parametrize("w,depth", [(128, 2), (128, 3), (256, 2)])
def test_scan_64_features_equal_plain(cuda, w, depth):
    """Kernel 1 at F = 64 (the benchmark's 64-dim row): its 2F = 128 plane
    rows leave room for fewer column groups per tile than at F = 12."""
    rng = np.random.default_rng(w + depth)
    feats = rng.random((20011, 64), dtype=np.float32)
    lay = build_certified_layout(feats, None, RetrievalConfig(scan_bins=w))
    ft = layout_to_device(lay, cuda).ft
    q = torch.from_numpy(feats[rng.integers(0, 20011, 40)]).to(cuda)
    qh, ql = split_bf16x2_plain(q / similarity.row_norms(q)[:, None])
    q2 = torch.cat([qh, ql, ql, qh], dim=1)
    out = scan_v3(q2, ft, w=w, depth=depth, topc=32)
    torch.cuda.synchronize()
    for o, p in zip(out, scan_v3_plain(q2, ft, w=w, depth=depth, topc=32)):
        assert torch.equal(o, p)


@pytest.mark.parametrize("w,depth", [(256, 2), (256, 3), (384, 3), (512, 2),
                                     (512, 3), (768, 2), (1024, 2), (1024, 4)])
def test_scan_wide_bins_equal_plain(cuda, w, depth):
    """Kernel 1 at the W that `scan_bins` asks for (one bin per thread,
    fewer queries per block as W grows)."""
    _, lay, _, q2 = _scan_inputs(cuda, 20011, 40, seed=w + depth)
    ft = layout_to_device(lay, cuda).ft
    ov, oi, ob = scan_v3(q2, ft, w=w, depth=depth, topc=32)
    torch.cuda.synchronize()
    pv, pi, pb = scan_v3_plain(q2, ft, w=w, depth=depth, topc=32)
    assert torch.equal(oi, pi) and torch.equal(ov, pv) and torch.equal(ob, pb)


@pytest.mark.parametrize("w", [256, 512])
@pytest.mark.parametrize("topc", [32, 0])
def test_scan_v2_equals_plain(cuda, w, topc):
    """Kernel 4, compact and full structures: a ragged catalog, zero and
    tiny norms, exclusions, B not a multiple of the query tile."""
    feats, lay, q, q2 = _scan_inputs(cuda, 20011, 40, seed=w + topc,
                                     config=RetrievalConfig(scan="v2"))
    dl = layout_to_device(lay, cuda)
    dl.nrm_row[5] = 0.0
    dl.nrm_row[6] = 1e-12
    qn = similarity.row_norms(q)
    excl = torch.arange(40, device=cuda) * 97 - 1
    before = scan_v2.launches
    out = scan_v2(q2, qn, dl.ft, dl.nrm_row, excl, 20011, w=w, eps=1e-8,
                  topc=topc)
    torch.cuda.synchronize()
    assert scan_v2.launches == before + 1
    plain = scan_v2_plain(q2, qn, dl.ft, dl.nrm_row, excl, 20011, w=w,
                          eps=1e-8, topc=topc)
    for o, p in zip(out, plain):          # the kernel's order: bitwise
        assert torch.equal(o, p)
    assert out[0].shape == (40, topc or 3 * w)
    idx = out[1][out[1] >= 0]
    assert (idx < 20011).all()
    assert not (out[1] == excl[:, None]).any()


def test_scan_error_within_bf16x2_eps(cuda):
    feats, lay, q, q2 = _scan_inputs(cuda, 20011, 40, seed=5)
    ov, oi, _ = scan_v3(q2, layout_to_device(lay, cuda).ft, w=128, depth=2,
                        topc=32)
    f = torch.from_numpy(feats).to(cuda)
    exact = similarity.cosine_scores_batched(q, f)
    err = (ov - torch.gather(exact, 1, oi.long())).abs().max().item()
    assert err <= BF16X2_EPS, err


def assert_certified_contract(s, i, q, f, norms, rows, k=10):
    """Index for index the fixed-order oracle's over the same rows and
    norms, bitwise; against the cuBLAS oracle, scores within 1e-6 and
    indices wherever neighbouring oracle scores are more than 2e-6 apart."""
    r = torch.from_numpy(rows).to(f.device)
    fs, fi = similarity.exact_topk_chunked(q, f, norms, exclude_rows=r, k=k,
                                           fixed_order=True)
    assert torch.equal(i, fi) and torch.equal(s, fs)
    rs, ri = similarity.exact_topk_chunked(q, f, norms, exclude_rows=r, k=k)
    assert (s - rs).abs().max().item() <= 1e-6
    gaps = (rs[:, :-1] - rs[:, 1:]) > 2e-6
    ones = torch.ones_like(gaps[:, :1])
    sep = torch.cat([ones, gaps], 1) & torch.cat([gaps, ones], 1)
    sep[:, -1] = False
    assert torch.equal(i[sep], ri[sep])


def test_certified_matches_oracle_on_card(cuda):
    rng = np.random.default_rng(3)
    n, b = 30011, 64
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    cr = CertifiedRetriever(feats, None, None, cuda)
    s, i = cr(feats[rows], 10, exclude_rows=rows)
    f = torch.from_numpy(feats).to(cuda)
    assert_certified_contract(s, i, f[torch.from_numpy(rows).to(cuda)], f,
                              cr.layout.norms1d, rows)


def test_tiers_launch_one_prologue_per_batch(cuda):
    """Certified, approx and fused-bf16x2 batches each launch kernel 2's
    prologue once and the bare split never."""
    rng = np.random.default_rng(9)
    feats = rng.random((20011, 12), dtype=np.float32)
    rows = rng.integers(0, 20011, 32)
    tiers = (CertifiedRetriever(feats, None, None, cuda),
             ApproxRetriever(feats, None, None, cuda),
             FusedRetriever(feats, None, RetrievalConfig(
                 dtype="bfloat16x2", exact_scores=False), cuda))
    for tier in tiers:
        query_prologue.launches = split_bf16x2.launches = 0
        tier(feats[rows], 10, rows)
        torch.cuda.synchronize()
        assert (query_prologue.launches, split_bf16x2.launches) == (1, 0)


@pytest.mark.parametrize("config", [RetrievalConfig(scan="v2"),
                                    RetrievalConfig(scan_bins=512)])
def test_certified_wide_and_v2_match_oracle_on_card(cuda, config):
    rng = np.random.default_rng(4)
    n, b = 30011, 64
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    cr = CertifiedRetriever(feats, None, config, cuda)
    assert cr.layout.w == 512
    s, i = cr(feats[rows], 10, exclude_rows=rows)
    f = torch.from_numpy(feats).to(cuda)
    assert_certified_contract(s, i, f[torch.from_numpy(rows).to(cuda)], f,
                              cr.layout.norms1d, rows)


@pytest.mark.parametrize("f,b,k,margin,n", [
    (12, 64, 257, False, 30011), (12, 200, 1000, False, 30011),
    (64, 64, 1000, False, 30011), (12, 64, 10, True, 30011),
    (64, 200, 10, True, 30011), (12, 8, 320, False, 300)])
def test_certified_oracle_on_kernel3_bitwise_fixed_order(cuda, f, b, k,
                                                         margin, n):
    """The certified tier's oracle on kernel 3 (k > depth x W, or every
    query a fallback under an impossible margin): one call of kernel 3 on
    the batch, its indices and score bits those of the fixed-order oracles,
    over rows with copies, zero-norm rows and a zero-norm query; the
    transposed rows (30,011 columns, padded to 30,012) take 16-byte
    copies.  At k past the row count the slots no row fills are (-inf,
    -1), as the chunked oracle's."""
    rng = np.random.default_rng(f + k)
    feats = rng.random((n, f), dtype=np.float32)
    feats[rng.choice(np.arange(6, n), 40, replace=False)] = feats[5]
    feats[[0, 17, n - 1]] = 0.0
    rows = rng.integers(0, n, b)
    rows[0] = 5
    q = feats[rows] + 0.01 * rng.standard_normal((b, f)).astype(np.float32)
    q[0], q[1] = feats[5], 0.0
    config = RetrievalConfig(certify_eps=10.0) if margin else None
    cr = CertifiedRetriever(feats, None, config, cuda)
    assert copy_width(cr._oracle_ft) == 16
    before = {fn: fn.launches for fn in (fused_topk, fused_topk_large)}
    s, i = cr(q, k, exclude_rows=rows)
    torch.cuda.synchronize()
    path = fused_topk if fused_route(k, b) == "lists" else fused_topk_large
    other = fused_topk_large if path is fused_topk else fused_topk
    assert path.launches > before[path]
    assert other.launches == before[other]
    if path is fused_topk:
        assert path.launches == before[path] + 1
    assert cr.fallbacks == (b if margin else 0)
    args = (torch.from_numpy(q).to(cuda), torch.from_numpy(feats).to(cuda),
            cr.layout.norms1d[:n])
    r = torch.from_numpy(rows).to(cuda)
    # the k rounds of argmax put row 0 in the slots no row fills
    fns = ((similarity.exact_topk_chunked,) if k >= n else
           (similarity.exact_topk_chunked, similarity.exact_topk_iterative))
    for fn in fns:
        fs, fi = fn(*args, exclude_rows=r, k=k, fixed_order=True)
        assert torch.equal(i, fi)
        assert torch.equal(s.view(torch.int32), fs.view(torch.int32))
    if k >= n:
        assert ((i == -1).sum(dim=1) == k - (n - 1)).all()
        assert torch.isneginf(s[i == -1]).all()


def _split_scan_inputs(cuda, b, w, seed):
    """157 w-column groups at B = 1024, 2213 below (each slice then holds
    several groups; the last slice is ragged at every B), the w columns
    before each slice edge of the depth-2 split copied after it (ties
    across the edge), the last 2w columns zero, and queries near rows."""
    rng = np.random.default_rng(seed)
    np_ = w * (157 if b >= 1024 else 2213)
    feats = rng.random((np_, 12), dtype=np.float32)
    slice_ = scan_slice(b, np_, w, 2, cuda)
    for e in range(slice_, np_ - w + 1, slice_):
        feats[e:e + w] = feats[e - w:e]
    feats[np_ - 2 * w:] = 0.0
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    hi, lo = split_bf16x2_plain(torch.from_numpy(
        feats / np.maximum(norms, 1e-30)[:, None]))
    ft = torch.cat([hi, lo], 1).t().contiguous().to(cuda)
    q = torch.from_numpy(feats[rng.integers(0, np_ - 2 * w, b)]
                         + 0.01 * rng.standard_normal((b, 12)).astype(
                             np.float32)).to(cuda)
    qn = similarity.row_norms(q)
    qh, ql = split_bf16x2_plain(q / qn[:, None])
    excl = torch.from_numpy(rng.integers(-1, np_, b)).to(cuda)
    return torch.cat([qh, ql, ql, qh], 1), qn, ft, \
        torch.from_numpy(norms).to(cuda), excl, np_ - 3 * w // 2, slice_


@pytest.mark.parametrize("w", [128, 384, 512, 1024])
@pytest.mark.parametrize("b", [1, 5, 32, 1024])
def test_split_scans_bitwise_equal_plain(cuda, b, w):
    """Kernels 1 (depth 1-4) and 4 (compact and full) over the catalog
    split and the merge, against the single-walk plain versions."""
    q2, qn, ft, norms, excl, valid, slice_ = _split_scan_inputs(cuda, b, w,
                                                                b + w)
    assert -(-ft.shape[1] // slice_) > 1 and ft.shape[1] % slice_
    for depth in (1, 2, 3, 4):
        before = scan_v3.launches
        out = scan_v3(q2, ft, w=w, depth=depth, topc=32)
        torch.cuda.synchronize()
        assert scan_v3.launches == before + 1
        for o, p in zip(out, scan_v3_plain(q2, ft, w=w, depth=depth,
                                           topc=32)):
            assert torch.equal(o, p), (depth, (o != p).sum().item())
    for topc in (32, 0):
        before = scan_v2.launches
        out = scan_v2(q2, qn, ft, norms, excl, valid, w=w, eps=1e-8,
                      topc=topc)
        torch.cuda.synchronize()
        assert scan_v2.launches == before + 1
        plain = scan_v2_plain(q2, qn, ft, norms, excl, valid, w=w, eps=1e-8,
                              topc=topc)
        for o, p in zip(out, plain):
            assert torch.equal(o, p), (topc, (o != p).sum().item())


def _wide_inputs(cuda, np_, f, b, seed, data):
    """(q2, ft) on the card: "unit" split-plane unit rows and queries near
    them, or "exact" planes of small multiples of 1/2 and 1/128 (every
    partial sum exact, so many bins and slots tie)."""
    rng = np.random.default_rng(seed)
    if data == "unit":
        feats = rng.random((np_, f), dtype=np.float32)
        hi, lo = split_bf16x2_plain(torch.from_numpy(
            feats / np.linalg.norm(feats, axis=1, keepdims=True)))
        ft = torch.cat([hi, lo], 1).t().contiguous()
        q = feats[rng.integers(0, np_, b)] + 0.01 * rng.standard_normal(
            (b, f)).astype(np.float32)
        qh, ql = split_bf16x2_plain(torch.from_numpy(
            q / np.linalg.norm(q, axis=1, keepdims=True)))
        q2 = torch.cat([qh, ql, ql, qh], 1)
    else:
        hi = rng.integers(-2, 3, (f, np_)) / 2.0
        lo = rng.integers(-2, 3, (f, np_)) / 128.0
        qh = rng.integers(-2, 3, (b, f)) / 2.0
        ql = rng.integers(-2, 3, (b, f)) / 128.0
        ft = torch.from_numpy(np.concatenate([hi, lo]).astype(
            np.float32)).to(torch.bfloat16)
        q2 = torch.from_numpy(np.concatenate([qh, ql, ql, qh], 1).astype(
            np.float32)).to(torch.bfloat16)
    return q2.to(cuda), ft.to(cuda)


# kernel 1's shapes past the flat instances: W > 1024, depth > 4, rows too
# wide for the flat tile, a W not a power of two; (w, depth, f, b)
WIDE_SHAPES = [(2048, 2, 12, 37), (4096, 3, 12, 5), (8192, 2, 12, 1),
               (128, 5, 12, 40), (128, 6, 12, 17), (256, 8, 12, 33),
               (640, 7, 64, 9), (384, 9, 12, 3), (512, 3, 64, 19),
               (1024, 2, 64, 16), (128, 2, 256, 9), (1152, 2, 12, 20)]


@pytest.mark.parametrize("data", ["unit", "exact"])
@pytest.mark.parametrize("w,depth,f,b", WIDE_SHAPES)
def test_scan_v3_wide_route_bitwise_equals_plain(cuda, w, depth, f, b, data):
    """Kernel 1 on the wide route (bin groups, the runtime depth, row
    chunks, the merge and `srt_bin_select`) against its plain version:
    values, columns and bounds bitwise, the straddling group's columns
    (ncols) included, at topc 32, at all depth*W slots where that is at
    most 2 x 8192, and at 9000 (two selection chunks) where it is more."""
    np_ = w * max(11, -(-2048 // w))
    q2, ft = _wide_inputs(cuda, np_, f, b, w + depth + f, data)
    ncols = np_ - w // 2 - 3
    s = depth * w
    for topc in (32, s if s <= 16384 else 9000):
        assert scan_route(f, w, depth, topc) == "wide"
        before = scan_v3.launches
        out = scan_v3(q2, ft, w=w, depth=depth, topc=topc, ncols=ncols)
        torch.cuda.synchronize()
        assert scan_v3.launches == before + 1
        plain = scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc,
                              ncols=ncols)
        for o, p in zip(out, plain):
            assert torch.equal(o, p), (topc, (o != p).sum().item())
        assert (out[1] < ncols).all()


def test_scan_v3_wide_route_empty_slots_bitwise_equal_plain(cuda):
    """W = 2048 at depth 6 over W + 100 live columns: most bins hold one
    column, so the top-(depth*W) (two selection chunks) ends in empty
    slots (-inf, -1), in slot order, as the plain version's."""
    w, depth = 2048, 6
    q2, ft = _wide_inputs(cuda, 4 * w, 12, 7, 66, "unit")
    out = scan_v3(q2, ft, w=w, depth=depth, topc=depth * w, ncols=w + 100)
    torch.cuda.synchronize()
    plain = scan_v3_plain(q2, ft, w=w, depth=depth, topc=depth * w,
                          ncols=w + 100)
    for o, p in zip(out, plain):
        assert torch.equal(o, p)
    assert (out[1] == -1).sum().item() == 7 * (depth * w - w - 100)
    assert torch.isinf(out[0][out[1] == -1]).all()


@pytest.mark.parametrize("w,depth,topc", [(128, 2, 128), (128, 2, 129),
                                          (512, 3, 257), (512, 3, 1536),
                                          (1024, 4, 4096)])
def test_scan_v3_large_topc_bitwise_equals_plain(cuda, w, depth, topc):
    """A top-C past ROUNDS_MAX_TOPC takes the wide route and the radix
    selection at the flat instances' W; at the threshold the flat merge's
    rounds: both bitwise the plain version."""
    q2, ft = _wide_inputs(cuda, w * 40, 12, 21, w + topc, "exact")
    route = scan_route(12, w, depth, topc)
    assert route == ("flat" if topc <= ROUNDS_MAX_TOPC else "wide")
    out = scan_v3(q2, ft, w=w, depth=depth, topc=topc)
    torch.cuda.synchronize()
    for o, p in zip(out, scan_v3_plain(q2, ft, w=w, depth=depth, topc=topc)):
        assert torch.equal(o, p)


def test_scan_v3_batch_chunks_bitwise_equal_plain(cuda, monkeypatch):
    """A scratch ceiling that holds 16 queries a launch: 50 queries run in
    four launches, bitwise the plain version."""
    from spotify_recommender_tpu_torch.ops.cuda import scan_v3 as s3

    w, depth = 2048, 5
    monkeypatch.setattr(s3, "SCRATCH_CEILING",
                        16 * s3.slice_bytes(1, w, depth))
    assert s3.batch_chunk(50, w, depth) == 16
    q2, ft = _wide_inputs(cuda, w * 12, 12, 50, 3, "unit")
    before = scan_v3.launches
    s3.scan_plan.cache_clear()   # plans made under the patched ceiling
    try:
        out = scan_v3(q2, ft, w=w, depth=depth, topc=100)
        torch.cuda.synchronize()
    finally:
        s3.scan_plan.cache_clear()
    assert scan_v3.launches == before + 4
    for o, p in zip(out, scan_v3_plain(q2, ft, w=w, depth=depth, topc=100)):
        assert torch.equal(o, p)


@pytest.mark.parametrize("w,f,topc", [(512, 64, 32), (512, 64, 0),
                                      (2048, 12, 32), (2048, 12, 0),
                                      (512, 12, 1000)])
def test_scan_v2_wide_route_bitwise_equals_plain(cuda, w, f, topc):
    """Kernel 4 on the wide route: F = 64 at the layout's W = 512 (rows too
    wide for the flat tile), W = 2048, a top-C past the rounds; masks,
    zero and tiny norms, exclusions; compact and full structures."""
    np_ = w * 9
    q2, ft = _wide_inputs(cuda, np_, f, 23, w + f + topc, "unit")
    rng = np.random.default_rng(w + topc)
    norms = torch.from_numpy(rng.random(np_).astype(np.float32) + 0.5).to(cuda)
    norms[5], norms[6] = 0.0, 1e-12
    valid = np_ - w - 5
    norms[valid:] = 0.0
    qn = torch.from_numpy(rng.random(23).astype(np.float32) + 0.5).to(cuda)
    excl = torch.from_numpy(rng.integers(-1, valid, 23)).to(cuda)
    assert scan_route(f, w, 3, topc) == "wide"
    before = scan_v2.launches
    out = scan_v2(q2, qn, ft, norms, excl, valid, w=w, eps=1e-8, topc=topc)
    torch.cuda.synchronize()
    assert scan_v2.launches == before + 1
    plain = scan_v2_plain(q2, qn, ft, norms, excl, valid, w=w, eps=1e-8,
                          topc=topc)
    for o, p in zip(out, plain):
        assert torch.equal(o, p), (o != p).sum().item()
    assert not (out[1] == excl[:, None]).any()


DEEP = RetrievalConfig(scan_bins=2048, scan_depth=5, scan_escalate=6)


def test_certified_and_approx_at_wide_bins_and_deep_lists(cuda):
    """`RetrievalConfig(scan_bins=2048, scan_depth=5, scan_escalate=6)`
    builds and answers on the card (no ValueError): the certified tier
    index for index the fixed-order oracle at k = 10 and k = 4100, the
    approx tier at k = 4100 with every slot a real row."""
    rng = np.random.default_rng(9)
    n, b = 40000, 24
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    cr = CertifiedRetriever(feats, None, DEEP, cuda)
    assert (cr.layout.w, cr.layout.depth) == (2048, 5)
    f = torch.from_numpy(feats).to(cuda)
    q = f[torch.from_numpy(rows).to(cuda)]
    for k in (10, 4100):
        s, i = cr(feats[rows], k, exclude_rows=rows)
        fs, fi = similarity.exact_topk_chunked(
            q, f, cr.layout.norms1d[:n], exclude_rows=torch.from_numpy(
                rows).to(cuda), k=k, fixed_order=True)
        assert torch.equal(i, fi) and torch.equal(s, fs)
    ap = ApproxRetriever(feats, None, DEEP, cuda)
    s, i = ap(feats[rows], 4100, exclude_rows=rows)
    assert ((i >= 0) & (i < n)).all() and torch.isfinite(s).all()
    assert not (i == torch.from_numpy(rows).to(cuda)[:, None]).any()


def test_escalation_rescans_at_depth_6_on_card(cuda):
    """Each query's top-12 in one bin: depth 5 and the depth-6 rescan
    cannot certify k = 10, so every query is rescanned once, then served
    by the oracle (tests/test_torch_scan_shapes.py, on the card)."""
    rng = np.random.default_rng(6)
    w = 2048
    n = 12 * w
    feats = rng.random((n, 12), dtype=np.float32)
    q = np.zeros((3, 12), np.float32)
    q[:, 0] = 1.0
    for r in range(12):
        feats[7 + r * w] = 0.0
        feats[7 + r * w, :2] = [1.0, 0.01 * r]
    cr = CertifiedRetriever(feats, None, DEEP, cuda)
    s, i = cr(q, 10)
    assert cr.escalations == 3 and cr.fallbacks == 3
    assert i[0].tolist() == [7 + r * w for r in range(10)]


def _routed_counter(k, b):
    """The wrapper whose count a `fused_topk` call at (k, B) moves: the
    warp lists' or the large-k path's (`fused_route`)."""
    return fused_topk if fused_route(k, b) == "lists" else fused_topk_large


def _fused_inputs(cuda, n, b, seed, data="random", k=10):
    """Random rows with a zero-norm row and a duplicate, or a tie-heavy
    catalog of test_torch_fused_select.tie_inputs (its edges at this
    card's catalog splits on the path `fused_route` picks for (k, B))."""
    rng = np.random.default_rng(seed)
    if data == "random":
        feats = rng.random((n, 12), dtype=np.float32)
        feats[3] = 0.0                              # zero-norm row: score 0
        feats[n // 2] = feats[1]                    # duplicate: a tie
        rows = rng.integers(0, n, b)
        q = feats[rows] + 0.01 * rng.standard_normal((b, 12)).astype(np.float32)
        excl = np.where(np.arange(b) % 3 == 0, -1, rows)
    else:
        cols = (_splits(b, n, cuda, k=k)[1] if fused_route(k, b) == "lists"
                else _large_plan(b, n, cuda, fq=12, k=k, exact=True,
                                 bf16=False)[2])
        feats, q, excl = tie_inputs(data, n, b, seed,
                                    edges=range(0, n, cols))
    f = torch.from_numpy(feats).to(cuda)
    qt = torch.from_numpy(q).to(cuda)
    return f, qt, torch.from_numpy(excl).to(cuda)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n,b,k,layout,data", [
    (20011, 40, 10, "transposed", "random"),  # 20 catalog splits, 3 query tiles
    (5000, 1, 100, "transposed", "random"),   # B = 1, large k
    (9000, 17, 128, "rows", "random"),        # the largest k, a row-major view
    (50, 3, 64, "transposed", "random"),      # fewer valid columns than k
    # tie-heavy catalogs, k at the edges of the lists' 32-entry steps
    (20011, 17, 32, "transposed", "constant"),
    (20011, 5, 33, "transposed", "duplicates"),
    (20011, 1, 64, "rows", "zero_norm"),
    (20011, 40, 65, "transposed", "duplicates"),
    (20011, 1, 33, "transposed", "constant"),
    (20011, 17, 128, "transposed", "zero_norm"),
    (20011, 5, 1, "transposed", "duplicates"),
])
def test_fused_topk_bitwise_equals_plain(cuda, exact, n, b, k, layout, data):
    f, q, excl = _fused_inputs(cuda, n, b, seed=n, data=data, k=k)
    norms = similarity.row_norms(f)
    qn = similarity.row_norms(q)
    if not exact:
        f = f / norms.clamp_min(1e-30)[:, None]
        q = q / qn.clamp_min(1e-30)[:, None]
    ft = f.t().contiguous() if layout == "transposed" else f.t()
    valid = n - 7                                   # the last 7 are padding
    counter = _routed_counter(k, b)
    before = counter.launches
    ov, oi = fused_topk(q, qn, ft, norms, excl, valid, k=k, exact=exact)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    pv, pi = fused_topk_plain(q, qn, ft, norms, excl, valid, k=k, exact=exact)
    # the plain version rounds each multiply and add as the kernel does
    assert torch.equal(oi, pi)
    assert torch.equal(ov, pv)
    assert (oi < valid).all()
    assert not ((oi == excl[:, None]) & (excl[:, None] >= 0)).any()
    if valid < k:                                   # unfilled: (-inf, -1)
        assert ((oi == -1).sum(dim=1) >= k - valid).all()
        assert torch.equal(oi == -1, ov == float("-inf"))


def test_fused_topk_rejects_k_above_limit(cuda):
    """k > 128 raised before the large-k path; now it launches that path
    (its own counter, not the warp-list kernel's), bitwise its plain
    version, and k < 1 still raises."""
    f, q, excl = _fused_inputs(cuda, 300, 2, seed=0)
    args = (q, similarity.row_norms(q), f.t(), similarity.row_norms(f), excl,
            300)
    small, large = fused_topk.launches, fused_topk_large.launches
    ov, oi = fused_topk(*args, k=SMALL_K_MAX + 1, exact=True)
    torch.cuda.synchronize()
    assert fused_topk.launches == small
    assert fused_topk_large.launches == large + 1
    pv, pi = fused_topk_plain(*args, k=SMALL_K_MAX + 1, exact=True)
    assert torch.equal(oi, pi) and torch.equal(ov, pv)
    with pytest.raises(ValueError, match="k >= 1"):
        fused_topk(*args, k=0, exact=True)


LARGE_N = 20011            # valid = N - 7; the last split is partial


def _instance_operands(cuda, f, q, instance):
    """(queries, q_norms, features_t, norms) of kernel 3's instance for raw
    rows f and queries q on the card: "exact" and "prenormalized" fp32,
    "bfloat16", "bfloat16x2" (its [qh, ql, ql, qh] against [hi; lo])."""
    norms = similarity.row_norms(f)
    qn = similarity.row_norms(q)
    if instance == "exact":
        return q, qn, f.t().contiguous(), norms
    qu = q / qn.clamp_min(1e-30)[:, None]
    if instance == "prenormalized":
        fu = f / norms.clamp_min(1e-30)[:, None]
        return qu, qn, fu.t().contiguous(), norms
    fr = FusedRetriever(f.cpu().numpy(), None, RetrievalConfig(
        dtype=instance, exact_scores=False), cuda)
    if instance == "bfloat16":
        return qu.to(torch.bfloat16), qn, fr.features_t, fr.norms
    qh, ql = split_bf16x2_plain(qu)
    return torch.cat([qh, ql, ql, qh], dim=1), qn, fr.features_t, fr.norms


def _held_to_plain_large(args, k, exact):
    """The large-k path on the card, its launches counted, against the plain
    version: indices and values bitwise; returns the values."""
    b = args[0].shape[0]
    chunk = _large_plan(b, args[2].shape[1], args[0].device,
                        fq=args[0].shape[1], k=k, exact=exact,
                        bf16=args[2].dtype == torch.bfloat16)[0]
    small, large = fused_topk.launches, fused_topk_large.launches
    ov, oi = fused_topk(*args, k=k, exact=exact)
    torch.cuda.synchronize()
    assert fused_topk.launches == small
    assert fused_topk_large.launches == large + -(-b // chunk)
    pv, pi = fused_topk_plain(*args, k=k, exact=exact)
    assert torch.equal(oi, pi), (oi != pi).sum().item()
    assert torch.equal(ov, pv)
    assert torch.equal(torch.signbit(ov), torch.signbit(pv))   # -0.0 kept
    valid = args[5]
    assert (oi < valid).all()
    excl = args[4]
    assert not ((oi == excl[:, None]) & (excl[:, None] >= 0)).any()
    assert torch.equal(oi == -1, ov == float("-inf"))
    if k > valid:                                   # unfilled: (-inf, -1)
        assert ((oi == -1).sum(dim=1) >= k - valid).all()
    return ov


@pytest.mark.parametrize("b", [1, 5, 1024])
@pytest.mark.parametrize("k", [129, 256, 1000, 4096, "valid", "valid+50"])
@pytest.mark.parametrize("instance",
                         ["exact", "prenormalized", "bfloat16", "bfloat16x2"])
def test_fused_topk_large_bitwise_equals_plain(cuda, instance, k, b):
    f, q, excl = _fused_inputs(cuda, LARGE_N, b, seed=b + 3)
    valid = LARGE_N - 7
    k = {"valid": valid, "valid+50": valid + 50}.get(k, k)
    args = (*_instance_operands(cuda, f, q, instance), excl, valid)
    _held_to_plain_large(args, k, instance == "exact")


@pytest.mark.parametrize("k", [1, 10, 127, 128])
def test_fused_topk_large_path_at_small_k_bitwise_equals_plain(cuda, k):
    """`fused_topk_large` takes any k >= 1 (`fused_topk` sends it only k >
    128): the same answers at the warp lists' k, one launch each."""
    f, q, excl = _fused_inputs(cuda, 9001, 17, seed=k)
    args = (*_instance_operands(cuda, f, q, "exact"), excl, 9001 - 7)
    small, large = fused_topk.launches, fused_topk_large.launches
    ov, oi = fused_topk_large(*args, k=k, exact=True)
    torch.cuda.synchronize()
    assert fused_topk_large.launches == large + 1
    assert fused_topk.launches == small
    pv, pi = fused_topk_plain(*args, k=k, exact=True)
    assert torch.equal(oi, pi) and torch.equal(ov, pv)


def test_fused_topk_large_batch_chunks_bitwise_equal_plain(cuda):
    """A batch past the plan's scratch budget runs in chunks (two here),
    one launch each, through one scratch; bitwise as one launch would be."""
    n, k = 3001, 129
    chunk = _large_plan(10**7, n, cuda, fq=12, k=k, exact=True,
                        bf16=False)[0]
    f, q, excl = _fused_inputs(cuda, n, chunk + 5, seed=11)
    args = (*_instance_operands(cuda, f, q, "exact"), excl, n - 7)
    _held_to_plain_large(args, k, True)


def test_fused_topk_large_past_the_scratch_ceiling_bitwise_equals_plain(cuda):
    """k = 10^5 on 10^6 columns: one block's buffers take 25.6 MB, so the
    plan keeps the scratch under LARGE_SCRATCH_CEILING by one split and
    batch chunks (two launches here); bitwise the plain version."""
    n, k = 10**6, 10**5
    chunk, nsplit, _, cap = _large_plan(10**7, n, cuda, fq=12, k=k,
                                        exact=True, bf16=False)
    assert nsplit == 1 and chunk * cap * 8 <= LARGE_SCRATCH_CEILING
    f, q, excl = _fused_inputs(cuda, n, chunk + 10, seed=13)
    args = (*_instance_operands(cuda, f, q, "exact"), excl, n - 7)
    _held_to_plain_large(args, k, True)


@pytest.mark.parametrize("k", [129, 1000])
@pytest.mark.parametrize("data", LARGE_KINDS)
@pytest.mark.parametrize("instance", ["exact", "prenormalized", "bfloat16x2"])
def test_fused_topk_large_ties_and_cuts_bitwise_equal_plain(cuda, instance,
                                                             data, k):
    """Scores that rise with the column (every buffer cut again every few
    tiles), all-equal scores, duplicates across the card's split edges,
    zero-norm rows, zeros of both signs, at B = 17 (two query tiles)."""
    b = 17
    edges = range(0, LARGE_N, _large_plan(b, LARGE_N, cuda, fq=12, k=k,
                                          exact=True, bf16=False)[2])
    feats, q, excl = large_inputs(data, LARGE_N, b, seed=k + 5, edges=edges)
    f, q, excl = (torch.from_numpy(a).to(cuda) for a in (feats, q, excl))
    args = (*_instance_operands(cuda, f, q, instance), excl, LARGE_N - 7)
    _held_to_plain_large(args, k, instance == "exact")


@pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16x2"])
@pytest.mark.parametrize("n,b,k,data", [
    (20011, 40, 10, "random"), (5000, 1, 100, "random"), (50, 3, 64, "random"),
    (20011, 17, 32, "constant"), (20011, 5, 33, "duplicates"),
    (20011, 1, 64, "zero_norm"), (20011, 40, 65, "duplicates"),
    (20011, 17, 128, "duplicates"),
])
def test_fused_topk_bf16_bitwise_equals_plain(cuda, dtype, n, b, k, data):
    f, q, excl = _fused_inputs(cuda, n, b, seed=n + 1, data=data, k=k)
    fr = FusedRetriever(f.cpu().numpy(), None,
                        RetrievalConfig(dtype=dtype, exact_scores=False), cuda)
    valid = n - 7
    counter = _routed_counter(k, b)
    before = counter.launches
    ov, oi = prepare_and_call(q, excl, fr.features_t, fr.norms, valid, k=k,
                              eps=1e-8, exact=False, dtype=dtype)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    qn = similarity.row_norms(q)
    qu = q / qn.clamp_min(1e-30)[:, None]
    if dtype == "bfloat16":
        qb = qu.to(torch.bfloat16)
    else:
        qh, ql = split_bf16x2_plain(qu)
        qb = torch.cat([qh, ql, ql, qh], dim=1)
    pv, pi = fused_topk_plain(qb, qn, fr.features_t, fr.norms, excl, valid,
                              k=k, exact=False)
    # exact bf16 products added in fp32, in the kernel's order
    assert torch.equal(oi, pi)
    assert torch.equal(ov, pv)
    assert (oi < valid).all()


# ---- kernel 3's walk (cp.async-staged chunks of U groups), both paths,
# every instance and query tile, every layout the callers pass

WALK_N = 20011             # rows: a row stride not a multiple of 16 bytes


def _walk_operands(cuda, f, q, instance, layout):
    """(queries, q_norms, features_t, norms) of an instance in a layout:
    "transposed" (contiguous (Fc, N)), "rows_odd" (a row-major window from
    row 1, read through `.t()`), "slice" (columns 3.. of a wider catalog:
    a base off the 16-byte grid), "planes4" (bf16x2 as [hi; lo; hi; lo],
    Fc = Fq)."""
    n = f.shape[0]
    if layout == "slice":
        wide = torch.cat([f[:3], f], dim=0)
        qq, qn, ft, norms = _instance_operands(cuda, wide, q, instance)
        return qq, qn, ft[:, 3:], norms[3:].contiguous()
    qq, qn, ft, norms = _instance_operands(cuda, f, q, instance)
    if layout == "rows_odd":
        big = torch.cat([ft.t()[:1], ft.t()], dim=0)   # row-major (n + 1, Fc)
        return qq, qn, big[1:].t(), norms
    if layout == "planes4":
        return qq, qn, torch.cat([ft, ft], dim=0), norms
    assert layout == "transposed" and ft.shape[1] == n
    return qq, qn, ft, norms


def _walk_held_to_plain(args, k, exact, path):
    """One path of kernel 3 at (k, B) on the card, its own launches counted
    (one per batch chunk for the large-k path), against the plain version:
    indices, values and the sign of a zero bitwise."""
    fn = fused_topk_large if path == "large" else _lists_only
    counter = fused_topk_large if path == "large" else fused_topk
    before = counter.launches
    ov, oi = fn(*args, k=k, exact=exact)
    torch.cuda.synchronize()
    assert counter.launches > before
    pv, pi = fused_topk_plain(*args, k=k, exact=exact)
    assert torch.equal(oi, pi), (oi != pi).sum().item()
    assert torch.equal(ov, pv)
    assert torch.equal(torch.signbit(ov), torch.signbit(pv))
    assert torch.equal(oi == -1, ov == float("-inf"))


def _lists_only(*args, k, exact):
    """Kernel 3 through the warp lists whatever the route says."""
    from spotify_recommender_tpu_torch.ops.cuda import fused
    return fused._lists(args[0].device, *args, k, exact, COSINE_EPS)


WALK_BS = [1, 3, 4, 5, 17, 131, 1024]
WALK_KS = [1, 10, 32, 33, 64, 65, 128, 129, 1000]


@pytest.mark.parametrize("b", WALK_BS)
@pytest.mark.parametrize("k", WALK_KS)
@pytest.mark.parametrize("instance",
                         ["exact", "prenormalized", "bfloat16", "bfloat16x2"])
def test_fused_walk_every_instance_bitwise_equals_plain(cuda, instance, k, b):
    """Both paths (the warp lists at k <= SMALL_K_MAX), every storage and
    both query tiles (B <= SMALL_BATCH: 4 queries; else 16, B = 131 a
    ragged last tile), bitwise the plain version
    on the transposed layout, whose row stride (20011 columns) takes the
    8- or 4-byte copies (fp32) or one value a copy (bf16)."""
    f, q, excl = _fused_inputs(cuda, WALK_N, b, seed=k + b)
    args = (*_walk_operands(cuda, f, q, instance, "transposed"), excl,
            WALK_N - 7)
    for path in (("lists", "large") if k <= SMALL_K_MAX else ("large",)):
        _walk_held_to_plain(args, k, instance == "exact", path)


@pytest.mark.parametrize("b", [1, 5, 17, 131])
@pytest.mark.parametrize("k", [10, 65, 1000])
@pytest.mark.parametrize("instance,layout", [
    ("exact", "rows_odd"), ("prenormalized", "rows_odd"),
    ("bfloat16", "rows_odd"), ("exact", "slice"), ("bfloat16", "slice"),
    ("bfloat16x2", "slice"), ("bfloat16x2", "planes4"),
])
def test_fused_walk_layouts_bitwise_equal_plain(cuda, instance, layout, k, b):
    """A row-major window from an odd row through `.t()` (one value a
    copy), a column slice off the 16-byte grid, the 4-plane bf16x2 layout
    (48 bf16 rows: two row blocks a chunk): both paths bitwise plain."""
    f, q, excl = _fused_inputs(cuda, WALK_N, b, seed=3 * k + b)
    ops = _walk_operands(cuda, f, q, instance, layout)
    assert layout == "transposed" or copy_width(ops[2]) < 16
    args = (*ops, excl, WALK_N - 7)
    for path in (("lists", "large") if k <= SMALL_K_MAX else ("large",)):
        _walk_held_to_plain(args, k, instance == "exact", path)


@pytest.mark.parametrize("b", [1, 17, 131])
@pytest.mark.parametrize("f_dim,instance", [(64, "exact"), (64, "bfloat16"),
                                            (32, "bfloat16x2")])
def test_fused_walk_wide_rows_bitwise_equal_plain(cuda, instance, f_dim, b):
    """Rows past one stage: F = 64 fp32 (five row blocks of 13) and bf16,
    bf16x2 at F = 32 (64 planes' rows in three blocks, each walked once
    per half of the 128 query values)."""
    rng = np.random.default_rng(f_dim + b)
    n = 9001
    f = torch.from_numpy(rng.random((n, f_dim), dtype=np.float32)).to(cuda)
    rows = rng.integers(0, n, b)
    q = f[torch.from_numpy(rows).to(cuda)]
    excl = torch.from_numpy(rows).to(cuda)
    args = (*_instance_operands(cuda, f, q, instance), excl, n - 3)
    for k in (10, 129):
        for path in (("lists", "large") if k <= SMALL_K_MAX else ("large",)):
            _walk_held_to_plain(args, k, instance == "exact", path)


@pytest.mark.parametrize("b", [1, 4, 17, 131])
@pytest.mark.parametrize("k", [1, 33, 128, 1000])
@pytest.mark.parametrize("data", ["constant", "duplicates", "zero_norm"])
def test_fused_walk_ties_across_split_and_chunk_edges(cuda, data, k, b):
    """Tie-heavy catalogs with the queries' rows on both sides of every
    split edge of both plans and of every 32-column edge (so every chunk
    and group edge): both paths bitwise plain, exact and bf16x2."""
    edges = {*range(0, WALK_N, _splits(b, WALK_N, cuda,
                                       k=min(k, SMALL_K_MAX))[1]),
             *range(0, WALK_N, _large_plan(b, WALK_N, cuda, fq=12, k=k,
                                           exact=True, bf16=False)[2])}
    feats, q, excl = tie_inputs(data, WALK_N, b, seed=k + b,
                                edges=sorted(edges))
    f, q, excl = (torch.from_numpy(a).to(cuda) for a in (feats, q, excl))
    for instance in ("exact", "bfloat16x2"):
        args = (*_instance_operands(cuda, f, q, instance), excl, WALK_N - 7)
        for path in (("lists", "large") if k <= SMALL_K_MAX else ("large",)):
            _walk_held_to_plain(args, k, instance == "exact", path)


def test_fused_tiling_matches_the_wrapper_and_b1_fills_the_card(cuda):
    """The wrapper's mirror of the kernel's tiling (`tile`) is the
    library's (`srt_fused_tiling`), and B = 1 launches at least one block
    per SM on both paths (the query tile of 4)."""
    import ctypes
    lib = _build.library()
    for large in (0, 1):
        for k in ((10, 1000) if large else (1, 32, 33, SMALL_K_MAX)):
            for tq in (4, 16):
                out = (ctypes.c_int * 4)()
                _build.check(lib.srt_fused_tiling(large, k, tq, 12, 0,
                                                  ctypes.addressof(out)),
                             "srt_fused_tiling")
                assert out[0] == tile(bool(large), k, tq), (large, k, tq)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert query_tile(1) == 4
    assert _splits(1, 10**6, cuda)[0] >= sms
    assert _large_plan(1, 10**6, cuda, fq=12, k=10, exact=True,
                       bf16=False)[1] >= sms


def test_prefilter_recall_on_card(cuda):
    rng = np.random.default_rng(9)
    n, b = 30011, 64
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    pr = PrefilterRetriever(feats, None, None, cuda, prefilter=64)
    s, i = pr(feats[rows], 10, exclude_rows=rows)
    f = torch.from_numpy(feats).to(cuda)
    r = torch.from_numpy(rows).to(cuda)
    rs, ri = similarity.exact_topk_chunked(f[r], f, similarity.row_norms(f),
                                           exclude_rows=r, k=10)
    hits = sum(len(set(a) & set(c)) for a, c in zip(i.tolist(), ri.tolist()))
    assert hits / (b * 10) >= 0.99
    agree = i == ri
    assert (s - rs)[agree].abs().max().item() <= 1e-6


def _proto_inputs(cuda, n, b, width, seed, data="unit"):
    """The prototypes' inputs on the card: unit split planes of uniform
    rows (width 24: [qh, ql] against [hi; lo]; 48: [qh, ql, ql, qh]
    against [hi; lo; hi; lo]) or standard-normal planes, with raw norms."""
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    feats[3] = 0.0
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    hi, lo = split_bf16x2_plain(torch.from_numpy(
        feats / np.maximum(norms, 1e-30)[:, None]))
    qr = feats[rng.integers(0, n, b)]
    qn = np.linalg.norm(qr, axis=1).astype(np.float32)
    qh, ql = split_bf16x2_plain(torch.from_numpy(qr / qn[:, None]))
    if width == 24:
        q, ft = torch.cat([qh, ql], 1), torch.cat([hi, lo], 1).t()
    else:
        q, ft = torch.cat([qh, ql, ql, qh], 1), torch.cat([hi, lo, hi, lo],
                                                          1).t()
    if data == "normal":
        q = torch.from_numpy(rng.standard_normal(
            (b, width), dtype=np.float32)).to(torch.bfloat16)
        ft = torch.from_numpy(rng.standard_normal(
            (width, n), dtype=np.float32)).to(torch.bfloat16)
    return (q.contiguous().to(cuda), ft.contiguous().to(cuda),
            torch.from_numpy(qn).to(cuda), torch.from_numpy(norms).to(cuda))


@pytest.mark.parametrize("data", ["unit", "normal"])
def test_mxu_only_within_derived_tolerance_of_plain(cuda, data):
    """The tensor-core kernel sums in its own order: within qw * 2^-22 * S
    of the plain version's sequential fp32 sum (`mxu_only_tolerance`)."""
    q, ft, _, _ = _proto_inputs(cuda, 20480, 40, 48, 1, data)
    before = proto_scans.mxu_only.launches
    out = proto_scans.mxu_only(q, ft)
    torch.cuda.synchronize()
    assert proto_scans.mxu_only.launches == before + 1
    diff = (out - proto_scans.mxu_only_plain(q, ft)).abs()
    assert bool((diff <= proto_scans.mxu_only_tolerance(q, ft)).all())


@pytest.mark.parametrize("qw", [16, 24, 48])
@pytest.mark.parametrize("b", [1, 63, 1024])
def test_mxu_only_shapes_one_launch(cuda, qw, b):
    """qw rounds up to the wgmma's 16 (TMA's zero rows past qw, though
    the catalog has 48); ragged query blocks; Np = 37 tiles of 128, so
    the last catalog slice is partial.  One launch each."""
    q, ft, _, _ = _proto_inputs(cuda, 128 * 37, b, 48, qw + b, "normal")
    q = q[:, :qw].contiguous()
    before = proto_scans.mxu_only.launches
    out = proto_scans.mxu_only(q, ft)
    torch.cuda.synchronize()
    assert proto_scans.mxu_only.launches == before + 1
    assert out.shape == (b, 128) and bool(torch.isfinite(out).all())
    diff = (out - proto_scans.mxu_only_plain(q, ft)).abs()
    assert bool((diff <= proto_scans.mxu_only_tolerance(q, ft)).all())


@pytest.mark.parametrize("kind", ["split", "normal", "cancel"])
def test_mxu_only_single_dots_within_one_rounding_per_addition(cuda, kind):
    """Np = 128: each output is one dot, within qw * 2^-23 * S of the
    exact sum (the bf16 operands in fp64): the bound of any fp32
    accumulation that rounds each addition once, to nearest or toward
    zero."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, ft = kernel_r3.study_inputs(kind, 4096, g, cuda)
    out = proto_scans.mxu_only(q, ft).double()
    exact = q.double() @ ft.double()
    s = q.double().abs() @ ft.double().abs()
    assert bool(((out - exact).abs() <= q.shape[1] * 2.0**-23 * s).all())


@pytest.mark.parametrize("data", ["unit", "normal"])
@pytest.mark.parametrize("w", [128, 256, 512, 1024])
def test_scan_d1_bitwise_equals_plain(cuda, data, w):
    q, ft, _, _ = _proto_inputs(cuda, 20480, 40, 48, w, data)
    before = proto_scans.scan_d1.launches
    out = proto_scans.scan_d1(q, ft, w=w)
    torch.cuda.synchronize()
    assert proto_scans.scan_d1.launches == before + 1
    for o, p in zip(out, proto_scans.scan_d1_plain(q, ft, w=w)):
        assert torch.equal(o, p)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("w", [256, 512])
def test_scan_d1_split_equals_single_walk(cuda, b, w):
    """The catalog split and its merge against the single walk and the
    plain versions, bitwise; duplicated columns tie across slices."""
    q, ft, _, _ = _proto_inputs(cuda, 1 << 18, b, 48, b + w)
    ft[:, 1 << 17:(1 << 17) + 4096] = ft[:, :4096]
    before = proto_scans.scan_d1_split.launches
    split = proto_scans.scan_d1(q, ft, w=w, invert=True)
    torch.cuda.synchronize()
    assert proto_scans.scan_d1_split.launches == before + 1
    single = proto_scans.scan_d1(q, ft, w=w)
    for s, o, p, pp in zip(split, single,
                           proto_scans.scan_d1_plain(q, ft, w=w),
                           proto_scans.scan_d1_split_plain(q, ft, w=w)):
        assert torch.equal(s, o) and torch.equal(s, p) and torch.equal(s, pp)


def test_scan3_bitwise_equals_plain(cuda):
    q, ft, qn, cn = _proto_inputs(cuda, 20480, 40, 24, 3)
    cn[5] = 1e-12                                   # guarded: scores 0
    before = proto_scans.scan3.launches
    out = proto_scans.scan3(q, qn[:, None], ft, cn[None, :])
    torch.cuda.synchronize()
    assert proto_scans.scan3.launches == before + 1
    for o, p in zip(out, proto_scans.scan3_plain(q, qn, ft, cn)):
        assert torch.equal(o, p)


@pytest.mark.parametrize("w", [256, 512])
def test_proto_scan_bitwise_equals_plain(cuda, w):
    n, b, valid = 20480, 40, 20011
    q, ft, qn, cn = _proto_inputs(cuda, n, b, 24, w)
    excl = (torch.arange(b, device=cuda, dtype=torch.int32) * 97 - 1)[:, None]
    before = proto_scans.proto_scan.launches
    out = proto_scans.proto_scan(q, qn, ft, cn, excl, valid, w=w)
    torch.cuda.synchronize()
    assert proto_scans.proto_scan.launches == before + 1
    plain = proto_scans.proto_scan_plain(q, qn, ft, cn, excl, valid, w=w)
    for o, p in zip(out, plain):
        assert torch.equal(o, p)
    assert (out[1] < valid).all() and not (out[1] == excl).any()


# ---- TPU kernels 5-8: every case of the four ablation launchers, at its
# own tc (to 65,536), its storage and stored F; (launcher, case, body,
# storage, tc, F stored, index output?, width)
ABLATION_CASES = [
    *[("r2", n, kernel_ablation_r2.KERNELS[n], torch.float32,
       kernel_ablation_r2.TC, 12, True, kernel_ablation_r2.K)
      for n in ("dotonly", "widemax", "vertmax", "verttop2")],
    *[("r2b", n, body, dt, kernel_ablation_r2b.TC, 12, True,
       kernel_ablation_r2b.K)
      for n, (body, dt) in kernel_ablation_r2b.KERNELS.items()],
    *[(mod.__name__[-3:], n, body, dt, tc, fs, False, ablation.LANES)
      for mod in (kernel_ablation_r2c, kernel_ablation_r2d)
      for n, (body, dt, _, tc, fs, *_) in mod.CASES.items()],
]


def _ablation_args(cuda, b, fs, np_, dtype, seed):
    """Scaled unit rows whose dots straddle +-1, zero-norm columns, a
    ragged last tile (zero features and norms: e_div's 0 / 0), exclusions;
    the padded feature rows zero, as the mains store them."""
    rng = np.random.default_rng(seed)
    f = 12 if fs in (12, 16) else 24
    valid = np_ - 100
    q = np.zeros((b, fs), np.float32)
    ft = np.zeros((fs, np_), np.float32)
    q[:, :f] = rng.standard_normal((b, f))
    ft[:f] = rng.standard_normal((f, np_))
    q *= rng.uniform(0.9, 1.4, (b, 1)) / np.linalg.norm(q, axis=1,
                                                         keepdims=True)
    ft *= rng.uniform(0.9, 1.4, (1, np_)) / np.linalg.norm(ft, axis=0,
                                                           keepdims=True)
    ft[:, rng.integers(0, valid, 40)] = 0.0
    ft[:, valid:] = 0.0
    qn = np.linalg.norm(q, axis=1, keepdims=True).astype(np.float32)
    cn = np.linalg.norm(ft, axis=0, keepdims=True).astype(np.float32)
    excl = rng.integers(-1, valid, (b, 1)).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda) for a in (q, qn, ft, cn, excl)]
    return t[0].to(dtype), t[1], t[2].to(dtype), t[3], t[4], valid


@pytest.mark.parametrize(
    "launcher,name,body,dtype,tc,fs,index,width", ABLATION_CASES,
    ids=[f"{c[0]}-{c[1]}" for c in ABLATION_CASES])
def test_ablation_body_bitwise_equals_plain(cuda, launcher, name, body, dtype,
                                            tc, fs, index, width):
    """Kernel against plain, outputs and per-tile digest, NaN-aware; B not
    a multiple of the kernel's 16, two tiles of the case's tc."""
    args = _ablation_args(cuda, 40, fs, 2 * tc, dtype, seed=tc + fs)
    before = body.launches
    *out, dig = body(*args, tc=tc, width=width, index=index, digest=True)
    torch.cuda.synchronize()
    assert body.launches == before + 1
    *pout, pdig = body.plain(*args, tc=tc, width=width, index=index,
                             digest=True)
    assert len(out) == (2 if index else 1) and dig[0].shape == (40, 2)
    for o, p in zip([*out, *dig], [*pout, *pdig]):
        assert ablation.nan_equal(o, p)
    if body.name == "r2b.e_div":
        assert torch.isnan(out[0]).all()
    else:
        assert not torch.isnan(dig[0]).any()


def test_ablation_full_r1_equals_plain(cuda):
    """full_r1 is kernel 3 (exact): bitwise its plain version."""
    args = _ablation_args(cuda, 40, 12, 8192, torch.float32, seed=1)
    before = fused_topk.launches
    s, i = kernel_ablation_r2.run_variant(*args, name="full_r1", k=16,
                                          tc=8192)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    ps, pi = kernel_ablation_r2.run_variant(*args, name="full_r1", k=16,
                                            tc=8192, plain=True)
    assert torch.equal(s, ps) and torch.equal(i, pi) and i.dtype == torch.int32


# the 14 kernel instances of csrc/ablation_r2.cu, each through the first
# body that runs it: (epilogue, reduction, storage) -> body
ABLATION_INSTANCES = {}
for _c in ABLATION_CASES:
    ABLATION_INSTANCES.setdefault((_c[2].epi, _c[2].reduce, _c[3]), _c[2])
_INSTANCE_IDS = [f"{b.name}-{'bf16' if dt == torch.bfloat16 else 'f32'}"
                 for (_, _, dt), b in ABLATION_INSTANCES.items()]
_INSTANCES = [(b, dt) for (_, _, dt), b in ABLATION_INSTANCES.items()]
_TOP2 = [(b, dt) for b, dt in _INSTANCES if b.reduce == ablation.TOP2]


def _edge_args(cuda, b, f, np_, dtype, seed, nan_at=()):
    """f rows of scaled normal values whose dots straddle +-1, zero-norm
    columns, masked columns past valid = np - 50, exclusions, and NaN at
    the (row, column) pairs `nan_at` (the norms taken before, so finite)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, f)).astype(np.float32)
    ft = rng.standard_normal((f, np_)).astype(np.float32)
    q *= rng.uniform(0.9, 1.4, (b, 1)) / np.linalg.norm(q, axis=1,
                                                         keepdims=True)
    ft *= rng.uniform(0.9, 1.4, (1, np_)) / np.linalg.norm(ft, axis=0,
                                                           keepdims=True)
    ft[:, rng.integers(0, np_, 8)] = 0.0
    qn = np.linalg.norm(q, axis=1, keepdims=True).astype(np.float32)
    cn = np.linalg.norm(ft, axis=0, keepdims=True).astype(np.float32)
    for r, c in nan_at:
        ft[r, c] = np.nan
    excl = rng.integers(-1, np_, (b, 1)).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda) for a in (q, qn, ft, cn, excl)]
    return t[0].to(dtype), t[1], t[2].to(dtype), t[3], t[4], np_ - 50


def _held_to_plain(body, args, tc, width=16, index=True):
    """One launch, bitwise (NaN-aware) its plain version, outputs and
    per-tile digest; returns the kernel's outputs and digest."""
    before = body.launches
    *out, dig = body(*args, tc=tc, width=width, index=index, digest=True)
    torch.cuda.synchronize()
    assert body.launches == before + 1
    *pout, pdig = body.plain(*args, tc=tc, width=width, index=index,
                             digest=True)
    for o, p in zip([*out, *dig], [*pout, *pdig]):
        assert ablation.nan_equal(o, p)
    return out, dig


def test_ablation_instances_are_the_libraries_fourteen(cuda):
    """Every instance is reached, scores at least 2 groups a step, and an SM
    holds at least 2 of its blocks at the widest F (64) and at the mains'
    widths."""
    assert len(ABLATION_INSTANCES) == 14
    for body, dt in _INSTANCES:
        assert body.tiling(12, dt)["u"] >= 2, (body.name, dt)
        for f in (12, 16, 24, 32, 64):
            assert body.blocks_per_sm(f, dt) >= 2, (body.name, dt, f)


@pytest.mark.parametrize("off,pad", [(1, 16), (8, 9), (1, 9)],
                         ids=["base", "stride", "both"])
@pytest.mark.parametrize("body,dtype", _INSTANCES, ids=_INSTANCE_IDS)
def test_ablation_unaligned_catalog_bitwise_equal_plain(cuda, body, dtype,
                                                        off, pad):
    """A catalog view whose base (off 1) or row stride (pad 9), or both, is
    not a multiple of 16 bytes (the kernel's cp.async copies) is read
    through an aligned copy: bitwise its plain version; the NaN around the
    view shows a read outside it."""
    tc, np_ = 384, 768
    q, qn, ft, cn, excl, valid = _edge_args(cuda, 17, 5, np_, dtype, seed=off)
    wide = torch.full((5, np_ + pad), float("nan"), dtype=dtype, device=cuda)
    view = wide[:, off:off + np_]
    view.copy_(ft)
    _held_to_plain(body, (q, qn, view, cn, excl, valid), tc)


@pytest.mark.parametrize("body,dtype", _INSTANCES, ids=_INSTANCE_IDS)
def test_ablation_negative_norms_bitwise_equal_plain(cuda, body, dtype):
    """Query norms of both signs in every query tile (and one 0) against a
    first tile of negative catalog norms and a second of both signs: the
    GUARD bodies zero every score whose qn * cn is not above eps, so a
    query with qn > 0 against cn < 0 scores 0 even where the block's
    smallest qn times cn passes; bitwise the plain version."""
    tc, np_ = 512, 1024
    q, qn, ft, cn, excl, valid = _edge_args(cuda, 37, 12, np_, dtype,
                                            seed=5)
    sign = torch.ones(37, 1, device=cuda)
    sign[1::2] = -1.0
    qn = qn * sign
    qn[4] = 0.0
    cn = cn.clone()
    cn[:, :tc] = -cn[:, :tc]
    cn[:, tc + 1::3] = -cn[:, tc + 1::3]
    _held_to_plain(body, (q, qn, ft, cn, excl, valid), tc)


@pytest.mark.parametrize("f", [1, 5, 64])
@pytest.mark.parametrize("b", [1, 17])
@pytest.mark.parametrize("tc", [128, 384, 640])
@pytest.mark.parametrize("body,dtype", _INSTANCES, ids=_INSTANCE_IDS)
def test_ablation_instance_shapes_bitwise_equal_plain(cuda, body, dtype, tc,
                                                      b, f):
    """tc = 128 (one group), 384 and 640 (3 and 5 groups: a last chunk of
    1 group at U = 2 and U = 4), B = 1 and 17 (a partial query tile), F =
    1, 5 and 64 (64 spans several stages of a chunk), two tiles."""
    args = _edge_args(cuda, b, f, 2 * tc, dtype, seed=tc + 7 * b + f)
    _held_to_plain(body, args, tc)


@pytest.mark.parametrize("f", [12, 64])
@pytest.mark.parametrize("body,dtype", _TOP2,
                         ids=[f"{b.name}-{dt}" for b, dt in _TOP2])
def test_ablation_top2_ties_across_chunks_and_stages(cuda, body, dtype, f):
    """Equal columns in one lane at groups (1, 2), (3, 4), (5, 6), (7, 8)
    and (11, 12), each pair in its own lane: across a chunk boundary at U
    = 2 and at U = 4, and across the ring's wrap for 2 or 3 stages of
    either U; a three-way tie (0, 9, 15) beside them.  Each tied column is
    the query direction scaled to 0.99, the lane's best score."""
    tc, b = 2048, 17
    q, qn, ft, cn, excl, valid = _edge_args(cuda, b, f, 2 * tc,
                                            torch.float32, seed=f)
    target = q[0] / q[0].norm() * 0.99
    for tile in (0, 1):
        for lane, groups in enumerate([(1, 2), (3, 4), (5, 6), (7, 8),
                                       (11, 12), (0, 9, 15)]):
            for g in groups:
                ft[:, tile * tc + 128 * g + 3 + 10 * lane] = target
    cn = ft.norm(dim=0, keepdim=True)
    excl = torch.full_like(excl, -1)
    args = (q.to(dtype), qn, ft.to(dtype), cn, excl, 2 * tc)
    out, dig = _held_to_plain(body, args, tc)
    assert (dig[1] > 0).all()


@pytest.mark.parametrize("body,dtype", _INSTANCES, ids=_INSTANCE_IDS)
def test_ablation_nan_catalog_entry(cuda, body, dtype):
    """A NaN catalog value in group 0 of lane 3 and in group 2 of lane 9
    (tile 0), and in group 1 of lane 5 (tile 1): MAX lets NaN win, TOP2
    keeps a group-0 NaN as v1 and never takes a later one."""
    tc = 512
    nan_at = [(0, 3), (1, 2 * 128 + 9), (0, tc + 128 + 5)]
    args = _edge_args(cuda, 17, 12, 2 * tc, dtype, seed=11, nan_at=nan_at)
    out, dig = _held_to_plain(body, args, tc)
    if body.reduce == ablation.MAX and not body.epi & ablation.MASK:
        assert torch.isnan(dig[0]).all()


@pytest.mark.parametrize("body,dtype",
                         [(b, dt) for b, dt in _INSTANCES
                          if dt == torch.bfloat16],
                         ids=[i for i, (b, dt) in zip(_INSTANCE_IDS, _INSTANCES)
                              if dt == torch.bfloat16])
def test_ablation_bf16_contracts_with_fma(cuda, body, dtype):
    """q = (2^-75, 2^-75) against the column (2^-74, 2^-75), every other
    column zero, unit norms: the fused chain gives 2^-149 + 2^-150 rounded
    once = 2^-148 (ties to even); rounding the product 2^-150 first gives
    2^-149.  The kernel equals the plain version and differs from the
    old multiply-then-add chain."""
    tc, b = 256, 3
    q = torch.full((b, 2), 2.0**-75, dtype=dtype, device=cuda)
    ft = torch.zeros((2, 2 * tc), dtype=dtype, device=cuda)
    ft[0, tc + 7], ft[1, tc + 7] = 2.0**-74, 2.0**-75
    qn = torch.ones((b, 1), device=cuda)
    cn = torch.ones((1, 2 * tc), device=cuda)
    excl = torch.full((b, 1), -1, dtype=torch.int32, device=cuda)
    out, dig = _held_to_plain(body, (q, qn, ft, cn, excl, 2 * tc), tc)
    qf, ff = q.float(), ft.float()
    old = qf[:, :1] * ff[:1, tc + 7] + qf[:, 1:] * ff[1:, tc + 7]
    assert (old == 2.0**-149).all()
    assert (dig[0][:, 1] == 2.0**-148).all()
    assert (dig[0][:, 0] == 0).all()


# ---------------------------------------------------------------- MF path
# (models/mf.py: no kernel of its own; torch.bmm, cuSOLVER's batched
# Cholesky and the fp32 matrix product, held to the CPU port)


def _mf_half_inputs(seed, n=3000, m=800, md=24, d=32):
    rng = np.random.default_rng(seed)
    other = (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)
    idx = rng.integers(0, m, (n, md)).astype(np.int32)
    conf = (1 + rng.poisson(2.0, (n, md))).astype(np.float32)
    mask = rng.random((n, md)) < 0.7
    mask[:4] = False
    return [torch.from_numpy(a) for a in (other, idx, conf, mask)]


@pytest.mark.parametrize("solve_block", [0, 1024])
def test_mf_als_half_step_equals_cpu(cuda, solve_block):
    from spotify_recommender_tpu_torch.models import mf

    args = _mf_half_inputs(solve_block)
    cpu = mf._als_solve(*args, 0.05, 10.0, solve_block=solve_block)
    card = mf._als_solve(*[a.to(cuda) for a in args], 0.05, 10.0,
                         solve_block=solve_block)
    assert (card.cpu() - cpu).abs().max().item() <= 1e-4
    assert not card[:4].any()


def test_mf_mips_topk_chunked_equals_cpu(cuda):
    rng = np.random.default_rng(0)
    items = (rng.standard_normal((20000, 64)) / 8).astype(np.float32)
    q = (rng.standard_normal((300, 64)) / 8).astype(np.float32)
    seen = rng.integers(0, 20000, (300, 18)).astype(np.int32)
    sm = rng.random((300, 18)) < 0.9
    args = [torch.from_numpy(a) for a in (q, items, seen, sm)]
    cs, ci = similarity.mips_topk_chunked(*args, k=10, chunk=4096)
    gs, gi = similarity.mips_topk_chunked(*[a.to(cuda) for a in args], k=10,
                                          chunk=4096)
    assert torch.equal(gi.cpu(), ci)
    assert (gs.cpu() - cs).abs().max().item() <= 1e-6


def test_mf_sgd_on_the_card_near_cpu(cuda):
    """The gathers' backward adds with atomics on the card, so the card
    equals the CPU only within a tolerance (1e-3 after 20 steps)."""
    from spotify_recommender_tpu_torch.core.config import MFConfig
    from spotify_recommender_tpu_torch.models import mf

    inter, _, _ = mf.synthetic_interactions(2000, 1000, 8, seed=0)
    cfg = MFConfig(embedding_dim=16, reg=0.05, alpha=10.0, learning_rate=0.01)
    cu, ci = mf.train_sgd(inter, cfg, num_steps=20, device="cpu")
    gu, gi = mf.train_sgd(inter, cfg, num_steps=20, device=cuda)
    assert np.isfinite(gu).all() and np.isfinite(gi).all()
    assert np.abs(gu - cu).max() <= 1e-3 and np.abs(gi - ci).max() <= 1e-3


def test_mf_failed_cholesky_raises_on_the_card(cuda):
    """lambda = 0, an empty row and a zero column: singular normal
    matrices; cholesky_ex's info makes the half-step raise."""
    from spotify_recommender_tpu_torch.models import mf

    other, idx, conf, mask = _mf_half_inputs(1, n=64, m=40, md=6, d=8)
    other[:, 3] = 0.0
    with pytest.raises(torch.linalg.LinAlgError, match="Cholesky"):
        mf._als_solve(*[a.to(cuda) for a in (other, idx, conf, mask)], 0.0, 10.0)


@pytest.mark.parametrize("b,w,depth", [(40, 128, 2), (40, 128, 3), (1, 128, 2),
                                       (1024, 128, 2), (40, 512, 2)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_scan_with_ncols_bitwise_equals_plain(cuda, b, w, depth, sign):
    """Kernel 1 given the catalog's real column count: the pad columns
    never enter a bin (anti-aligned queries, sign -1, would otherwise fill
    every bin with them), bitwise its plain version; a count inside a W
    group and one that stops short of the last slices too."""
    feats, lay, _, q2 = _scan_inputs(
        cuda, 20011, b, seed=b + w + depth,
        config=RetrievalConfig(scan_bins=w))
    ft = layout_to_device(lay, cuda).ft
    if sign < 0:
        q2 = torch.cat([-q2[:, :24], q2[:, 24:]], 1)   # [-qh, -ql | ...]
    for ncols in (20011, 20011 - 300, 777, 0):
        before = scan_v3.launches
        out = scan_v3(q2, ft, w=w, depth=depth, topc=32, ncols=ncols)
        torch.cuda.synchronize()
        assert scan_v3.launches == before + 1
        plain = scan_v3_plain(q2, ft, w=w, depth=depth, topc=32, ncols=ncols)
        for o, p in zip(out, plain):
            assert torch.equal(o, p), ncols
        assert (out[1] < ncols).all()
        # every one of the 32 slots holds a real column, if there is one
        assert bool((out[1] >= 0).all()) == (ncols > 0)
        assert bool((out[1] == -1).all()) == (ncols == 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_two_tower_on_the_card_near_cpu(cuda, compute_dtype):
    """The towers' embeddings on the card against the CPU from the same
    weights: fp32 within 1e-5 (TF32 off; cuBLAS sums in another order);
    bf16 within one bf16 rounding of the row's largest entry (2^-7 of it,
    plus 1e-5): where the two sums under a hidden unit's bf16 rounding
    straddle a boundary, the unit moves by one bf16 step and every output
    of the row moves with it, so a small entry can move by far more than
    its own rounding."""
    from spotify_recommender_tpu_torch.core.config import TwoTowerConfig
    from spotify_recommender_tpu_torch.models import two_tower

    cfg = TwoTowerConfig(compute_dtype=compute_dtype)
    params = two_tower.init_params(cfg, 12, torch.Generator().manual_seed(0))
    params = two_tower.params_from_jax(two_tower.params_to_jax(params))
    x = np.random.default_rng(0).random((4096, 12), dtype=np.float32)
    for fn in (two_tower.embed_catalog, two_tower.embed_queries):
        card = fn(params, x, cfg, device=cuda)
        cpu = fn(params, x, cfg, device="cpu")
        if compute_dtype == "float32":
            np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-5)
        else:
            scale = np.abs(cpu).max(axis=1, keepdims=True)
            assert (np.abs(card - cpu) <= 2.0**-7 * scale + 1e-5).all()
    res = two_tower.train(x, np.arange(4096) % 7, TwoTowerConfig(
        num_steps=20, compute_dtype=compute_dtype), device=cuda)
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]


# ---------------------------------------------------------- data layer, sharding


def test_native_parser_builds_and_parses_on_the_card_host(cuda, tmp_path):
    """The card's machine builds native/csv_parser.cpp with g++ (into a
    fresh root, timed by chip_smoke.py phase 2) and its parse equals the
    Python parse."""
    from spotify_recommender_tpu_torch.data import csv_ingest, native_ingest

    so = native_ingest.build(tmp_path)
    assert so.exists() and so.parent.name == native_ingest.source_hash()
    hdr = ("track_id,track_name,artists,danceability,energy,key,loudness,"
           "mode,speechiness,acousticness,instrumentalness,liveness,valence,"
           "tempo,track_genre")
    lines = [f"t{i},Song {i},A,0.{i},0.5,C#,-{i},Minor,0.1,0.2,0.3,0.4,0.5,"
             f"{90 + i},g{i % 3}" for i in range(50)] + ["short,row"]
    nat = native_ingest.parse_csv_rows_native(hdr, lines)
    py = csv_ingest.parse_csv_rows(hdr, lines)
    assert nat.num_valid_rows == py.num_valid_rows == 50
    assert list(nat.track_ids) == list(py.track_ids)
    assert nat.genre_names == py.genre_names
    np.testing.assert_array_equal(nat.raw_features, py.raw_features)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("backend", ["certified", "pallas"])
def test_sharded_backends_on_the_card_equal_single_card(cuda, backend, shards):
    """S shards on the one card (a mesh over a repeated device): the
    certified backend (one prologue for the card, kernel 1 per shard)
    bitwise the single-card
    certified tier, kernel 3 per shard (exact fp32) its indices and
    scores; launches counted per shard; exclusions at the shard borders."""
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh
    from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog

    rng = np.random.default_rng(shards)
    n = 50_003
    feats = rng.random((n, 12), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    mesh = make_mesh(MeshConfig(catalog=shards), devices=[cuda] * shards)
    sc = ShardedCatalog(feats, norms, mesh, use_certified=backend == "certified",
                        use_pallas=backend == "pallas")
    rows = rng.integers(0, n, 64)
    border = [c * sc.n_local + o for c in range(1, shards) for o in (-1, 0)]
    rows[:len(border)] = border
    q = torch.from_numpy(feats[rows]).to(cuda)
    excl = torch.from_numpy(rows).to(cuda)
    query_prologue.launches = scan_v3.launches = fused_topk.launches = 0
    s, i = sc.retrieve(q, 10, excl)
    torch.cuda.synchronize()
    if backend == "certified":
        # one prologue for the one device, shared by its shards
        assert query_prologue.launches == 1 and scan_v3.launches >= shards
    else:
        assert fused_topk.launches == shards
    rs, ri = CertifiedRetriever(feats, norms, None, cuda)(q, 10, excl)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert not bool((i == excl[:, None]).any())
    s1, i1 = sc.retrieve(q[:1], 10, excl[:1])
    assert torch.equal(i1, ri[:1])


# --------------------------------------------------------------------------
# The training half of sharding, autotune, debug, the graft entry
# --------------------------------------------------------------------------


def _card_mesh(data=1, catalog=1):
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh

    return make_mesh(MeshConfig(data=data, catalog=catalog),
                     devices=[torch.device("cuda:0")] * (data * catalog))


def test_sharded_embedding_lookup_and_gradient_on_the_card(cuda):
    from spotify_recommender_tpu_torch.parallel.embedding import (
        ShardedEmbeddingTable,
    )

    rng = np.random.default_rng(0)
    dense = torch.from_numpy(rng.standard_normal((10_003, 16)).astype(
        np.float32)).to(cuda)
    table = ShardedEmbeddingTable(dense, _card_mesh(catalog=4))
    ids = torch.from_numpy(rng.choice(10_003, 512, replace=False)).to(cuda)
    assert torch.equal(table.lookup(ids), dense[ids])
    with pytest.raises(IndexError):
        table.lookup(torch.tensor([10_003], device=cuda))
    up = torch.randn((512, 16), device=cuda)
    for sh in table.shards:
        sh.requires_grad_(True)
    (table.lookup(ids) * up).sum().backward()
    want = torch.zeros((table.padded_vocab, 16), device=cuda).index_add_(
        0, ids, up)
    rows = table.padded_vocab // 4
    for c, sh in enumerate(table.shards):
        assert torch.equal(sh.grad, want[c * rows:(c + 1) * rows])


@pytest.mark.parametrize("shard_tables,atol", [(False, 1e-5), (True, 1e-4)])
def test_sharded_als_on_the_card_near_single_card(cuda, shard_tables, atol):
    from spotify_recommender_tpu_torch.core.config import MFConfig
    from spotify_recommender_tpu_torch.models import mf

    inter, _, _ = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=1)
    cfg = MFConfig(embedding_dim=16, num_iterations=3, reg=0.05, alpha=10.0)
    u1, i1 = mf.train_als(inter, cfg, device=cuda)
    u, i = mf.train_als(inter, cfg, mesh=_card_mesh(catalog=4),
                        shard_tables=shard_tables)
    np.testing.assert_allclose(u, u1, rtol=0, atol=atol)
    np.testing.assert_allclose(i, i1, rtol=0, atol=atol)


def test_dp_steps_on_the_card_near_single_card(cuda):
    from spotify_recommender_tpu_torch.core.config import MFConfig, TwoTowerConfig
    from spotify_recommender_tpu_torch.models import mf, two_tower

    inter, _, _ = mf.synthetic_interactions(300, 200, 6, density=0.05, seed=2)
    cfg = MFConfig(embedding_dim=16, batch_size=1024, learning_rate=0.01)
    a, b = [], []
    mf.train_sgd(inter, cfg, num_steps=10, device=cuda, losses=a)
    mf.train_sgd(inter, cfg, num_steps=10, mesh=_card_mesh(data=4), losses=b)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)
    rng = np.random.default_rng(0)
    feats = rng.random((400, 12)).astype(np.float32)
    genres = (np.arange(400) % 4).astype(np.int32)
    tcfg = TwoTowerConfig(embedding_dim=16, hidden_dims=(32,), batch_size=64,
                          num_steps=3, learning_rate=3e-3)
    s1, s4 = {}, {}
    two_tower.train(feats, genres, tcfg, device=cuda, stats=s1)
    two_tower.train(feats, genres, tcfg, mesh=_card_mesh(data=4), stats=s4)
    np.testing.assert_allclose(s4["loss"], s1["loss"], rtol=0, atol=1e-5)


def test_autotune_on_the_card(cuda, tmp_path, monkeypatch):
    from spotify_recommender_tpu_torch.ops import autotune

    monkeypatch.setenv("SRT_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    before = scan_v3.launches
    res = autotune.tune(n=50_000, b=64, k=10, iters=2, reps=1, device=cuda,
                        grid=((2, 3, 128, 256, 8192), (2, 3, 256, 256, 8192),
                              (2, 3, 2048, 256, 8192),
                              (2, 3, 128, 256, 1000)))
    assert scan_v3.launches > before
    # a catalog tile that is not a multiple of 128 pads the catalog to
    # 50,000 columns, which no W divides; W = 2048 answers
    [failed] = res.failed
    assert failed["catalog_tile"] == 1000 and "ValueError" in failed["error"]
    assert any(c["scan_bins"] == 2048 and c["error"] is None
               for c in res.candidates)
    assert res.saved and autotune.load_tuned(50_000, 64, 12, 10,
                                             device=cuda) is not None


def test_nan_guard_and_graft_entry_on_the_card(cuda):
    from spotify_recommender_tpu_torch import graft_entry
    from spotify_recommender_tpu_torch.core.debug import nan_guard

    x = torch.tensor([1.0, 0.0], device=cuda)
    with pytest.raises(FloatingPointError):
        with nan_guard():
            x / x
    before = scan_v3.launches
    fn, args = graft_entry.entry()
    s, i = fn(*args)
    assert scan_v3.launches > before
    want = CertifiedRetriever(args[3].cpu().numpy(), None,
                              RetrievalConfig(scan_bins=256, prefilter=32),
                              cuda)(args[0], 10, args[6])
    assert torch.equal(i, want[1]) and torch.equal(s, want[0])
    graft_entry.dryrun_multichip(2)
