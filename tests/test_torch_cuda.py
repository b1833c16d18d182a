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
from test_torch_fused_select import tie_inputs

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.experiments import (
    kernel_ablation_r2,
    kernel_ablation_r2b,
    kernel_ablation_r2c,
    kernel_ablation_r2d,
)
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.cuda import ablation, proto_scans
from spotify_recommender_tpu_torch.ops.cuda.fused import (
    _splits,
    fused_topk,
    fused_topk_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import scan_v2, scan_v2_plain
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import (
    scan_slice,
    scan_v3,
    scan_v3_plain,
)
from spotify_recommender_tpu_torch.ops.cuda.split import (
    split_bf16x2,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.fused_topk import (
    BF16X2_EPS,
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


def _fused_inputs(cuda, n, b, seed, data="random", k=10):
    """Random rows with a zero-norm row and a duplicate, or a tie-heavy
    catalog of test_torch_fused_select.tie_inputs (its edges at this
    card's catalog splits for k)."""
    rng = np.random.default_rng(seed)
    if data == "random":
        feats = rng.random((n, 12), dtype=np.float32)
        feats[3] = 0.0                              # zero-norm row: score 0
        feats[n // 2] = feats[1]                    # duplicate: a tie
        rows = rng.integers(0, n, b)
        q = feats[rows] + 0.01 * rng.standard_normal((b, 12)).astype(np.float32)
        excl = np.where(np.arange(b) % 3 == 0, -1, rows)
    else:
        edges = range(0, n, _splits(b, n, cuda, k=k)[1])
        feats, q, excl = tie_inputs(data, n, b, seed, edges=edges)
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
    before = fused_topk.launches
    ov, oi = fused_topk(q, qn, ft, norms, excl, valid, k=k, exact=exact)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
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
    f, q, excl = _fused_inputs(cuda, 300, 2, seed=0)
    with pytest.raises(ValueError, match="128"):
        fused_topk(q, similarity.row_norms(q), f.t(), similarity.row_norms(f),
                   excl, 300, k=129, exact=True)


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
    before = fused_topk.launches
    ov, oi = prepare_and_call(q, excl, fr.features_t, fr.norms, valid, k=k,
                              eps=1e-8, exact=False, dtype=dtype)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
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
def test_mxu_only_bitwise_equals_plain(cuda, data):
    q, ft, _, _ = _proto_inputs(cuda, 20480, 40, 48, 1, data)
    before = proto_scans.mxu_only.launches
    out = proto_scans.mxu_only(q, ft)
    torch.cuda.synchronize()
    assert proto_scans.mxu_only.launches == before + 1
    assert torch.equal(out, proto_scans.mxu_only_plain(q, ft))


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
    certified backend (kernels 2 and 1 per shard) bitwise the single-card
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
    split_bf16x2.launches = scan_v3.launches = fused_topk.launches = 0
    s, i = sc.retrieve(q, 10, excl)
    torch.cuda.synchronize()
    if backend == "certified":
        assert split_bf16x2.launches == shards and scan_v3.launches >= shards
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
                              (2, 3, 2048, 256, 8192)))
    assert scan_v3.launches > before
    [failed] = res.failed              # W = 2048: the kernels take W <= 1024
    assert failed["scan_bins"] == 2048 and "ValueError" in failed["error"]
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
