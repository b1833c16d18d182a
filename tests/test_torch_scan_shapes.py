"""The bin scans at every shape the JAX package takes (W above 1024, depth
above 4, wide feature rows, a large top-C), on the CPU.

- Kernel 1's plain version (`scan_v3` on CPU tensors) against the JAX
  package's `_scan_call_v3` in interpret mode, and kernel 4's
  (`scan_v2`) against `_scan_call`, at each listed (W, depth, F):
  * on unit rows and queries (the tiers' inputs): values and bounds
    within 1e-6 and indices equal, as tests/test_torch_kernels.py holds
    them (both sum the same 4F exact products, in different orders); at F
    = 64 the two orders of 256 products swap near-ties, so there indices
    are held where both neighbours' JAX values are more than 2e-6 apart
    (tests/test_torch_approx.py's rule); at F = 256 two orders of 1024
    products part by more than 1e-6, so that shape runs on the exact
    inputs alone;
  * on "exact" inputs, planes of small multiples of 1/2 and 1/128 whose
    every partial sum is exact in fp32 in any order: values and bounds
    bitwise, indices equal, with many ties.
- The kernels' schedule repeated in torch (`split_bin_structures`: batch
  chunks, bin groups, catalog slices, and the row chunks of
  `wide_stage`) is bitwise `bin_structures`; the radix selection of
  `srt_bin_select` step by step in numpy (`emulate_bin_select`) is
  bitwise `top_slots`, -0.0, ties and empty slots included.
- `scan_route`, `scan_slice`, `batch_chunk` keep to the kernels' limits
  and to the scratch ceiling.
- The tiers: the port's `CertifiedRetriever` / `ApproxRetriever` on the
  CPU at `scan_bins=2048`, `scan_depth=5`, `scan_escalate=6` against the
  JAX retrievers in interpret mode (k = 10, 64) and the fixed-order
  oracle, and at k above 4096 against the oracle (the JAX scan unrolls one argmax round a
  candidate while it traces, so that k does not trace there in a test's
  time); the layouts equal to the JAX layouts at W = 2048 and 8192.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotify_recommender_tpu.core.config import RetrievalConfig as JConfig
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    ApproxRetriever as JaxApprox,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    CertifiedRetriever as JaxCertified,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    _scan_call,
    _scan_call_v3,
)
from spotify_recommender_tpu.ops.pallas.fused_topk import (
    build_certified_layout as jax_layout,
)
from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.ops import similarity as tsim
from spotify_recommender_tpu_torch.ops.cuda import scan_v3 as s3
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import DEPTH, scan_v2
from spotify_recommender_tpu_torch.ops.cuda.split import split_bf16x2
from spotify_recommender_tpu_torch.ops.fused_topk import (
    BF16X2_EPS,
    ApproxRetriever,
    CertifiedRetriever,
    build_certified_layout,
)

CPU = torch.device("cpu")
ATOL = 1e-6
B = 16
# (W, depth, F): kernel 1's shapes past the flat instances' caps
SHAPES = [(2048, 2, 12), (4096, 3, 12), (8192, 2, 12), (128, 6, 12),
          (256, 8, 12), (512, 3, 64), (1024, 2, 64), (128, 2, 256)]


def jbf16(t):
    return jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16)


def unit_case(seed, n, f, w, tc):
    """A JAX-built 2-plane layout of `n` uniform rows and split-plane unit
    queries near catalog rows."""
    rng = np.random.default_rng(seed)
    feats = rng.random((n, f), dtype=np.float32)
    lay = jax_layout(feats, None, JConfig(catalog_tile=tc, split_planes=2,
                                          scan_bins=w))
    assert lay.w == w
    q = feats[rng.integers(0, n, B)] + 0.01 * rng.standard_normal(
        (B, f)).astype(np.float32)
    qh, ql = split_bf16x2(torch.from_numpy(
        q / np.linalg.norm(q, axis=1, keepdims=True)))
    return (torch.cat([qh, ql, ql, qh], 1),
            torch.from_numpy(lay.ft).to(torch.bfloat16))


def exact_case(seed, np_, f):
    """Planes whose products and partial sums are exact in fp32 in any
    order: hi, qh in {-1, -1/2, 0, 1/2, 1}, lo, ql in {-2..2} / 128."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(-2, 3, (f, np_)) / 2.0
    lo = rng.integers(-2, 3, (f, np_)) / 128.0
    qh = rng.integers(-2, 3, (B, f)) / 2.0
    ql = rng.integers(-2, 3, (B, f)) / 128.0
    ft = torch.from_numpy(np.concatenate([hi, lo]).astype(np.float32))
    q2 = torch.from_numpy(np.concatenate([qh, ql, ql, qh], 1).astype(
        np.float32))
    return q2.to(torch.bfloat16), ft.to(torch.bfloat16)


def separated(scores, sep=2e-6):
    """Positions whose neighbouring scores (both sides) are > `sep` apart;
    the last position's right neighbour is unknown, so it is left out."""
    gap = np.diff(scores, axis=1) < -sep
    edge = np.ones((len(scores), 1), bool)
    keep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
    keep[:, -1] = False
    return keep


def assert_indices(got, want, want_v, near_ties):
    """Indices equal, or (`near_ties`) equal where `separated`."""
    got = np.asarray(got)
    if near_ties:
        keep = separated(np.asarray(want_v))
        assert keep.mean() > 0.5
        np.testing.assert_array_equal(got[keep], np.asarray(want)[keep])
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def assert_close(got, want, atol):
    """The same -inf pattern; finite values within `atol`."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("w,depth,f,kind", [
    *[(*shape, "exact") for shape in SHAPES],
    *[(*shape, "unit") for shape in SHAPES if shape[2] <= 64]])
def test_scan_v3_plain_matches_pallas(w, depth, f, kind):
    tc = max(w, 1024)
    if kind == "unit":
        q2, ft = unit_case(w + depth + f, 2 * tc - 37, f, w, tc)
    else:
        q2, ft = exact_case(w * depth + f, 2 * tc, f)
    v, i, bound = s3.scan_v3(q2, ft, w=w, depth=depth, topc=32)
    jv, ji, jb = map(np.asarray, _scan_call_v3(
        jbf16(q2), jbf16(ft), tq=B, tc=tc, w=w, depth=depth, topc=32,
        interpret=True))
    assert_indices(i, ji, jv, kind == "unit" and f > 12)
    atol = ATOL if kind == "unit" else 0.0
    assert_close(v, jv, atol)
    assert_close(bound, jb, atol)
    assert s3.scan_route(f, w, depth, 32) == "wide"


@pytest.mark.parametrize("topc", [32, 0])
@pytest.mark.parametrize("kind", ["unit", "exact"])
def test_scan_v2_plain_matches_pallas_wide_rows(kind, topc):
    """Kernel 4 at F = 64, W = 512 (the layout's W): exclusions, a ragged
    catalog, zero rows; topc = 0 is the full (B, 3W) / (B, W) structures."""
    f, w, tc = 64, 512, 1024
    rng = np.random.default_rng(topc + len(kind))
    n = 2 * tc - 41
    if kind == "unit":
        feats = rng.random((n, f), dtype=np.float32)
        feats[5] = 0.0
        lay = jax_layout(feats, None, JConfig(scan="v2", catalog_tile=tc,
                                              split_planes=2))
        q = feats[rng.integers(0, n, B)] + 0.01 * rng.standard_normal(
            (B, f)).astype(np.float32)
        qn = tsim.row_norms(torch.from_numpy(q))
        qh, ql = split_bf16x2(torch.from_numpy(q) / qn[:, None])
        q2 = torch.cat([qh, ql, ql, qh], 1)
        ft = torch.from_numpy(lay.ft).to(torch.bfloat16)
        norms = torch.from_numpy(lay.nrm_row[0])
    else:
        q2, ft = exact_case(topc + 7, 2 * tc, f)
        qn = torch.ones(B)
        norms = torch.ones(2 * tc)
        norms[n:] = 0.0
    excl = rng.integers(-1, n, B)
    excl[:2] = [5, -1]
    v, i, bound = scan_v2(q2, qn, ft, norms, torch.from_numpy(excl), n, w=w,
                          eps=1e-8, topc=topc)
    jv, ji, jb = map(np.asarray, _scan_call(
        jbf16(q2), jnp.asarray(qn.numpy()[:, None]), jbf16(ft),
        jnp.asarray(norms.numpy()[None, :]),
        jnp.asarray(excl[:, None].astype(np.int32)),
        jnp.full((1, 1), n, jnp.int32),
        tq=B, tc=tc, w=w, eps=1e-8, topc=topc, interpret=True))
    assert_indices(i, ji, jv, kind == "unit" and topc > 0)
    atol = ATOL if kind == "unit" else 0.0
    assert_close(v, jv, atol)
    assert_close(bound, jb, atol)
    assert s3.scan_route(f, w, DEPTH, topc) == "wide"
    if topc == 0:
        assert v.shape == (B, 3 * w) and bound.shape == (B, w)


@pytest.mark.parametrize("w,depth,groups,chunk,slice_groups", [
    (2048, 2, 16, None, 3), (1024, 6, 8, 5, 4), (256, 8, 2, 4, 2),
    (512, 3, 4, 3, 5), (128, 5, 1, 2, 1),
])
def test_schedule_bitwise_equals_bin_structures(w, depth, groups, chunk,
                                                slice_groups):
    """Batch chunks, bin groups of w / groups bins and slices of
    `slice_groups` w-column groups (a ragged last one), on exact inputs
    with many ties and a block of -inf (masked) columns."""
    q2, ft = exact_case(w + depth, 11 * w, 12)
    q2 = q2[:13]
    scores = s3.split_plane_dots(q2, ft)
    scores[:, 3 * w:4 * w] = float("-inf")
    got = s3.split_bin_structures(scores, w, depth, slice_groups * w,
                                  groups=groups, chunk=chunk)
    want = s3.bin_structures(scores, w, depth)
    for g, x in zip(got, want):
        assert g.shape == x.shape and torch.equal(g, x)


@pytest.mark.parametrize("f,depth", [(12, 2), (64, 3), (256, 2), (256, 6),
                                     (64, 9)])
def test_row_chunks_keep_the_dot_order(f, depth):
    """The wide route's row chunks (`wide_stage`) sum each column's 4F
    products chunk after chunk, feature j ascending: bitwise the plain
    dots, which sum them in that order."""
    fc, smem = s3.wide_stage(f, depth)
    assert 1 <= fc <= f and smem <= s3.SMEM_LIMIT
    rng = np.random.default_rng(f)
    q = rng.standard_normal((5, f)).astype(np.float32)
    c = rng.standard_normal((300, f)).astype(np.float32)
    qh, ql = split_bf16x2(torch.from_numpy(q))
    hi, lo = split_bf16x2(torch.from_numpy(c))
    q2 = torch.cat([qh, ql, ql, qh], 1)
    ft = torch.cat([hi, lo], 1).t().contiguous()
    acc = torch.zeros((5, 300))
    for j0 in range(0, f, fc):
        for j in range(j0, min(f, j0 + fc)):
            for a, b in ((qh, hi), (ql, lo), (ql, hi), (qh, lo)):
                acc.addcmul_(a[:, j:j + 1].float(), b[:, j][None, :].float())
    assert torch.equal(acc, s3.split_plane_dots(q2, ft))


SELECT_CHUNK = 8192   # keys srt_bin_select sorts at a time (csrc/scan_wide.cu)


def slot_keys(sv: np.ndarray) -> np.ndarray:
    """The 64-bit keys by which `srt_bin_select` (csrc/scan_wide.cu) ranks
    (B, S) slot values: the value's order-preserving bits (-0.0 as +0.0,
    NaN lowest) over the inverted slot, so that key order is value
    descending, slot ascending, and no two keys of a row are equal."""
    sv = np.asarray(sv, np.float32)
    u = sv.view(np.uint32).copy()
    u[sv == 0] = 0
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    u[np.isnan(sv)] = 0
    slots = np.arange(sv.shape[1], dtype=np.uint64)
    return (u.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - slots)


def emulate_bin_select(sv, si, sb, topc: int, chunk: int = SELECT_CHUNK):
    """`srt_bin_select` step by step in numpy: per query and per chunk of
    `chunk` outputs, the radix select of the chunk's last key below the
    previous chunk's (8 bits a pass, from the top), then the keys at or
    above it, sorted.  Returns what `top_slots` returns, as numpy."""
    keys = slot_keys(sv)
    si = np.asarray(si)
    b = keys.shape[0]
    ov = np.empty((b, topc), np.float32)
    oi = np.empty((b, topc), np.int32)
    for q in range(b):
        k, upper = keys[q], None
        for lo in range(0, topc, chunk):
            c = min(chunk, topc - lo)
            prefix = mask = np.uint64(0)
            rank = c
            live = k if upper is None else k[k < upper]
            for shift in map(np.uint64, range(56, -1, -8)):
                digits = (live[(live & mask) == prefix] >> shift) & np.uint64(255)
                hist = np.bincount(digits.astype(np.int64), minlength=256)
                above = 0
                for d in range(255, -1, -1):
                    if above < rank <= above + hist[d]:
                        prefix |= np.uint64(d) << shift
                        rank -= above
                        break
                    above += hist[d]
                mask |= np.uint64(255) << shift
            sel = np.sort(live[live >= prefix])[::-1]
            assert sel.size == c
            slot = (np.uint64(0xFFFFFFFF) - (sel & np.uint64(0xFFFFFFFF))
                    ).astype(np.int64)
            ov[q, lo:lo + c] = np.asarray(sv, np.float32)[q, slot]
            oi[q, lo:lo + c] = si[q, slot]
            upper = prefix
    return ov, oi, np.asarray(sb).max(axis=1, keepdims=True)


@pytest.mark.parametrize("topc,chunk", [(500, 8192), (300, 64), (17, 5),
                                        (640, 128)])
def test_radix_selection_bitwise_equals_top_slots(topc, chunk):
    """`srt_bin_select`'s keys and passes in numpy: -0.0 ties +0.0 (by
    slot), equal values by slot, empty slots (-inf, -1) last but in slot
    order, chunks of `chunk` outputs each below the last."""
    rng = np.random.default_rng(topc + chunk)
    sv = (rng.integers(-3, 4, (4, 640)) / 2.0).astype(np.float32)
    sv[0, :40] = -0.0
    sv[1, ::7] = -np.inf
    sv[2] = 0.0
    si = rng.integers(0, 10**6, (4, 640)).astype(np.int32)
    si[np.isinf(sv)] = -1
    sb = rng.random((4, 64)).astype(np.float32)
    got = emulate_bin_select(sv, si, sb, topc, chunk)
    want = s3.top_slots(*map(torch.from_numpy, (sv, si, sb)), topc)
    for g, x in zip(got, want):
        assert np.array_equal(g.view(np.uint32) if g.dtype == np.float32
                              else g, x.numpy().view(np.uint32)
                              if g.dtype == np.float32 else x.numpy())
    keys = slot_keys(sv)
    assert (np.diff(np.sort(keys, axis=1), axis=1) > 0).all()   # no ties


@pytest.mark.parametrize("f,w,depth,topc,route", [
    (12, 128, 2, 32, "flat"), (12, 1024, 4, 64, "flat"),
    (12, 128, 2, 129, "wide"), (12, 128, 4, 5000, "wide"),
    (64, 256, 3, 32, "flat"), (12, 1152, 2, 32, "wide"),
    (12, 128, 5, 32, "wide"), (64, 512, 3, 32, "wide"),
    (32, 1024, 2, 32, "wide"), (128, 256, 2, 32, "wide"),
    (256, 128, 2, 0, "wide"), (12, 512, 3, 257, "wide"),
])
def test_scan_route(f, w, depth, topc, route):
    """Flat wherever the flat instances take the shape (their W, depth and
    shared memory, the rounds' top-C): the shapes measured before this
    route existed keep their kernels."""
    assert s3.scan_route(f, w, depth, topc) == route
    assert s3.flat_fits(f, w) == (2 * f * 4 * (s3.queries_per_block(w) + w)
                                  <= s3.SMEM_LIMIT)


@pytest.mark.parametrize("b,np_,w,depth", [
    (1024, 1_048_576, 4096, 2), (1024, 1_048_576, 8192, 2),
    (1024, 1_048_576, 8192, 8), (1, 1_048_576, 8192, 2),
    (32, 1_048_576, 128, 6), (1024, 1_048_576, 2048, 3),
    (100_000, 65_536, 2048, 2), (4096, 1 << 24, 8192, 4),
])
def test_scan_slice_and_chunks_keep_the_scratch_ceiling(b, np_, w, depth):
    """Per launch (a batch chunk): a multiple of w, at most 65,535 slices,
    the scratch under SCRATCH_CAP or one slice under SCRATCH_CEILING (or
    one query), and the card's SMs covered where the catalog allows."""
    chunk = s3.batch_chunk(b, w, depth)
    assert 1 <= chunk <= b and (chunk == b or chunk % 16 == 0 or chunk < 16)
    slice_ = s3.scan_slice(chunk, np_, w, depth, CPU, "wide")
    slices = -(-np_ // slice_)
    assert slice_ % w == 0 and 1 <= slices <= s3.MAX_SLICES
    scratch = slices * s3.slice_bytes(chunk, w, depth)
    assert scratch <= s3.SCRATCH_CAP or (
        slices == 1 and (scratch <= s3.SCRATCH_CEILING or chunk == 1))
    blocks = -(-chunk // s3.wide_tiling(depth)[0]) * (w // 128) * slices
    if np_ // w >= s3.MIN_SLICE_GROUPS * 8:
        assert blocks >= s3.H100_SMS


def test_batch_chunk_at_the_ceiling():
    # 1024 queries at W = 8192, depth 8: 557 KiB of scratch a query, so
    # 960 a launch; depth 2 fits the batch in one
    assert s3.batch_chunk(1024, 8192, 8) == 960
    assert s3.batch_chunk(1024, 8192, 2) == 1024
    assert s3.slice_bytes(1024, 8192, 4) * 1 <= s3.SCRATCH_CEILING


def _oracle(feats, norms, q, k, excl=None):
    return tsim.exact_topk_iterative(
        torch.from_numpy(q), torch.from_numpy(feats), torch.from_numpy(norms),
        exclude_rows=None if excl is None else torch.from_numpy(excl),
        k=k, fixed_order=True)


DEEP = dict(scan_bins=2048, scan_depth=5, scan_escalate=6)


def _deep_case(seed, n=8192, b=4):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    rows = rng.integers(0, n, b).astype(np.int32)
    return feats, norms, rows


def test_certified_tier_matches_jax_at_wide_bins_and_deep_lists():
    """W = 2048, depth 5, escalation to 6: the port's certified tier equals
    the fixed-order oracle index for index and the JAX tier in interpret
    mode.  (The JAX scan unrolls one argmax round a candidate while it
    traces, so k above 4096 does not trace there in minutes: that k is
    held to the oracle below.)"""
    k = 10
    feats, norms, rows = _deep_case(k)
    q = feats[rows]
    cr = CertifiedRetriever(feats, norms, RetrievalConfig(**DEEP), CPU)
    assert (cr.layout.w, cr.layout.depth, cr._esc) == (2048, 5, 6)
    s, i = cr(q, k, rows)
    fs, fi = _oracle(feats, norms, q, k, rows)
    assert torch.equal(i, fi) and torch.equal(s, fs)
    js, ji = JaxCertified(feats, norms, JConfig(**DEEP), interpret=True)(
        q, k, exclude_rows=rows)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    assert cr.fallbacks == 0


def test_certified_tier_past_4096_answers_from_the_scan():
    """k = 4100 at W = 2048, depth 5 (capacity 10,240, past the 4 x 1024
    the port took before): no oracle-only route (the scan runs, its 4100
    candidates cannot certify k = 4100, so the rescan and the oracle
    serve it); the answer is the fixed-order oracle's, bitwise."""
    feats, norms, rows = _deep_case(4100)
    q = feats[rows]
    cr = CertifiedRetriever(feats, norms, RetrievalConfig(**DEEP), CPU)
    s, i = cr(q, 4100, rows)
    fs, fi = _oracle(feats, norms, q, 4100, rows)
    assert torch.equal(i, fi) and torch.equal(s, fs)
    assert cr.escalations == 4 and cr.fallbacks == 4
    assert not cr._large_k_warned


def test_escalation_rescans_at_depth_6():
    """Each query's top-12 in one bin (column 7 of 12 W-column groups, with
    distinct cosines above every other row's): depth 5 cannot certify k =
    10 (its bound is the bin's 6th value), nor can the depth-6 rescan (the
    7th), so each query is rescanned once at depth 6, then served by the
    oracle; the answer is the oracle's."""
    rng = np.random.default_rng(6)
    w = 2048
    n = 12 * w
    feats = rng.random((n, 12), dtype=np.float32)
    q = np.zeros((3, 12), np.float32)
    q[:, 0] = 1.0
    for r in range(12):
        feats[7 + r * w] = 0.0
        feats[7 + r * w, :2] = [1.0, 0.01 * r]
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    cr = CertifiedRetriever(feats, norms, RetrievalConfig(**DEEP), CPU)
    assert cr.layout.w == w
    s, i = cr(q, 10)
    fs, fi = _oracle(feats, norms, q, 10)
    assert torch.equal(i, fi) and torch.equal(s, fs)
    assert cr.escalations == 3 and cr.fallbacks == 3
    assert i[0].tolist() == [7 + r * w for r in range(10)]


def test_approx_tier_matches_jax_at_wide_bins_and_deep_lists():
    """W = 2048, depth 5, k = 64: the port's approx tier on the CPU against
    JAX's in interpret mode (scores within 1e-6, indices where separated);
    every slot a real row other than the excluded one."""
    rng = np.random.default_rng(41)
    n, k = 8192, 64
    feats = (rng.integers(0, 256, (n, 12)) / 256).astype(np.float32)
    rows = rng.integers(0, n, 3).astype(np.int32)
    q = feats[rows]
    ts, ti = ApproxRetriever(feats, None, RetrievalConfig(**DEEP), CPU)(
        q, k, rows)
    js, ji = map(np.asarray, JaxApprox(feats, None, JConfig(**DEEP),
                                       interpret=True)(
        jnp.asarray(q), k, exclude_rows=jnp.asarray(rows)))
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=ATOL)
    assert_indices(ti, ji, js, True)
    assert ((ti >= 0) & (ti < n)).all()
    assert not (ti == torch.from_numpy(rows)[:, None].long()).any()


def test_approx_tier_past_4096():
    """k = 4100 at W = 2048, depth 5 (the JAX tier's trace at that k is
    too long for a test, see above): every slot a real row, the scores of
    the rows it shares with the fixed-order oracle within BF16X2_EPS of
    the oracle's, recall@4100 >= 0.99."""
    feats, norms, rows = _deep_case(4101, b=3)
    q = feats[rows]
    ts, ti = ApproxRetriever(feats, norms, RetrievalConfig(**DEEP), CPU)(
        q, 4100, rows)
    fs, fi = _oracle(feats, norms, q, 4100, rows)
    assert ((ti >= 0) & (ti < 8192)).all() and torch.isfinite(ts).all()
    assert not (ti == torch.from_numpy(rows)[:, None].long()).any()
    both = ti[:, :, None] == fi[:, None, :]
    assert both.any(dim=2).float().mean().item() >= 0.99
    err = (ts[:, :, None] - fs[:, None, :]).abs()[both].max().item()
    assert err <= BF16X2_EPS


@pytest.mark.parametrize("bins,n", [(2048, 8192), (8192, 20000),
                                    (2048, 70000), (8192, 3000)])
def test_layout_equals_jax_layout_at_wide_bins(bins, n):
    """W past 1024 as the JAX layout builds it (halved until it divides the
    catalog tile: 3000 rows give a 3072-column tile, so W = 1024)."""
    feats = np.random.default_rng(bins + n).random((n, 12), dtype=np.float32)
    t = build_certified_layout(feats, None, RetrievalConfig(scan_bins=bins))
    j = jax_layout(feats, None, JConfig(scan_bins=bins))
    assert (t.w, t.depth, t.np_pad) == (j.w, j.depth, j.np_pad)
    np.testing.assert_array_equal(t.ft, j.ft[:24])


def test_sharded_certified_tier_at_wide_bins(tmp_path):
    """The sharded certified tier at `scan_bins=2048` on 4 CPU shards of
    8192 rows, built from a sharded artifact per shard (the W of
    parallel/sharding.py's `from_artifact`) and from the rows: W = 2048
    as the JAX package's `from_artifact` derives it, the fixed-order
    oracle's answer bitwise, the JAX tier's indices in interpret mode."""
    from spotify_recommender_tpu.core.config import MeshConfig as JMeshConfig
    from spotify_recommender_tpu.core.mesh import make_mesh as jmake_mesh
    from spotify_recommender_tpu.data.catalog import Catalog as JCatalog
    from spotify_recommender_tpu.data.sharded_catalog import (
        load_sharded_catalog as jload,
    )
    from spotify_recommender_tpu.data.sharded_catalog import (
        save_sharded_catalog as jsave,
    )
    from spotify_recommender_tpu.parallel.sharding import (
        ShardedCatalog as JSharded,
    )
    from spotify_recommender_tpu_torch.core.config import MeshConfig
    from spotify_recommender_tpu_torch.core.mesh import make_mesh
    from spotify_recommender_tpu_torch.data.catalog import Catalog
    from spotify_recommender_tpu_torch.data.sharded_catalog import (
        load_sharded_catalog,
        save_sharded_catalog,
    )
    from spotify_recommender_tpu_torch.parallel.sharding import ShardedCatalog

    rng = np.random.default_rng(2048)
    n, shards, cfg = 32700, 4, dict(scan_bins=2048)
    feats = rng.random((n, 12), dtype=np.float32)
    fields = dict(
        features=feats, norms=np.linalg.norm(feats, axis=1).astype(np.float32),
        track_ids=np.asarray([f"t{i}" for i in range(n)], object),
        track_names=np.asarray([f"s{i}" for i in range(n)], object),
        artists=np.asarray(["a"] * n, object),
        genre_ids=np.zeros(n, np.int32), genre_names=["g"],
        min_vals=np.zeros(11, np.float32), max_vals=np.ones(11, np.float32))
    save_sharded_catalog(Catalog(**fields), str(tmp_path / "t"),
                         shard_multiple=shards * 8192)
    mesh = make_mesh(MeshConfig(catalog=shards), devices=[CPU] * shards)
    sc = ShardedCatalog.from_artifact(
        load_sharded_catalog(str(tmp_path / "t"), mesh), mesh,
        config=RetrievalConfig(**cfg))
    direct = ShardedCatalog(feats, fields["norms"], mesh, use_certified=True,
                            config=RetrievalConfig(**cfg))
    rows = rng.integers(0, n, 6)
    q = feats[rows]
    s, i = sc.retrieve(q, 10, rows)
    fs, fi = _oracle(feats, fields["norms"], q, 10, rows)
    assert torch.equal(i, fi) and torch.equal(s, fs)
    ds, di = direct.retrieve(q, 10, rows)
    assert torch.equal(di, fi) and torch.equal(ds, fs)
    jsave(JCatalog(**fields), str(tmp_path / "j"), shard_multiple=shards * 8192)
    jmesh = jmake_mesh(JMeshConfig(data=1, catalog=shards))
    jsc = JSharded.from_artifact(jload(str(tmp_path / "j"), jmesh), jmesh,
                                 config=JConfig(**cfg), interpret=True)
    assert sc.w == direct.w == jsc.w == 2048
    js, ji = jsc.retrieve(jnp.asarray(q), 10,
                          exclude_rows=jnp.asarray(rows.astype(np.int32)))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=ATOL)
