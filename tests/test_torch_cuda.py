"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`; each test skips (from a fixture) where torch sees no CUDA
device.  The card's machine has no JAX, so run this file without the
suite's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q

These repeat, at a small size, the split and scan phases of chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import scan_v3, scan_v3_plain
from spotify_recommender_tpu_torch.ops.cuda.split import (
    split_bf16x2,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.fused_topk import (
    BF16X2_EPS,
    CertifiedRetriever,
    build_certified_layout,
    layout_to_device,
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


def _scan_inputs(cuda, n, b, seed):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 12), dtype=np.float32)
    lay = build_certified_layout(feats, None, RetrievalConfig())
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


def test_scan_error_within_bf16x2_eps(cuda):
    feats, lay, q, q2 = _scan_inputs(cuda, 20011, 40, seed=5)
    ov, oi, _ = scan_v3(q2, layout_to_device(lay, cuda).ft, w=128, depth=2,
                        topc=32)
    f = torch.from_numpy(feats).to(cuda)
    exact = similarity.cosine_scores_batched(q, f)
    err = (ov - torch.gather(exact, 1, oi.long())).abs().max().item()
    assert err <= BF16X2_EPS, err


def test_certified_matches_oracle_on_card(cuda):
    rng = np.random.default_rng(3)
    n, b = 30011, 64
    feats = rng.random((n, 12), dtype=np.float32)
    rows = rng.integers(0, n, b)
    cr = CertifiedRetriever(feats, None, None, cuda)
    s, i = cr(feats[rows], 10, exclude_rows=rows)
    f = torch.from_numpy(feats).to(cuda)
    norms = torch.from_numpy(np.linalg.norm(feats, axis=1)).to(cuda)
    r = torch.from_numpy(rows).to(cuda)
    rs, ri = similarity.exact_topk_chunked(f[r], f, norms, exclude_rows=r, k=10)
    assert torch.equal(i, ri)
    # rerank (gathered bmm) and oracle (matmul) sum in different orders
    assert (s - rs).abs().max().item() <= 1e-6
