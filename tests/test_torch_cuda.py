"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The file imports no JAX (the card's machine has none); each test
decides inside itself whether a card is present and skips without one.
Run on the card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

A kernel and its plain version widen the same inputs to fp32 and differ
only in summation order, so in both dtypes each output (m, l, acc, the
normalised attention, the scores) must agree to 1e-4 of its largest
magnitude: tight enough that a dropped 32-key tile fails.  The masked
sentinel m = -1e30 must match exactly.  (The reference's 3e-2 bf16
tolerance is for comparisons with JAX, whose q scaling differs.)  fp32
results are compared, so the fixture turns TF32 off for matmuls and
convolutions (the plain versions' products).
"""
import math

import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-4
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want):
    masked = want <= -1e29
    assert torch.equal(got[masked], want[masked])
    g, w = got[~masked], want[~masked]
    if w.numel():
        scale = w.abs().max().clamp(min=1e-30)
        diff = (g - w).abs()
        assert torch.all(diff <= TOL * (w.abs() + scale)), (
            f"max abs err {diff.max().item():.3e}, "
            f"max |plain| {scale.item():.3e}")


def _assert_partials_close(got, want):
    for g, w in zip(got, want):
        _assert_close(g, w)
    _assert_close(got[2] / got[1].clamp(min=1e-30)[..., None],
                  want[2] / want[1].clamp(min=1e-30)[..., None])


def _cuda_case(dev, dtype, *, b=2, t=61, h=32, hk=8, dh=128, bs=128,
               npg=12, ns=9, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((b, t, h, dh), generator=g, device=dev).to(dtype)
    pk = torch.randn((npg, bs, hk, dh), generator=g, device=dev).to(dtype)
    pv = torch.randn((npg, bs, hk, dh), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, npg, (b, hk, ns), generator=g, device=dev,
                        dtype=torch.int32)
    vlen = torch.randint(0, bs + 1, (b, hk, ns), generator=g, device=dev,
                         dtype=torch.int32)
    vlen[1, 3] = 0                       # an all-empty (row, head)
    return q, pk, pv, idx, vlen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 61, 156])
def test_cuda_block_attention_matches_plain(cuda, dtype, t):
    q, pk, pv, idx, vlen = _cuda_case(cuda, TDT[dtype], t=t)
    npg, bs, hk, dh = pk.shape
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    before = tops.LAUNCHES["sparse_verify_attention"]
    got = tops.block_attention(q, kf, vf, idx, vlen, bs)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["sparse_verify_attention"] == before + 1
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs)
    _assert_partials_close(got, want)
    rep = q.shape[2] // hk
    assert torch.all(got[0][1, 3 * rep:4 * rep] == -1e30)
    assert torch.all(got[1][1, 3 * rep:4 * rep] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qoff", [0, 700])
def test_cuda_paged_prefill_matches_plain(cuda, dtype, qoff):
    q, pk, pv, _, _ = _cuda_case(cuda, TDT[dtype], t=256, seed=1)
    npg, bs, hk, dh = pk.shape
    b = q.shape[0]
    pt = torch.stack([torch.randperm(npg - 1, device=cuda)[:8] + 1
                      for _ in range(b)]).to(torch.int32)
    length = torch.tensor([qoff, 0], dtype=torch.int32, device=cuda)
    t_valid = torch.tensor([256, 200], dtype=torch.int32, device=cuda)
    end = length + t_valid
    vl = (end[:, None] - torch.arange(8, device=cuda)[None] * bs).clamp(0, bs)
    idx = torch.where(vl > 0, pt, 0)[:, None].expand(b, hk, 8)
    idx = idx.to(torch.int32).contiguous()
    vlen = vl[:, None].expand(b, hk, 8).to(torch.int32).contiguous()
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    got = tops.block_attention(q, kf, vf, idx, vlen, bs, q_offset=length)
    torch.cuda.synchronize()
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                        q_offset=length)
    _assert_partials_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_retrieval_scores_match_plain(cuda, dtype):
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    b, t, h, hk, dh, nb = 2, 156, 32, 8, 128, 37
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(TDT[dtype])
    kmax = torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    kmin = -torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    qw = (torch.rand((b, t), generator=g, device=cuda) > 0.3).float()
    before = tops.LAUNCHES["retrieval_score"]
    got = tops.retrieval_scores(q, kmax, kmin, qw)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["retrieval_score"] == before + 1
    want = tref.retrieval_score_batched(q, kmax, kmin, qw)
    _assert_close(got, want)
    assert math.isfinite(got.abs().max().item())
