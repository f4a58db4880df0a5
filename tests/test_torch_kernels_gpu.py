"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where CUDA is absent. On a machine with an NVIDIA
Hopper GPU and nvcc, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(`--noconftest`: the shared conftest imports JAX, which the GPU machine need
not have). Small, ragged shapes: S, T and N not multiples of the 64-row
tiles, right-padded rows, rows with no allowed key, every mask kind, both
dtypes; the backward kernels (b, i, k) against autograd through the plain
versions, with dropout off and on (the same seed on both sides).
"""

import numpy as np
import pytest
import torch

from gamer_tpu_torch.ops import fused_attention as FA
from gamer_tpu_torch.ops import fused_ce as FC
from gamer_tpu_torch.ops import fused_moe as FM
from gamer_tpu_torch.ops.fused_attention import fused_mask_attention, fused_mask_attention_plain
from gamer_tpu_torch.ops.fused_ce import fused_ce_rows, fused_ce_rows_plain
from gamer_tpu_torch.ops.fused_moe import fused_moe_ffn, fused_moe_ffn_plain

pytestmark = pytest.mark.gpu

# fp32: summation order only; bf16: the kernel's bf16 output rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * max(ref.float().abs().max().item(), 1e-6), err


def _attn_inputs(dev, dtype, S, D, seed):
    rng = np.random.default_rng(seed)
    B, H, Hkv = 3, 4, 2
    attn = np.ones((B, S), np.int32)
    attn[1, S - 9:] = 0
    sess = np.sort(rng.integers(0, 4, (B, S)), axis=1)
    act = rng.integers(1, 4, (B, S))
    blk = np.where(attn == 1, (np.cumsum(attn, 1) - 1) // 5, -1)
    streams = [torch.as_tensor(x.astype(np.int32), device=dev) for x in (attn, sess, act, blk)]
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, h * D)), dtype=torch.float32,
                               device=dev).to(dtype) for h in (H, Hkv, Hkv))
    return q, k, v, streams, H


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["causal", "session", "multi", "session_multi"])
@pytest.mark.parametrize("S,D", [(77, 32), (130, 64), (64, 128)])
def test_attention_kernel_matches_plain(dev, dtype, kind, S, D):
    q, k, v, streams, H = _attn_inputs(dev, dtype, S, D, S + D)
    out = fused_mask_attention(q, k, v, *streams, 0, H, kind)
    ref = fused_mask_attention_plain(q.float(), k.float(), v.float(), *streams, 0, H, kind)
    torch.cuda.synchronize()
    _close(out, ref, dtype)
    if kind in ("multi", "session_multi"):  # lowest-action rows have no allowed key
        empty = ref.abs().amax(-1) == 0
        assert empty.any() and (out[empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_bias", [False, True])
def test_moe_kernel_matches_plain(dev, dtype, use_bias):
    g = torch.Generator().manual_seed(0)
    P, T, D, F, Dout, NB = 3, 99, 96, 80, 300, 4
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    xp, wgu, wd, btab = rnd(P, T, D), rnd(P, D, 2 * F) * D ** -0.5, rnd(P, F, Dout), rnd(P, NB, 2 * F)
    beh = torch.randint(-1, NB + 1, (P, T), generator=g).to(dev, torch.int32)
    out = fused_moe_ffn(xp, wgu, wd, btab, beh, use_bias=use_bias)
    ref = fused_moe_ffn_plain(xp.float(), wgu.float(), wd.float(), btab.float(), beh, use_bias)
    torch.cuda.synchronize()
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_kernel_matches_plain(dev, dtype):
    g = torch.Generator().manual_seed(0)
    N, D, V = 200, 96, 333
    h = torch.randn(N, D, generator=g).to(dev, dtype)
    table = (torch.randn(V, D, generator=g) * D ** -0.5).to(dev, dtype)
    tgt = torch.randint(0, V, (N,), generator=g).to(dev, torch.int32)
    val = (torch.rand(N, generator=g) > 0.3).to(dev, torch.int32)
    nll, lse = fused_ce_rows(h, table, tgt, val, 1 / 0.7)
    rnll, rlse = fused_ce_rows_plain(h.float(), table.float(), tgt, val, 1 / 0.7)
    torch.cuda.synchronize()
    _close(lse, rlse, dtype)
    _close(nll, rnll, dtype)
    assert (nll[val == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("kind", ["causal", "session", "multi", "session_multi"])
@pytest.mark.parametrize("S,D", [(77, 32), (130, 64), (64, 128)])
def test_attention_backward_kernel_matches_plain(dev, dtype, rate, kind, S, D):
    """Kernels a (with lse) and b against autograd through the plain version."""
    q, k, v, streams, H = _attn_inputs(dev, dtype, S, D, 7 * S + D)
    seed = 1234
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = FA.fused_mask_attention_bwd.launches
    out = fused_mask_attention(*leaves, *streams, seed, H, kind, rate)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(S)).to(dev, dtype)
    grads = torch.autograd.grad(out, leaves, dout)
    assert FA.fused_mask_attention_bwd.launches == before + 1
    ref_out = fused_mask_attention_plain(q.float(), k.float(), v.float(), *streams, seed, H, kind,
                                         rate)
    ref = FA.fused_mask_attention_bwd_plain(q.float(), k.float(), v.float(), dout.float(),
                                            *streams, seed, H, kind, rate)
    torch.cuda.synchronize()
    _close(out, ref_out, dtype)
    for g, r in zip(grads, ref):
        _close(g, r, dtype)
    if kind in ("multi", "session_multi"):  # rows with no allowed key: 0 out, 0 dq
        empty = ref_out.abs().amax(-1) == 0
        assert empty.any() and (out[empty] == 0).all() and (grads[0][empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("use_bias", [False, True])
def test_moe_backward_kernel_matches_plain(dev, dtype, rate, use_bias):
    """Kernels h and i against autograd through the plain version; T, F
    and Dout are not tile multiples, some bias ids lie outside [0, NB)."""
    g = torch.Generator().manual_seed(1)
    P, T, D, F, Dout, NB = 3, 99, 96, 80, 136, 4
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    xp, wgu, wd, btab = rnd(P, T, D), rnd(P, D, 2 * F) * D ** -0.5, rnd(P, F, Dout), rnd(P, NB, 2 * F)
    beh = torch.randint(-1, NB + 1, (P, T), generator=g).to(dev, torch.int32)
    leaves = [t.detach().requires_grad_(True) for t in (xp, wgu, wd, btab)]
    before = FM.fused_moe_ffn_bwd.launches
    out = fused_moe_ffn(*leaves, beh, 77, rate=rate, use_bias=use_bias)
    gout = rnd(P, T, Dout)
    grads = torch.autograd.grad(out, leaves, gout)
    assert FM.fused_moe_ffn_bwd.launches == before + 1
    ref_out = fused_moe_ffn_plain(*(t.float() for t in (xp, wgu, wd, btab)), beh, use_bias, 77, rate)
    ref = FM.fused_moe_ffn_bwd_plain(*(t.float() for t in (xp, wgu, wd, btab)), beh,
                                     gout.float(), 77, rate, use_bias)
    torch.cuda.synchronize()
    _close(out, ref_out, dtype)
    for got, want in zip(grads, ref):
        if want.abs().max() == 0:  # dbtab without bias
            assert (got == 0).all()
        else:
            _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_backward_kernel_matches_plain(dev, dtype):
    """Kernels j and k against autograd through the plain version; N and V
    are not tile multiples, invalid rows get no gradient."""
    g = torch.Generator().manual_seed(2)
    N, D, V = 200, 96, 333
    h = torch.randn(N, D, generator=g).to(dev, dtype)
    table = (torch.randn(V, D, generator=g) * D ** -0.5).to(dev, dtype)
    tgt = torch.randint(0, V, (N,), generator=g).to(dev, torch.int32)
    val = (torch.rand(N, generator=g) > 0.3).to(dev, torch.int32)
    gnll = torch.rand(N, generator=g).to(dev)
    leaves = [t.detach().requires_grad_(True) for t in (h, table)]
    before = FC.fused_ce_rows_bwd.launches
    nll, _ = fused_ce_rows(*leaves, tgt, val, 1 / 0.7)
    dh, de = torch.autograd.grad(nll, leaves, gnll)
    assert FC.fused_ce_rows_bwd.launches == before + 1
    rdh, rde = FC.fused_ce_rows_bwd_plain(h.float(), table.float(), tgt, val, gnll, 1 / 0.7)
    torch.cuda.synchronize()
    _close(dh, rdh, dtype)
    _close(de, rde, dtype)
    assert (dh[val == 0] == 0).all()
