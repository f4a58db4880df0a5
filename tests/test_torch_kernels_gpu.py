"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where CUDA is absent. On a machine with an NVIDIA
Hopper GPU and nvcc, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(`--noconftest`: the shared conftest imports JAX, which the GPU machine need
not have). Small, ragged shapes: S, T and N not multiples of the 64-row
tiles, right-padded rows, rows with no allowed key, every mask kind, both
dtypes; the backward kernels (b, i, k) against autograd through the plain
versions, with dropout off and on (the same seed on both sides); the
residual hash dropout's K1 and K2 against their plain versions bit for bit.
"""

import numpy as np
import pytest
import torch

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import fused_attention as FA
from gamer_tpu_torch.ops import fused_ce as FC
from gamer_tpu_torch.ops import fused_moe as FM
from gamer_tpu_torch.ops import hash_dropout as HD
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


def _attn_inputs(dev, dtype, S, D, seed, B=3):
    rng = np.random.default_rng(seed)
    H, Hkv = 4, 2
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
    """Ragged T; Dout past one 256-column tile (the bf16 kernels take
    multiples of 16, the fp32 ones any width)."""
    g = torch.Generator().manual_seed(0)
    P, T, D, F, Dout, NB = 3, 99, 96, 80, 300 if dtype == torch.float32 else 304, 4
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
    before = trace.counter("launch.b")
    out = fused_mask_attention(*leaves, *streams, seed, H, kind, rate)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(S)).to(dev, dtype)
    grads = torch.autograd.grad(out, leaves, dout)
    assert trace.counter("launch.b") == before + 1
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
    and Dout are not tile multiples (multiples of 16 in bf16), some bias ids
    lie outside [0, NB)."""
    g = torch.Generator().manual_seed(1)
    P, T, D, F, Dout, NB = 3, 99, 96, 80, 136 if dtype == torch.float32 else 144, 4
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    xp, wgu, wd, btab = rnd(P, T, D), rnd(P, D, 2 * F) * D ** -0.5, rnd(P, F, Dout), rnd(P, NB, 2 * F)
    beh = torch.randint(-1, NB + 1, (P, T), generator=g).to(dev, torch.int32)
    leaves = [t.detach().requires_grad_(True) for t in (xp, wgu, wd, btab)]
    before = trace.counter("launch.i")
    out = fused_moe_ffn(*leaves, beh, 77, rate=rate, use_bias=use_bias)
    gout = rnd(P, T, Dout)
    grads = torch.autograd.grad(out, leaves, gout)
    assert trace.counter("launch.i") == before + 1
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
    before = trace.counter("launch.k")
    nll, _ = fused_ce_rows(*leaves, tgt, val, 1 / 0.7)
    dh, de = torch.autograd.grad(nll, leaves, gnll)
    assert trace.counter("launch.k") == before + 1
    rdh, rde = FC.fused_ce_rows_bwd_plain(h.float(), table.float(), tgt, val, gnll, 1 / 0.7)
    torch.cuda.synchronize()
    _close(dh, rdh, dtype)
    _close(de, rde, dtype)
    assert (dh[val == 0] == 0).all()


# ---- the bf16 tensor-core kernels of a and b (mma.sync): fragment
# coordinates (dropout 0.2 on the same seed), ragged and sub-tile S, a batch
# row with no allowed key, GQA groups 1-3, every head dim, split and unsplit
# dK/dV, determinism

def _tc_inputs(dev, B, S, G, D, seed):
    rng = np.random.default_rng(seed)
    Hkv = 2
    attn = np.ones((B, S), np.int32)
    attn[0, max(S - 9, 1):] = 0  # right padding
    attn[B - 1] = 0  # a batch row with no key at all
    sess = np.sort(rng.integers(0, 4, (B, S)), axis=1)
    # actions cycle 1..7 from a random phase: under "multi" the action-1 rows
    # have no allowed key and the others several, even at S 5 (a row with
    # one key has dq = 0 up to rounding, which no relative check can read)
    phase = rng.integers(0, 7, (B, 1))
    phase[B // 2] = 0  # a row whose actions rise 1, 2, 3, ... from its start
    act = (np.arange(S) + phase) % 7 + 1
    blk = np.where(attn == 1, (np.cumsum(attn, 1) - 1) // 5, -1)
    streams = [torch.as_tensor(x.astype(np.int32), device=dev) for x in (attn, sess, act, blk)]
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, h * D)), dtype=torch.float32,
                               device=dev).bfloat16() for h in (G * Hkv, Hkv, Hkv))
    return q, k, v, streams, G * Hkv


def _tc_check(dev, B, S, G, D, rate, kind, seed):
    q, k, v, streams, H = _tc_inputs(dev, B, S, G, D, seed)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fused_mask_attention(*leaves, *streams, 1234, H, kind, rate)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(dev).bfloat16()
    grads = torch.autograd.grad(out, leaves, dout)
    up = [t.float() for t in (q, k, v)]
    ref_out = fused_mask_attention_plain(*up, *streams, 1234, H, kind, rate)
    ref = FA.fused_mask_attention_bwd_plain(*up, dout.float(), *streams, 1234, H, kind, rate)
    torch.cuda.synchronize()
    for got, want in zip((out, *grads), (ref_out, *ref)):
        assert torch.isfinite(got.float()).all()
        _close(got, want, torch.bfloat16)
    for t in (out, *grads):  # the batch row with no allowed key: exactly 0
        assert (t[B - 1] == 0).all()
    empty = ref_out.abs().amax(-1) == 0
    assert (out[empty] == 0).all() and (grads[0][empty] == 0).all()
    return out, grads


@pytest.mark.parametrize("kind", ["causal", "multi"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("S", [505, 5])
def test_attention_tc_kernels_match_plain(dev, S, G, D, rate, kind):
    """bf16 a and b (tensor cores) against the plain version in fp32 on the
    same bf16 values, output and the three grads, at 2e-2."""
    _tc_check(dev, 3, S, G, D, rate, kind, S + 10 * G + D)


@pytest.mark.parametrize("kind", ["causal", "session_multi"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_tc_unsplit_dkv_matches_plain(dev, monkeypatch, kind, rate):
    """The dK/dV kernel without splits (one CTA sums every pair, as at the
    flagship batch) agrees with the plain version as the split one does."""
    split_out, split_grads = _tc_check(dev, 3, 505, 2, 64, rate, kind, 77)
    monkeypatch.setattr(FA, "dkv_splits", lambda *args: 1)
    out, grads = _tc_check(dev, 3, 505, 2, 64, rate, kind, 77)
    assert torch.equal(out, split_out)  # the forward does not split
    for g, s in zip(grads, split_grads):
        _close(g, s, torch.bfloat16)


@pytest.mark.parametrize("B,S", [(4, 505), (1, 2048)])
def test_attention_tc_kernels_are_deterministic(dev, B, S):
    """Two bf16 launches of a and of b on the same inputs are bit-identical
    (no atomics; split partials added in a fixed order)."""
    q, k, v, streams, H = _tc_inputs(dev, B, S, 2, 64, 5)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(dev).bfloat16()
    runs = []
    for _ in range(2):
        out, lse = FA._launch_fwd(q, k, v, streams, 99, H, "causal", 0.2, with_lse=True)
        grads = FA.fused_mask_attention_bwd(q, k, v, out, dout, lse, *streams, 99, H, "causal",
                                            0.2)
        runs.append((out, lse, *grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---- the bf16 tensor-core kernels of j and k (mma.sync): targets in every
# 64-column vocab chunk and in the ragged last one, a target past V, N and V
# off the tiles and below one tile, every padded width, split and unsplit dE,
# determinism

def _ce_tc_inputs(dev, N, V, D, seed):
    rng = np.random.default_rng(seed)
    h = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32, device=dev).bfloat16()
    table = torch.as_tensor(rng.standard_normal((V, D)) / np.sqrt(D), dtype=torch.float32,
                            device=dev).bfloat16()
    tgt = rng.integers(0, V, N)
    valid = (rng.random(N) > 0.3).astype(np.int32)
    # one target in each chunk, V - 1, and V + 3 (a padded column of the last
    # chunk when V % 64 != 0, which must match nothing), on valid rows
    special = np.concatenate([np.minimum(np.arange(0, V, 64) + seed % 64, V - 1), [V - 1, V + 3]])
    rows = rng.permutation(N)[:len(special) + 1]
    tgt[rows[:-1]] = special[:len(rows) - 1]
    valid[rows[:-1]] = 1
    valid[rows[-1]] = 0  # and an invalid row
    as_dev = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)
    gnll = torch.as_tensor(rng.random(N), dtype=torch.float32, device=dev)
    return h, table, as_dev(tgt), as_dev(valid), gnll


def _ce_tc_check(dev, N, V, D, inv_t, seed):
    h, table, tgt, val, gnll = _ce_tc_inputs(dev, N, V, D, seed)
    nll, lse = FC._launch_fwd(h, table, tgt, val, inv_t)
    dh, de = FC.fused_ce_rows_bwd(h, table, tgt, val, lse, gnll, inv_t)
    rnll, rlse = fused_ce_rows_plain(h.float(), table.float(), tgt, val, inv_t)
    rdh, rde = FC.fused_ce_rows_bwd_plain(h.float(), table.float(), tgt, val, gnll, inv_t)
    torch.cuda.synchronize()
    for got, want in ((nll, rnll), (lse, rlse), (dh, rdh), (de, rde)):
        assert torch.isfinite(got.float()).all()
        _close(got, want, torch.bfloat16)
    assert (nll[val == 0] == 0).all() and (dh[val == 0] == 0).all()
    return de


@pytest.mark.parametrize("inv_t", [1.0, 1 / 0.7])
@pytest.mark.parametrize("N,V", [(5, 17), (200, 333), (1000, 1041)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_ce_tc_kernels_match_plain(dev, D, N, V, inv_t):
    """bf16 j and k (tensor cores) against the plain version in fp32 on the
    same bf16 values: nll, lse, dh and dE at 2e-2; invalid rows get exactly
    0 nll and 0 dh."""
    _ce_tc_check(dev, N, V, D, inv_t, N + V + D)


def test_ce_tc_unsplit_de_matches_plain(dev, monkeypatch):
    """The dE kernel without row splits (one CTA sums every row of its vocab
    tile) agrees with the plain version as the split one does."""
    N, V, D = 1000, 1041, 256
    split = _ce_tc_check(dev, N, V, D, 1 / 0.7, 3)
    assert FC.de_splits(N, V, torch.cuda.get_device_properties(dev).multi_processor_count)[0] > 1
    monkeypatch.setattr(FC, "de_splits", lambda n, v, sms: (1, -(-n // FC.TM) * FC.TM))
    _close(_ce_tc_check(dev, N, V, D, 1 / 0.7, 3), split, torch.bfloat16)


def test_ce_tc_kernels_are_deterministic(dev):
    """Two bf16 launches of j and of k on the same inputs are bit-identical
    (no atomics; split partials added in a fixed order)."""
    h, table, tgt, val, gnll = _ce_tc_inputs(dev, 4096, 1041, 256, 9)
    runs = []
    for _ in range(2):
        nll, lse = FC._launch_fwd(h, table, tgt, val, 1 / 0.7)
        runs.append((nll, lse, *FC.fused_ce_rows_bwd(h, table, tgt, val, lse, gnll, 1 / 0.7)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_ce_bf16_rejects_widths_the_kernels_do_not_take(dev):
    """No bf16 width is refused any more: D off the multiples of 16 is
    zero-padded by the wrapper and D over 256 takes the wide kernels, both
    against the plain version."""
    for width in (40, 272):
        _ce_tc_check(dev, 200, 333, width, 1 / 0.7, width)


# ---- the bf16 tensor-core kernels of h and i (mma.sync): every padded width
# of D and of the output tile, T below one row tile, ragged and at the
# flagship, bias ids outside [0, NB), dropout on one seed, split and unsplit
# weight-gradient products, determinism

def _moe_tc_inputs(dev, P, T, D, F, Dout, NB, seed):
    rng = np.random.default_rng(seed)
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).bfloat16()
    xp = as_dev(rng.standard_normal((P, T, D)))
    wgu = as_dev(rng.standard_normal((P, D, 2 * F)) / np.sqrt(D))
    wd = as_dev(rng.standard_normal((P, F, Dout)) / np.sqrt(F))
    btab = as_dev(rng.standard_normal((P, NB, 2 * F)) * 0.5)
    beh = torch.as_tensor(rng.integers(-1, NB + 1, (P, T)).astype(np.int32), device=dev)
    gout = as_dev(rng.standard_normal((P, T, Dout)))
    return xp, wgu, wd, btab, beh, gout


def _moe_tc_check(dev, P, T, D, F, Dout, rate, use_bias, seed, act="silu"):
    """bf16 h and i against the plain version in fp32 on the same bf16
    values: out, dx, dWgu, dWd (and dbtab with bias) at 2e-2."""
    xp, wgu, wd, btab, beh, gout = _moe_tc_inputs(dev, P, T, D, F, Dout, 4, seed)
    out = FM._launch_fwd(xp, wgu, wd, btab, beh, 77, rate, use_bias, act)
    grads = FM.fused_moe_ffn_bwd(xp, wgu, wd, btab, beh, gout, 77, rate, use_bias, act)
    up = [t.float() for t in (xp, wgu, wd, btab)]
    ref_out = fused_moe_ffn_plain(*up, beh, use_bias, 77, rate, act)
    ref = FM.fused_moe_ffn_bwd_plain(*up, beh, gout.float(), 77, rate, use_bias, act)
    torch.cuda.synchronize()
    n = 4 if use_bias else 3
    for got, want in zip((out, *grads[:n]), (ref_out, *ref[:n])):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        _close(got, want, torch.bfloat16)
    if not use_bias:
        assert (grads[3] == 0).all()
    return out, grads


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [5, 99, 6464])
@pytest.mark.parametrize("width", [64, 128, 256])
def test_moe_tc_kernels_match_plain(dev, width, T, rate, use_bias):
    """D = F = Dout = width (each padded width of the x tile and of the
    output tile); T below one row tile, ragged, and the flagship's."""
    _moe_tc_check(dev, 2, T, width, width, width, rate, use_bias, T + width)


def test_moe_tc_unsplit_weight_grads_match_plain(dev, monkeypatch):
    """dWgu and dWd without splits over T (one CTA sums every row of its
    tile) agree with the plain version as the split ones do."""
    P, T, D, F = 2, 6464, 256, 512
    split = _moe_tc_check(dev, P, T, D, F, D, 0.2, True, 3)[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = FM.weight_grad_splits(T, P, D, F, D, sms, True)
    assert splits[0] > 1 and splits[2] > 1
    whole = -(-T // 32) * 32
    monkeypatch.setattr(FM, "weight_grad_splits", lambda *args: (1, whole, 1, whole, *splits[4:]))
    unsplit = _moe_tc_check(dev, P, T, D, F, D, 0.2, True, 3)[1]
    for a, b in zip(unsplit, split):
        _close(a, b, torch.bfloat16)


def test_moe_tc_kernels_are_deterministic(dev):
    """Two bf16 launches of h and of i on the same inputs (bias, dropout
    0.2) are bit-identical (no atomics; partials added in a fixed order)."""
    xp, wgu, wd, btab, beh, gout = _moe_tc_inputs(dev, 5, 6464, 256, 512, 256, 4, 9)
    runs = [(FM._launch_fwd(xp, wgu, wd, btab, beh, 5, 0.2, True),
             *FM.fused_moe_ffn_bwd(xp, wgu, wd, btab, beh, gout, 5, 0.2, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_moe_bf16_rejects_widths_the_kernels_do_not_take(dev):
    """No bf16 width is refused any more: D, F and Dout off the multiples of
    16 are zero-padded by the wrapper and D over 256 takes the streamed
    forward, all against the plain version."""
    for D, F, Dout in ((40, 64, 64), (272, 64, 64), (64, 72, 64), (64, 64, 100)):
        _moe_tc_check(dev, 1, 8, D, F, Dout, 0.2, True, D + F + Dout)


# ---- the activations of h and i (silu, relu, tanh-gelu for "gelu" and
# "gelu_new"), with bias and dropout 0.2 on one seed, both dtypes

def _moe_f32_check(dev, P, T, D, F, Dout, rate, use_bias, seed, act):
    """fp32 h and i against the plain version at 1e-4."""
    xp, wgu, wd, btab, beh, gout = (t.float() if t.is_floating_point() else t
                                    for t in _moe_tc_inputs(dev, P, T, D, F, Dout, 4, seed))
    out = FM._launch_fwd(xp, wgu, wd, btab, beh, 77, rate, use_bias, act)
    grads = FM.fused_moe_ffn_bwd(xp, wgu, wd, btab, beh, gout, 77, rate, use_bias, act)
    ref_out = fused_moe_ffn_plain(xp, wgu, wd, btab, beh, use_bias, 77, rate, act)
    ref = FM.fused_moe_ffn_bwd_plain(xp, wgu, wd, btab, beh, gout, 77, rate, use_bias, act)
    torch.cuda.synchronize()
    for got, want in zip((out, *grads), (ref_out, *ref)):
        assert torch.isfinite(got).all()
        _close(got, want, torch.float32)


@pytest.mark.parametrize("act", ["gelu", "relu", "gelu_new"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [99, 6464])
def test_moe_activations_match_plain(dev, act, dtype, T):
    """h and i at every activation other than silu, bias and dropout 0.2:
    a ragged T and the flagship shape (P 5, D 256, F 512, Dout 256)."""
    P = 5 if T == 6464 else 2
    if dtype == torch.bfloat16:
        _moe_tc_check(dev, P, T, 256, 512, 256, 0.2, True, T, act)
    else:
        _moe_f32_check(dev, P, T, 256, 512, 256, 0.2, True, T, act)


def test_moe_unknown_activation_raises(dev):
    xp, wgu, wd, btab, beh, _ = _moe_tc_inputs(dev, 1, 8, 64, 64, 64, 2, 1)
    with pytest.raises(ValueError, match="swish"):
        fused_moe_ffn(xp, wgu, wd, btab, beh, act_name="swish")


# ---- widths: the wide routes of h/i (D over 256 in bf16, over 512 in fp32),
# the pad route (bf16 widths off the multiples of 16), j/k at D 512 and 1024,
# attention head dims off the compiled ones and at 256

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,F,Dout,T", [(512, 1024, 512, 6464), (200, 344, 200, 6464),
                                        (1024, 4096, 1024, 640), (600, 80, 40, 99)])
def test_moe_widths_match_plain(dev, dtype, D, F, Dout, T):
    """hidden 512 at the flagship rows, the pad route, D = Dout 1024 with F
    4096, and a narrow output with a wide input; bias and dropout 0.2."""
    P = 5 if T == 6464 else 2
    if dtype == torch.bfloat16:
        _moe_tc_check(dev, P, T, D, F, Dout, 0.2, True, D + F)
    else:
        _moe_f32_check(dev, P, T, D, F, Dout, 0.2, True, D + F, "silu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [200, 512, 1024])
def test_ce_widths_match_plain(dev, dtype, D):
    """j and k at D 512 and 1024 (wide routes of both dtypes; fp32 j streams
    h from 513) and D 200 (the bf16 pad route), V 1041, ragged N."""
    if dtype == torch.bfloat16:
        _ce_tc_check(dev, 1000, 1041, D, 1 / 0.7, D)
        return
    h, table, tgt, val, gnll = (t.float() if t.is_floating_point() else t
                                for t in _ce_tc_inputs(dev, 1000, 1041, D, D))
    nll, lse = FC._launch_fwd(h, table, tgt, val, 1 / 0.7)
    dh, de = FC.fused_ce_rows_bwd(h, table, tgt, val, lse, gnll, 1 / 0.7)
    rnll, rlse = fused_ce_rows_plain(h, table, tgt, val, 1 / 0.7)
    rdh, rde = FC.fused_ce_rows_bwd_plain(h, table, tgt, val, gnll, 1 / 0.7)
    torch.cuda.synchronize()
    for got, want in ((nll, rnll), (lse, rlse), (dh, rdh), (de, rde)):
        _close(got, want, torch.float32)


def _head_dim_check(dev, dtype, D, kind, B=8):
    """a and b at head dim D, dropout 0.2, B x S 505 with a padded row,
    against the plain version; returns the output and grads."""
    q, k, v, streams, H = _attn_inputs(dev, dtype, 505, D, D, B=B)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fused_mask_attention(*leaves, *streams, 1234, H, kind, 0.2)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(D)).to(dev, dtype)
    grads = torch.autograd.grad(out, leaves, dout)
    up = [t.float() for t in (q, k, v)]
    ref_out = fused_mask_attention_plain(*up, *streams, 1234, H, kind, 0.2)
    ref = FA.fused_mask_attention_bwd_plain(*up, dout.float(), *streams, 1234, H, kind, 0.2)
    torch.cuda.synchronize()
    for got, want in zip((out, *grads), (ref_out, *ref)):
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        _close(got, want, dtype)
    return out, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 48, 96, 200, 256])
@pytest.mark.parametrize("kind", ["causal", "session_multi"])
def test_attention_head_dims_match_plain(dev, dtype, D, kind):
    """a and b at head dims padded to the compiled ones (8, 48, 96, 200) and
    at the new 256, dropout 0.2, B 8 x S 505 with a padded row."""
    _head_dim_check(dev, dtype, D, kind)


def test_attention_head_dim_over_256_raises(dev):
    """A head dim over 256 no longer raises: 264 runs the wide route (padded
    to 320) and matches the plain version."""
    _head_dim_check(dev, torch.bfloat16, 264, "causal", B=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [320, 512])
@pytest.mark.parametrize("kind", ["causal", "session", "multi", "session_multi"])
def test_attention_wide_head_dims_match_plain(dev, dtype, D, kind):
    """The wide route (head dims over 256, 64 output columns a CTA) at 320
    and 512, every mask kind, dropout 0.2, B 3 x S 505; in bf16 two launches
    of a and b are bit-identical."""
    out, grads = _head_dim_check(dev, dtype, D, kind, B=3)
    if dtype == torch.bfloat16:
        again, again_grads = _head_dim_check(dev, dtype, D, kind, B=3)
        assert all(torch.equal(x, y) for x, y in zip((out, *grads), (again, *again_grads)))


def test_flagship_widths_copy_nothing(dev, monkeypatch):
    """At the flagship widths (head dim 64, hidden 256, d_ff 512) no wrapper
    pads: F.pad is never called."""
    import torch.nn.functional as F

    def no_pad(*args, **kwargs):
        raise AssertionError("a flagship-width call padded")

    monkeypatch.setattr(F, "pad", no_pad)
    _moe_tc_check(dev, 5, 640, 256, 512, 256, 0.2, True, 1)
    _ce_tc_check(dev, 640, 1041, 256, 1 / 0.7, 1)
    _tc_check(dev, 3, 505, 2, 64, 0.2, "causal", 1)


def test_qwen3multi_hidden_512_training_step(dev):
    """One bf16 training step of Qwen3Multi at hidden 512 (head dim 64, MoE
    D 512 on the streamed forward) through the kernels, with phase 5's
    launch counts per step: a 12, b 12, h 8, i 8, j 1, k 1."""
    from gamer_tpu_torch.entry import flagship_config, make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    cfg = flagship_config(dtype="bfloat16", dropout_rate=0.2, hidden_size=512)
    model = QwenFamilyModel(cfg, device=dev, seed=0)
    batch = make_batch(cfg, 8, 101)
    loss_fn = make_loss_fn(model, cfg, deterministic=False)
    kernels = tuple(_step_counters().values())[:6]  # a, b, h, i, j, k
    for f in kernels:
        f.launches = 0
    grouped = trace.counter("moe.grouped")
    loss, _ = loss_fn(batch, torch.Generator().manual_seed(0))
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert [f.launches for f in kernels] == [12, 12, 8, 8, 1, 1]
    assert trace.counter("moe.grouped") == grouped, "the flagship's MoE takes the ungrouped launch"
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


# ---- Qwen3MoeAction: one grouped h and one grouped i launch on every sparse
# layer over the blocks ordered by level, against one launch per behavior
# level with the masked sum; kernel path against plain path

def _grouped_case(dev, dtype, B=256, n=24, P=5, NB=3, D=256, F=512, seed=0, pad=0.19):
    """The h20 cell's MoE shapes (B 256 x S 120: T = 6144 blocks of 5
    positions, D 256, F 512, 3 levels, injection's 4 bias rows): xp, the
    P * NB + 1 experts' weights, behavior ids, gout, and block levels with a
    share `pad` of pad blocks (level 0)."""
    rng = np.random.default_rng(seed)
    T, E = B * n, P * NB + 1
    t = lambda *shape, scale=1.0: torch.as_tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32), device=dev).to(dtype)
    xp, wgu, wd = t(P, T, D), t(E, D, 2 * F, scale=D ** -0.5), t(E, F, D, scale=F ** -0.5)
    btab, gout = t(E, NB + 1, 2 * F, scale=0.3), t(P, T, D)
    beh = torch.as_tensor(rng.integers(0, NB + 1, (P, T)).astype(np.int32), device=dev)
    lv = rng.integers(1, NB + 1, T)
    lv[rng.random(T) < pad] = 0
    return xp, wgu, wd, btab, beh, gout, torch.as_tensor(lv, device=dev)


def _per_level_launches(xp, wgu, wd, btab, beh, gout, lv, NB, seed, rate):
    """Three ungrouped launches of h and of i, one a level a with experts
    P(a-1)+1..Pa, kept by the masked sum (i takes gout masked to the level's
    rows): (out, dx, dwgu, dwd, dbtab), the weight grads of all experts."""
    P = xp.shape[0]
    out, dx = 0, 0
    dws = [torch.zeros_like(w) for w in (wgu, wd, btab)]
    for a in range(1, NB + 1):
        w = slice(P * (a - 1) + 1, P * a + 1)
        mask = (lv == a).to(xp.dtype)[None, :, None]
        y = FM._launch_fwd(xp, wgu[w], wd[w], btab[w], beh, seed, rate, True)
        out = out + y * mask
        grads = FM.fused_moe_ffn_bwd(xp, wgu[w], wd[w], btab[w], beh, gout * mask, seed, rate,
                                     True)
        dx = dx + grads[0]
        for d, g in zip(dws, grads[1:]):
            d[w] = g
    return out, dx, *dws


# weight grads: fp32 sums over other sets and orders of rows, then one
# rounding to the dtype: a bf16 value may round one step (2^-7 of itself)
# the other way; fp32 differs in the order of the sums alone
GROUPED_WGRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


@pytest.mark.parametrize("dtype,D,F", [
    (torch.float32, 256, 512), (torch.bfloat16, 256, 512),  # the h20 cell's widths
    (torch.bfloat16, 320, 512),  # h's streamed route (bf16 D > 256)
    (torch.bfloat16, 200, 344),  # the wrapper's zero padding to multiples of 16
    (torch.float32, 520, 128),  # fp32 h with x streamed (D > 512)
])
def test_moe_grouped_kernels_match_per_level_launches(dev, dtype, D, F):
    """Grouped h and i (`fused_moe_ffn_grouped`, the row table of
    `level_rows`) against three ungrouped launches with the masked sum, at
    the h20 cell's rows (B 256 x S 120) on every route, dropout 0.1,
    injection: the output and dx bit-identical (the same per-row
    arithmetic, rows of pad blocks exactly zero), dWgu, dWd and dbtab within
    GROUPED_WGRAD_TOL of each tensor's largest; the pad expert 0 gets zero
    grads; the counters `moe.grouped` and `moe.grouped_tiles` move by 1 and
    the table's tiles."""
    NB, seed, rate = 3, 4321, 0.1
    xp, wgu, wd, btab, beh, gout, lv = _grouped_case(dev, dtype, D=D, F=F)
    want = _per_level_launches(xp, wgu, wd, btab, beh, gout, lv, NB, seed, rate)
    groups = FM.level_rows(lv, NB)
    before = trace.counter("moe.grouped"), trace.counter("moe.grouped_tiles")
    out = FM._launch_fwd(xp, wgu, wd, btab, beh, seed, rate, True, "silu", groups, 1)
    grads = FM.fused_moe_ffn_bwd(xp, wgu, wd, btab, beh, gout, seed, rate, True, "silu", groups, 1)
    torch.cuda.synchronize()
    assert (trace.counter("moe.grouped") - before[0],
            trace.counter("moe.grouped_tiles") - before[1]) == (1, groups.tile_level.numel())
    assert torch.equal(out, want[0]) and torch.equal(grads[0], want[1])
    assert (out[:, lv == 0] == 0).all() and (grads[0][:, lv == 0] == 0).all()
    for name, got, ref in zip(("dwgu", "dwd", "dbtab"), grads[1:], want[2:]):
        assert (got[0] == 0).all(), name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= GROUPED_WGRAD_TOL[dtype] * ref.float().abs().max().item(), (name, err)


def test_moe_grouped_step_replays_on_other_level_mixes(dev):
    """One CUDA graph captures the grouped step (the row table, h, i) on
    static inputs; replayed on two batches with different level mixes (one
    with a level missing, one with pad blocks at 40%), its output and grads
    are bit-identical to the eager grouped launches on each batch."""
    NB, seed, rate = 3, 99, 0.1
    batches = [_grouped_case(dev, torch.bfloat16, seed=s, pad=p) for s, p in ((1, 0.19),
                                                                              (2, 0.4))]
    batches[0][-1][batches[0][-1] == 2] = 1  # no level 2

    def step(xp, wgu, wd, btab, beh, gout, lv):
        groups = FM.level_rows(lv, NB)
        out = FM._launch_fwd(xp, wgu, wd, btab, beh, seed, rate, True, "silu", groups, 1)
        return (out, *FM.fused_moe_ffn_bwd(xp, wgu, wd, btab, beh, gout, seed, rate, True,
                                           "silu", groups, 1))

    static = [t.clone() for t in batches[0]]
    step(*static)  # warm-up: the libraries load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step(*static)
    for batch in batches:
        for s_, b in zip(static, batch):
            s_.copy_(b)
        graph.replay()
        want = step(*batch)
        torch.cuda.synchronize()
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref)

def _moe_action_config(**kw):
    """Qwen3MoeAction at the presets' widths (hidden 256, 8 layers, 6/3
    heads of 64, d_ff 512), 5 positions and 3 behaviors: 16 experts."""
    from gamer_tpu_torch.models.generative.qwen_family import build_config

    return build_config("Qwen3MoeAction", vocab_size=1024 + 17, num_positions=5, num_experts=6,
                        num_behavior=3, behavior_base=14, **kw)


def _step_counters():
    """chip_smoke's launch counters of a-k, K1, K2, N1 and N2 (no optimizer
    update)."""
    import chip_smoke as cs

    counters = cs.kernel_counters()
    return {k: counters[k] for k in (
        "fused_mask_attention", "fused_mask_attention_bwd", "fused_moe_ffn", "fused_moe_ffn_bwd",
        "fused_ce_rows", "fused_ce_rows_bwd", "hash_dropout_fwd", "hash_dropout_bwd",
        "qk_norm_rope_fwd", "qk_norm_rope_bwd")}


def test_moe_action_step_launches_h_and_i_once_a_layer(dev):
    """A bf16 training step on CUDA with moe_impl "auto" launches kernels h
    and i once on each of the 8 sparse layers, grouped over the behavior
    levels: a 8, b 8, h 8, i 8, j 1, k 1, the hash dropout's K1 and K2 at
    the 16 residual sites, and N1 and N2 once an attention block (8); the
    counter `moe.grouped` moves by 8; loss and grads finite."""
    from gamer_tpu_torch.entry import make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    cfg = _moe_action_config(dtype="bfloat16", dropout_rate=0.2)
    assert cfg.moe_impl == "auto"
    model = QwenFamilyModel(cfg, device=dev, seed=0)
    counters = _step_counters()
    for f in counters.values():
        f.launches = 0
    grouped = trace.counter("moe.grouped")
    loss, _ = make_loss_fn(model, cfg, deterministic=False)(make_batch(cfg, 8, 24),
                                                             torch.Generator().manual_seed(0))
    loss.backward()
    torch.cuda.synchronize()
    assert [f.launches for f in counters.values()] == [8, 8, 8, 8, 1, 1, 16, 16, 8, 8]
    assert trace.counter("moe.grouped") - grouped == 8
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_action_step_kernels_match_plain_path(dev, dtype):
    """One Qwen3MoeAction training step (dropout 0.2, B 8 x 101 blocks)
    through the kernels and through the plain path on the same weights and
    dropout seeds (chip_smoke._paths_agree): the loss and every grad (max
    |d| / max |plain| of its tensor) within chip_smoke's step tolerances:
    fp32 at phase 5's (STEP_LOSS_TOL, STEP_GRAD_TOL), bf16 at
    BF16_STEP_LOSS_TOL and BF16_STEP_GRAD_TOL, set between the readings of
    sound runs and of planted faults (PERF.md)."""
    import chip_smoke as cs

    loss_tol, grad_tol = {"float32": (cs.STEP_LOSS_TOL, cs.STEP_GRAD_TOL),
                          "bfloat16": (cs.BF16_STEP_LOSS_TOL, cs.BF16_STEP_GRAD_TOL)}[dtype]
    cfg = _moe_action_config(dtype=dtype, dropout_rate=0.2)
    cs._paths_agree(f"Qwen3MoeAction step {dtype}", cfg, cs.make_batch(cfg, 8, 101, seed=3), dev,
                    3, _step_counters(), cs._step_launches(cfg), loss_tol=loss_tol,
                    grad_tol=grad_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_remat_policy_launches_and_matches_remat_off(dev, policy, dtype):
    """A flagship Qwen3Multi training step (dropout 0.2, B 8 x 101 blocks)
    under each remat policy: per-step launches of chip_smoke's
    `_remat_launches` (full and dots run kernels a and h again in the
    backward, attn only h: a 12/24/12/24, h 16; every policy K1 32, each
    layer's dropout sites but its last, and N1 24; the rest as remat off), and
    the loss and every grad bit-identical to remat off's on the same weights
    and dropout seeds (PyTorch's default algorithms: the port's table
    lookups sum their grads in a fixed order, `modules/layers.lookup`)."""
    import chip_smoke as cs
    from gamer_tpu_torch.entry import flagship_config, make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    cfg = flagship_config(dtype=dtype, dropout_rate=0.2)
    batch = make_batch(cfg, 8, 101)
    counters = _step_counters()

    def step(c):
        model = QwenFamilyModel(c, device=dev, seed=0)
        for f in counters.values():
            f.launches = 0
        loss, _ = make_loss_fn(model, c, deterministic=False)(batch,
                                                               torch.Generator().manual_seed(2))
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, {
            k: f.launches for k, f in counters.items()}

    want, want_grads, _ = step(cfg)
    loss, grads, launches = step(cfg.replace(remat=True, remat_policy=policy))
    assert launches == cs._remat_launches(cfg, policy)
    assert torch.equal(loss, want)
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name


# --------------------------------------------------------------------------- tokenizer, groups


def test_rqvae_step_on_card_matches_cpu(dev):
    """One fp32 RQ-VAE training step (the RQVAE task's, with Sinkhorn, the
    diversity and CF losses) on the card against the CPU: same parameters,
    batch and diversity noise; loss and parameters within 1e-4."""
    from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
    from gamer_tpu_torch.tasks.rqvae import step_generator, train_step
    from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

    # no BatchNorm: a Dense bias before one has a zero true gradient, whose
    # rounding noise AdamW scales to steps of lr on either device
    cfg = RQVAEConfig(in_dim=96, num_emb_list=[32, 32, 16], e_dim=16, layers=[128, 64],
                      alpha=0.02, beta=0.01, sk_epsilons=[0.0, 0.0, 0.003])
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((256, 96)), dtype=torch.float32)
    cf = torch.as_tensor(rng.standard_normal((256, 16)), dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, 4, (3, 32)))
    out = {}
    for where in (dev, torch.device("cpu")):
        model = RQVAE(cfg, device=where, seed=1)
        opt = make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-3,
                                             lr_scheduler_type="constant", warmup_ratio=0.0,
                                             max_grad_norm=0.0), model)
        loss, _ = train_step(model, opt, x.to(where), cf.to(where), labels.to(where),
                             step_generator(0, 0, 0))
        out[where.type] = (float(loss), {k: v.cpu() for k, v in model.state_dict().items()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for name, t in out["cpu"][1].items():
        _close(out["cuda"][1][name], t, torch.float32)


def test_sinkhorn_and_kmeans_on_card_match_cpu(dev):
    from gamer_tpu_torch.ops import kmeans as K
    from gamer_tpu_torch.ops import sinkhorn as S

    rng = np.random.default_rng(1)
    d = torch.as_tensor(rng.standard_normal((512, 64)) ** 2, dtype=torch.float32)
    for eps in (0.003, 0.05):
        # log-space terms reach 1/eps (333 at eps 0.003), whose float32 sums
        # carry about 333 x 1.2e-7 = 4e-5 of relative error in Q per order
        q = S.sinkhorn(S.center_distance(d.to(dev)), eps, 50).cpu()
        np.testing.assert_allclose(q.numpy(), S.sinkhorn(S.center_distance(d), eps, 50).numpy(),
                                   rtol=3e-4, atol=1e-6)
        assert torch.equal(S.balanced_assign(d.to(dev), eps, 50).cpu(),
                           S.balanced_assign(d, eps, 50))
    centers = torch.as_tensor(rng.standard_normal((16, 8)) * 5, dtype=torch.float32)
    x = centers[rng.integers(0, 16, 2000)] + torch.as_tensor(rng.standard_normal((2000, 8)),
                                                             dtype=torch.float32)
    init = K.init_centers(x, 16, 0)
    for fn in (K.kmeans, K.balanced_kmeans):
        c_card, l_card = fn(x.to(dev), 16, iters=10, centers=init)
        c_cpu, l_cpu = fn(x, 16, iters=10, centers=init)
        assert torch.equal(l_card.cpu(), l_cpu)
        _close(c_card.cpu(), c_cpu, torch.float32)


def test_one_process_nccl_trainer_matches_ungrouped(dev):
    """Three `Trainer` steps of a small Qwen3Multi (dropout 0.2, kernels on)
    inside a one-process NCCL group against the same steps ungrouped: one
    gradient all-reduce an update, losses within 1e-6, parameters equal."""
    import socket

    from gamer_tpu_torch.core import distributed
    from gamer_tpu_torch.entry import flagship_config, make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = flagship_config(num_hidden_layers=2, dtype="float32", dropout_rate=0.2)
    batches = [make_batch(cfg, 4, 20, np.random.default_rng(i)) for i in range(3)]

    def run():
        model = QwenFamilyModel(cfg, device=dev, seed=0)
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                          OptimizerConfig(total_steps=3), TrainLoopConfig())
        losses = [float(trainer.train_step(b)) for b in batches]
        return losses, torch.cat([p.detach().reshape(-1) for p in model.parameters()])

    plain = run()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    calls = trace.counter("all_reduce.flat")
    assert distributed.maybe_initialize(f"localhost:{port}", 1, 0, device="cuda", timeout_s=60)
    try:
        grouped = run()
    finally:
        distributed.shutdown()
    assert trace.counter("all_reduce.flat") - calls == 3
    np.testing.assert_allclose(grouped[0], plain[0], rtol=1e-6)
    _close(grouped[1], plain[1], torch.float32)


@pytest.mark.parametrize("backbone", ["SASRec", "GRU4Rec", "BERT4Rec", "MBSTR", "MBHT", "PBAT"])
def test_discriminative_step_card_matches_cpu(dev, backbone, tmp_path):
    """One fp32 training forward and backward of each zoo backbone at its
    shipped config (dropout on, masked-LM draws and hash-dropout seeds
    from one CPU generator) on the card against the CPU: loss within 1e-5
    relative, every grad within 1e-4 of its largest (chip_smoke phase 13's
    check, `chip_smoke.rec_steps_agree`: where fp32 is ill-conditioned,
    PBAT's covariance stream, within twice the CPU's error of a float64
    reference)."""
    import os

    import chip_smoke as cs
    from gamer_tpu_torch.core.checkpoint import CheckpointManager
    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n_items, n_users, his = 700, 50, 20
    L = his + 1 if backbone == "MBHT" else his
    cfg = DisModelConfig.from_file(os.path.join(repo, "config", "dis-models", backbone))
    if backbone == "MBHT":
        cfg = cfg.replace(scales=[5, 3, 7])  # the task's adjustment at length 21
    cfg.save(str(tmp_path))
    model = TR.build_dis_model(backbone, cfg, n_items, L, 3, n_users, "cpu", seed=4)
    CheckpointManager(str(tmp_path)).save("best", model.state_dict())
    batch = cs.random_rec_batch(64, L, his, n_items, n_users, seed=5)
    cs.rec_steps_agree(backbone, str(tmp_path), dev, batch, n_items, n_users)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_kernels_on_a_vocab_block_take_shifted_targets(dev, dtype):
    """Kernels j and k on one rank's rows of a split table (`modules/losses.
    vocab_shard_ce`): the targets shifted by the block's first row, so some
    are negative and some at or past its rows, match nothing there; k takes
    a global lse larger than the block's. Against the plain versions."""
    g = torch.Generator().manual_seed(3)
    N, D, V, v0 = 203, 256, 288, 288  # the second of four blocks of 1152 rows
    h = torch.randn(N, D, generator=g).to(dev, dtype)
    table = (torch.randn(V, D, generator=g) * 0.1).to(dev, dtype)
    targets = (torch.randint(0, 1041, (N,), generator=g) - v0).to(dev, torch.int32)
    assert (targets < 0).any() and (targets >= V).any() and ((targets >= 0) & (targets < V)).any()
    valid = (torch.rand(N, generator=g) > 0.1).to(dev, torch.int32)
    nll, lse = FC.ce_rows_fwd(h, table, targets, valid, 1.0)
    ref_nll, ref_lse = fused_ce_rows_plain(h.float(), table.float(), targets, valid, 1.0)
    torch.cuda.synchronize()
    _close(nll, ref_nll, dtype)
    _close(lse, ref_lse, dtype)
    lse_global = lse + torch.rand(N, generator=g).to(dev)
    gnll = torch.rand(N, generator=g).to(dev)
    dh, de = FC.fused_ce_rows_bwd(h, table, targets, valid, lse_global, gnll, 1.0)
    ref_dh, ref_de = FC.fused_ce_rows_bwd_lse_plain(h.float(), table.float(), targets, valid,
                                                    lse_global, gnll, 1.0)
    _close(dh, ref_dh, dtype)
    _close(de, ref_de, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernels_on_an_expert_slice(dev, dtype):
    """Kernels h and i on positions [p0, P) of a pass (a rank's experts,
    `modules/moe.py`) with the dropout seed moved by p0: against the plain
    versions of the whole pass at those positions, dropout 0.2."""
    from gamer_tpu_torch.modules.dropout import row_seed
    from gamer_tpu_torch.ops.fused_attention import _M2

    g = torch.Generator().manual_seed(4)
    P, p0, T, D, F, NB, seed, rate = 5, 2, 131, 64, 96, 4, 1234, 0.2
    rnd = lambda *s: (torch.randn(*s, generator=g) * 0.2).to(dev, dtype)
    xp, wgu, wd, btab = rnd(P, T, D), rnd(P, D, 2 * F), rnd(P, F, D), rnd(P, NB, 2 * F)
    beh = torch.randint(0, NB, (P, T), generator=g).to(dev, torch.int32)
    gout = rnd(P - p0, T, D)
    part = (xp[p0:], wgu[p0:], wd[p0:], btab[p0:], beh[p0:])
    shifted = row_seed(seed, p0, 1, _M2)
    out = fused_moe_ffn(*part, shifted, "silu", rate, True)
    leaves = [t.float().requires_grad_(True) for t in (xp, wgu, wd, btab)]
    whole = fused_moe_ffn_plain(*leaves, beh, True, seed, rate, "silu")
    torch.cuda.synchronize()
    _close(out, whole[p0:], dtype)
    grads = FM.fused_moe_ffn_bwd(*part, gout, shifted, rate, True, "silu")
    want = torch.autograd.grad(whole[p0:], leaves, gout.float())
    for got, ref in zip(grads, want):
        _close(got, ref[p0:], dtype)


def test_flagship_bf16_step_backward_reproduces(dev):
    """Two forward and backward passes of the flagship training step (bf16,
    B 64 x S 505, dropout 0.2, the kernels) with the same seeds give every
    grad bit for bit (`modules/layers.lookup`; `chip_smoke.py` phase 9)."""
    import chip_smoke as cs

    cfg = cs.flagship_config(dropout_rate=cs.DROP_RATE)
    cs._two_passes_agree(cfg, cs.make_batch(cfg, 64, 101, seed=3), dev)


def test_mbht_incidence_card_matches_cpu(dev):
    """MBHT's hypergraph incidence matrix at phase 13's geometry (the
    shipped config, batch 256 x 21, 6000 items) on the card against the CPU
    on the same weights and batch: the same edges (the top-k's `>=` against
    the sorted k-th largest and the 0.01 floor for negative similarities
    leave ties), their weights within 1e-5."""
    import os

    import chip_smoke as cs
    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n_items, n_users, his, L = 6000, 700, 20, 21
    cfg = DisModelConfig.from_file(os.path.join(repo, "config", "dis-models", "MBHT"))
    cfg = cfg.replace(scales=[5, 3, 7])  # the task's adjustment at length 21
    batch = cs.random_rec_batch(256, L, his, n_items, n_users, seed=13)
    mats = []
    for where in ("cpu", dev):
        model = TR.build_dis_model("MBHT", cfg, n_items, L, 3, n_users, where, seed=2)
        seq = torch.as_tensor(batch["inputs"], device=where)
        with torch.no_grad():
            mats.append(model.hypergraph.incidence(seq, model.item_embedding(seq.long()))[1].cpu())
    cpu, card = mats
    flips = int(((cpu > 0) != (card > 0)).sum())
    print(f"MBHT incidence B=256 L={L}: {int((cpu > 0).sum())} edges on the CPU, {flips} "
          f"differ on the card")
    assert flips == 0, f"{flips} hyperedges flip between the CPU and the card"
    torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- hash dropout


def _hd_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _hd_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_hd_bits(got), _hd_bits(want))


@pytest.mark.parametrize("rate", [0.2, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(64 * 505 * 8, 0), (1001, 0), (1001, 1), (7, 0)])
def test_hash_dropout_kernels_match_plain_bitwise(dev, rate, dtype, n, offset):
    """K1 with and without its residual and K2 against their plain versions
    on the same CUDA tensors, bit for bit: a length of whole 16-byte vectors,
    an odd length (the scalar tail), an offset pointer (the scalar route),
    fewer elements than one vector; rate 0.1's scale rounds in bf16."""
    g = torch.Generator().manual_seed(n + offset)
    y = torch.randn(n + offset, generator=g).to(dev, dtype)[offset:]
    r = torch.randn(n + offset, generator=g).to(dev, dtype)[offset:]
    from gamer_tpu_torch.modules.dropout import keep_threshold

    thr, kp = keep_threshold(rate)
    before = (trace.counter("launch.K1"), trace.counter("launch.K2"))
    _hd_same(HD.hash_dropout_fwd(y, 977, thr, kp, r), HD.hash_dropout_add_plain(y, 977, thr, kp, r))
    _hd_same(HD.hash_dropout_fwd(y, 977, thr, kp), HD.hash_dropout_add_plain(y, 977, thr, kp))
    _hd_same(HD.hash_dropout_bwd(y, 977, thr, kp), HD.apply_mask(y, 977, thr, kp))
    assert (trace.counter("launch.K1"), trace.counter("launch.K2")) == (before[0] + 2,
                                                                        before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hash_dropout_add_autograd_and_row0_on_card(dev, dtype):
    """`modules/dropout.hash_dropout_add` on the card: its output and the
    grads of both inputs equal the CPU's plain path bit for bit, rows from
    row0 > 0 draw the global batch's mask, one K1 and one K2 launch."""
    from gamer_tpu_torch.modules.dropout import hash_dropout_add

    g = torch.Generator().manual_seed(5)
    y, r, go = (torch.randn(6, 37, 24, generator=g).to(dtype) for _ in range(3))
    outs = {}
    for where in ("cpu", "cuda"):
        yy, rr = (t.to(where).requires_grad_(True) for t in (y, r))
        before = (trace.counter("launch.K1"), trace.counter("launch.K2"))
        out = hash_dropout_add(rr, yy, 41, 0.1, row0=2)
        dy, dr = torch.autograd.grad(out, (yy, rr), go.to(where))
        moved = (trace.counter("launch.K1") - before[0], trace.counter("launch.K2") - before[1])
        assert moved == ((1, 1) if where == "cuda" else (0, 0))
        outs[where] = [t.detach().cpu() for t in (out, dy, dr)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        _hd_same(got, want)
    # rows 2.. of a global batch of 8 from row 0
    full = hash_dropout_add(torch.cat([r[:2], r]).to(dev), torch.cat([y[:2], y]).to(dev), 41, 0.1)
    _hd_same(outs["cuda"][0], full[2:].cpu())


# --------------------------------------------------- the compiled training step

@pytest.mark.parametrize("optim", ["adamw", "adam", "sgd", "adagrad", "rmsprop", "lion"])
def test_fused_optimizer_matches_plain(dev, optim):
    """Kernel L (L1, L2) against `plain_update` over ragged tensors (odd
    lengths, a tensor under one chunk and one over two), five updates with
    the clip triggered on some: parameters and moments within 1e-5 of each
    tensor's largest entry (the norm is summed in fp64 by L, in fp32 by the
    plain version); a second run of L bit-identical."""
    from gamer_tpu_torch.train.state import Optimizer, OptimizerConfig, plain_update

    g = torch.Generator().manual_seed(3)
    shapes = [(7,), (3, 5), (129, 256), (40000,), (2, 3, 4)]
    start = {f"w{i}": torch.randn(s, generator=g).to(dev) for i, s in enumerate(shapes)}
    decay = {n: i % 2 == 0 for i, n in enumerate(start)}
    grads = [{n: (torch.randn(p.shape, generator=g) * (0.002 if i % 2 else 0.02)).to(dev)
              for n, p in start.items()} for i in range(5)]

    def run(kernel):
        params = {n: p.clone() for n, p in start.items()}
        opt = Optimizer(OptimizerConfig(optim=optim, learning_rate=1e-2, warmup_steps=1,
                                        total_steps=5, max_grad_norm=1.0, weight_decay=0.1),
                        params, decay)
        for gr in grads:
            opt.prepare()
            opt.apply(gr) if kernel else plain_update(opt, gr)
        return {"p": params, **{k: v for k, v in opt.state_dict().items() if k != "count"}}

    got, again, want = run(True), run(True), run(False)
    torch.cuda.synchronize()
    norms = [float(torch.sqrt(sum(t.square().sum() for t in gr.values()))) for gr in grads]
    assert min(norms) < 1.0 < max(norms)
    for slot, tensors in want.items():
        for n, w in tensors.items():
            assert (got[slot][n] - w).abs().max() <= 1e-5 * max(w.abs().max().item(), 1e-6)
            assert torch.equal(got[slot][n], again[slot][n])


def test_device_seed_kernels_equal_int_seed(dev):
    """a, b, h, i, K1 and K2 with their seed read from device memory (table
    entry plus an add) against the same value passed as an int: bit for bit."""
    from gamer_tpu_torch.modules.dropout import keep_threshold
    from gamer_tpu_torch.ops.seeds import DeviceSeed

    table = torch.tensor([5, 1234567, 2 ** 31 - 2], dtype=torch.int32, device=dev)
    seed, value = DeviceSeed(table, 2, 3_000_000_000), (2 ** 31 - 2 + 3_000_000_000) % 2 ** 32
    bits = lambda t: t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    same = lambda a, b: all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))
    g = torch.Generator().manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
    y, r = rnd(4, 33, 64), rnd(4, 33, 64)
    thr, kp = keep_threshold(0.2)
    for fn in (lambda s: HD.hash_dropout_fwd(y, s, thr, kp, r),
               lambda s: HD.hash_dropout_bwd(y, s, thr, kp)):
        assert same([fn(seed)], [fn(value)])
    q, k, v, streams, H = _attn_inputs(dev, torch.bfloat16, 77, 64, 1)

    def attention(s):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fused_mask_attention(*leaves, *streams, s, H, "causal", 0.2)
        return [out, *torch.autograd.grad(out.float().square().sum(), leaves)]

    assert same(attention(seed), attention(value))
    P, T, D, F = 3, 100, 64, 96
    xp, wgu, wd = rnd(P, T, D), rnd(P, D, 2 * F) * 0.1, rnd(P, F, D) * 0.1
    btab, beh = rnd(P, 2, 2 * F), torch.randint(0, 2, (P, T), dtype=torch.int32, device=dev)

    def moe(s):
        x = xp.clone().requires_grad_(True)
        out = fused_moe_ffn(x, wgu, wd, btab, beh, s, "silu", 0.2, use_bias=True)
        return [out, *torch.autograd.grad(out.float().square().sum(), (x,))]

    assert same(moe(seed), moe(value))


@pytest.mark.parametrize("k", [1, 2])
def test_graphed_trainer_matches_eager(dev, k):
    """Five `Trainer` steps of a small Qwen3Multi (bf16, dropout 0.2, kernels
    on) on two alternating batch shapes, captured as CUDA graphs and
    replayed, against the eager step: every loss and parameter bit for bit;
    one graph per (shape, accumulation phase)."""
    from gamer_tpu_torch.entry import flagship_config, make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = flagship_config(num_hidden_layers=2, dtype="bfloat16", dropout_rate=0.2)
    batches = [make_batch(cfg, 4, blocks, np.random.default_rng(blocks)) for blocks in (20, 13)]

    def run(graphed):
        model = QwenFamilyModel(cfg, device=dev, seed=0)
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                          OptimizerConfig(total_steps=5, warmup_steps=1),
                          TrainLoopConfig(gradient_accumulation_steps=k), graphed=graphed)
        losses = [trainer.train_step(batches[i % 2]) for i in range(5)]
        torch.cuda.synchronize()
        return losses, [p.detach().clone() for p in model.parameters()], trainer.graphs

    graphed, eager = run(True), run(False)
    assert graphed[2] == 2 and eager[2] == 0  # two shapes; k = 2 meets each in one phase
    assert all(torch.equal(a, b) for a, b in zip(graphed[0], eager[0]))
    assert all(torch.equal(a, b) for a, b in zip(graphed[1], eager[1]))


# ---- the compiled eval step and the compiled searches: CUDA graphs against
# the eager device parts

def _all_counters():
    import chip_smoke as cs

    return cs.kernel_counters()


def _reset(counters):
    for f in counters.values():
        f.launches = 0


def test_compiled_eval_matches_eager(dev):
    """`Trainer.evaluate` of a 2-layer Qwen3Multi (bf16, kernels on) over
    batches of 4, 4 and a short last 2, three times: compiled (the eval
    step captured once per batch shape and replayed) and eager
    (`graphed=False`) bit-identical; two graphs, each capture launching one
    scoring forward's kernels (a per self- and cross-attention, h per
    sparse layer, j once: the flagship's 12/8/1 per 8 layers) and no other
    kernel of the port, later evaluations launching nothing from Python; a
    replay under `set_sync_debug_mode("error")` does not raise."""
    import chip_smoke as cs
    from gamer_tpu_torch.entry import flagship_config, make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = flagship_config(num_hidden_layers=2, dtype="bfloat16")
    batches = [make_batch(cfg, B, 20, np.random.default_rng(s)) for s, B in enumerate((4, 4, 2))]
    counters = _all_counters()
    per_forward = cs._scoring_launches(cfg, True, counters)
    assert (per_forward["fused_mask_attention"], per_forward["fused_moe_ffn"]) == (
        cfg.num_hidden_layers + len(cfg.cross_attention_layers), len(cfg.sparse_layers))

    def run(graphed):
        model = QwenFamilyModel(cfg, device=dev, seed=0)
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model, OptimizerConfig(),
                          TrainLoopConfig(), eval_loss_fn=make_loss_fn(model, cfg), graphed=graphed)
        _reset(counters)
        captured = trace.counters("graph.capture.")
        losses = [trainer.evaluate(batches)]
        first = {k: f.launches for k, f in counters.items()}
        losses += [trainer.evaluate(batches) for _ in range(2)]
        again = {k: f.launches - first[k] for k, f in counters.items()}
        new = trace.counter("graph.capture.eval step") - captured.get("eval step", 0)
        return losses, trainer, first, again, new

    g_losses, trainer, first, again, new = run(True)
    e_losses, eager, e_first, _, e_new = run(False)
    assert g_losses == e_losses and np.isfinite(g_losses).all()
    assert trainer.eval_step().graphs == new == 2 and eager.eval_step().graphs == e_new == 0
    # two shapes: each key's warm-up and capture; nothing from Python after
    assert first == {k: 4 * n for k, n in per_forward.items()}, first
    assert not any(again.values()), again
    assert e_first == {k: 3 * n for k, n in per_forward.items()}, e_first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.eval_step().add(batches[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3MoeAction"])
def test_compiled_search_matches_eager(dev, backbone):
    """The decoder-only search objects (bf16 caches, 2 layers, batch 4, 6
    beams, 4 levels of 16 codes) compiled and eager, per-example, scalar and
    `None` behavior ids (the last over the behavior + item trie), each twice:
    codes and scores bit-identical; one graph per key (the scalar id
    replays the per-example graph), no kernel of the port (a-k, K1, K2, L,
    N2) launched in the captures or anywhere, and N1 once an attention
    block in the prefill and each decode step of every run of a device
    part (the eager calls; the warm-up and capture of each key); a replay under
    `set_sync_debug_mode("error")` does not raise."""
    import chip_smoke as cs
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.entry import flagship_config
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.modules.layers import GQAAttention

    cfg = (flagship_config(num_hidden_layers=2, dtype="bfloat16") if backbone == "Qwen3Multi"
           else _moe_action_config(num_hidden_layers=2, dtype="bfloat16"))
    model = QwenFamilyModel(cfg, device=dev, seed=0)
    trie, prompts, behaviors = cs.make_trie_and_prompts(cfg, 4, 200, 4, 16, 4)
    btrie, bprompts, _ = cs.make_trie_and_prompts(cfg, 4, 200, 4, 16, 4, behavior_level=True)
    counters = _all_counters()
    blocks = sum(isinstance(m, GQAAttention) for m in model.modules())
    # forwards of the device part: the calls' levels (item 4 x 4, behavior 2 x 5) when eager;
    # the warm-up and the capture of each key's first call when compiled
    forwards = {False: 4 * trie.num_levels + 2 * btrie.num_levels,
                True: 2 * trie.num_levels + 2 * btrie.num_levels}

    def run(graphed):
        item, beh = (make_beam_search_fn(model, t, BeamSearchConfig(num_beams=6),
                                         graphed=graphed) for t in (trie, btrie))
        _reset(counters)
        captured = trace.counter("graph.capture.beam search")
        outs = [fn(*args) for fn, args in ((item, (prompts, behaviors)), (item, (prompts, 2)),
                                           (beh, (bprompts, None))) for _ in range(2)]
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
        assert launches == {**{k: 0 for k in counters},
                            "qk_norm_rope_fwd": blocks * forwards[graphed]}, launches
        return outs, (item.graphs, beh.graphs,
                      trace.counter("graph.capture.beam search") - captured), item

    g_outs, g_graphs, item = run(True)
    e_outs, e_graphs, _ = run(False)
    assert g_graphs == (1, 1, 2) and e_graphs == (0, 0, 0)
    for (gc, gs), (ec, es) in zip(g_outs, e_outs):
        assert torch.equal(gc, ec) and torch.equal(gs, es)
    cs.check_beams(trie, *g_outs[0], 4, 6)
    cs.check_beams(btrie, *g_outs[4], 4, 6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        item(prompts, behaviors)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_compiled_encdec_search_matches_eager(dev, tmp_path):
    """The enc-dec search object (TIGER, bf16 caches, batch 4, 6 beams),
    compiled and eager, a shared and a per-row prefix of the same tokens
    (one key), each twice: codes and scores bit-identical, one graph, no
    kernel of the port launched."""
    from gamer_tpu_torch.data.vocab import SemanticVocab
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_encdec_fn
    from gamer_tpu_torch.decode.trie import LeveledTrie
    from gamer_tpu_torch.models.generative.encdec import EncDecModel, build_encdec_config

    levels = [16, 16, 16]
    vocab = SemanticVocab(levels, behaviors=["a", "b", "c"])
    cfg = build_encdec_config("TIGER", vocab_size=vocab.vocab_size, num_behavior=3,
                              behavior_base=14)
    model = EncDecModel(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    codes = np.unique(rng.integers(0, 16, (300, 3)), axis=0)
    trie = LeveledTrie.from_token_rows(vocab.encode_codes(codes), vocab)
    ids = rng.integers(17, vocab.vocab_size, (4, 20)).astype(np.int32)
    attn = np.ones((4, 20), np.int32)
    attn[1, 15:] = 0
    batch = {"input_ids": np.where(attn == 1, ids, 0).astype(np.int32), "attention_mask": attn}
    shared = np.array([cfg.decoder_start_token_id], np.int32)
    counters = _all_counters()

    def run(graphed):
        search = make_beam_search_encdec_fn(model, trie, BeamSearchConfig(num_beams=6),
                                            graphed=graphed)
        _reset(counters)
        captured = trace.counter("graph.capture.enc-dec beam search")
        outs = [search(batch, p) for p in (shared, shared, np.tile(shared, (4, 1)))]
        torch.cuda.synchronize()
        assert not any(f.launches for f in counters.values())
        return outs, search.graphs, trace.counter("graph.capture.enc-dec beam search") - captured

    g_outs, g_graphs, g_new = run(True)
    e_outs, e_graphs, e_new = run(False)
    assert (g_graphs, g_new, e_graphs, e_new) == (1, 1, 0, 0)
    for (gc, gs), (ec, es) in zip(g_outs, e_outs):
        assert torch.equal(gc, ec) and torch.equal(gs, es)


# ---- the zoo's and the RQ-VAE's compiled steps, scorer and emit

def _zoo_adamw(model):
    from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

    return make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-2, weight_decay=1e-4,
                                          lr_scheduler_type="constant", warmup_ratio=0.0,
                                          max_grad_norm=0.0), model)


@pytest.mark.parametrize("backbone", ["SASRec", "GRU4Rec", "BERT4Rec", "MBSTR", "MBHT", "PBAT"])
def test_compiled_rec_step_matches_eager(dev, backbone):
    """Four `RecTrainStep` steps (2 layers, width 32, 40 items, batch 8,
    dropout 0.3) compiled and eager from the same weights and generators:
    losses and every parameter bit-identical; one graph, its warm-up and
    capture launching K1 and K2 once a dropout site and L1 and L2 once
    each, the replays nothing from Python; `RecScorer` compiled (capture,
    replay) and eager bit-identical; a replay of the step under
    `set_sync_debug_mode("error")` does not raise."""
    import chip_smoke as cs
    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR

    cfg = DisModelConfig(n_layers=2, n_heads=2, hidden_size=32, inner_size=64,
                         embedding_size=32, dropout_prob=0.3, scales=[3, 3, 3], hyper_len=3,
                         num_buckets=8, max_distance=10)
    L = 9 if backbone == "MBHT" else 8
    batches = [cs.random_rec_batch(8, L, 8, 40, 12, seed=s) for s in range(4)]
    counters = _all_counters()

    def run(graphed):
        model = TR.build_dis_model(backbone, cfg, 40, L, 3, 12, dev, seed=0)
        step = TR.RecTrainStep(backbone, model, cfg, _zoo_adamw(model), graphed)
        _reset(counters)
        captured = trace.counter("graph.capture.rec training step")
        losses = [step(batches[0], TR.step_generator(0, 0))]
        first = {k: f.launches for k, f in counters.items()}
        losses += [step(b, TR.step_generator(0, i)) for i, b in enumerate(batches[1:], 1)]
        again = {k: f.launches - first[k] for k, f in counters.items()}
        scorer = TR.RecScorer(backbone, model, dev, graphed)
        scores = [scorer(batches[0]) for _ in range(2)]
        torch.cuda.synchronize()
        new = trace.counter("graph.capture.rec training step") - captured
        return ([float(x) for x in losses], model, step, first, again, new, scores)

    g_losses, g_model, g_step, first, again, new, g_scores = run(True)
    e_losses, e_model, e_step, e_first, _, e_new, e_scores = run(False)
    assert g_losses == e_losses and np.isfinite(g_losses).all()
    for (n, p), q in zip(g_model.named_parameters(), e_model.parameters()):
        assert torch.equal(p, q), n
    assert all(torch.equal(s, e_scores[0]) for s in g_scores + e_scores[1:])
    assert (g_step.staged.graphs, new, e_step.staged.graphs, e_new) == (1, 1, 0, 0)
    per_step = cs.staged_step_launches(g_model, True, counters)
    assert per_step["hash_dropout_fwd"] == g_model.dropout_sites > 0
    assert first == {k: 2 * n for k, n in per_step.items()}, first  # warm-up and capture
    assert not any(again.values()), again
    assert e_first == per_step, e_first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_step(batches[1], TR.step_generator(0, 9))
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("bn", [False, True])
def test_compiled_rqvae_step_and_emit_match_eager(dev, bn):
    """Four `RQVAEStep` steps (Sinkhorn on the last level, the CF and
    diversity losses on, dropout 0.2, BatchNorm off and on) compiled and
    eager from the same weights: each step's [loss, recon, quant, cf] and
    every parameter and running statistic bit-identical, one graph, the
    capture launching K1 and K2 once a layer and L1 and L2 once; then
    `RQVAEEmit` over 300 rows (a padded last chunk) compiled and eager on
    each model: the codes equal, one graph."""
    import chip_smoke as cs
    from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
    from gamer_tpu_torch.tasks import rqvae as TR

    cfg = RQVAEConfig(in_dim=96, num_emb_list=[32, 32, 16], e_dim=16, layers=[128, 64], bn=bn,
                      dropout_prob=0.2, alpha=0.02, beta=0.01, sk_epsilons=[0.0, 0.0, 0.003])
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((300, 96)), dtype=torch.float32, device=dev)
    cf = torch.as_tensor(rng.standard_normal((300, 16)), dtype=torch.float32, device=dev)
    labels = rng.integers(0, 4, (3, 32))
    rows = [rng.permutation(300)[:64] for _ in range(4)]
    counters = _all_counters()

    def run(graphed):
        model = RQVAE(cfg, device=dev, seed=1)
        step = TR.RQVAEStep(model, _zoo_adamw(model), x, cf, graphed)
        step.set_labels(labels)
        _reset(counters)
        before = trace.counters("graph.capture.")
        outs = [step(r, TR.step_generator(0, 0, i)) for i, r in enumerate(rows)]
        launches = {k: f.launches for k, f in counters.items()}
        emit = TR.RQVAEEmit(model, x, 64, graphed)
        codes = [emit() for _ in range(2)]
        new = {k: n - before.get(k, 0) for k, n in trace.counters("graph.capture.").items()
               if n > before.get(k, 0)}
        return torch.stack(outs).tolist(), model, launches, new, codes

    g_outs, g_model, g_launches, g_new, g_codes = run(True)
    e_outs, e_model, e_launches, e_new, e_codes = run(False)
    assert g_outs == e_outs and np.isfinite(g_outs).all()
    for (n, t), u in zip(g_model.state_dict().items(), e_model.state_dict().values()):
        assert torch.equal(t, u), n
    assert all((c == e_codes[0]).all() for c in g_codes + e_codes[1:])
    assert g_new == {"rq-vae training step": 1, "rq-vae emit": 1} and e_new == {}
    per_step = cs.staged_step_launches(g_model, True, counters)
    assert per_step["hash_dropout_fwd"] == 6
    assert g_launches == {k: 2 * n for k, n in per_step.items()}, g_launches
    assert e_launches == {k: 4 * n for k, n in per_step.items()}, e_launches


# ---- capture under a process group; the RQ-VAE's reclustering as one graph

@pytest.mark.parametrize("k", [1, 2])
def test_one_process_nccl_graphed_trainer_matches_eager(dev, k):
    """Four updates of a small Qwen3Multi (bf16, dropout 0.2, kernels on) in
    a one-process NCCL group, captured (one graph a key) and replayed,
    against the same steps with `graphed=False` in the same group: every
    loss and parameter bit for bit; the counter `all_reduce.flat` one an update in
    both forms, replays counted; the captures issue the step's all-reduces
    on the capturing stream (the (loss·w, w) one a micro-step and the
    gradient one an update: a one-rank NCCL all-reduce launches no kernel,
    so a profile cannot show them), the eager steps the same ones each."""
    import socket

    import chip_smoke as cs
    from gamer_tpu_torch.core import distributed
    from gamer_tpu_torch.entry import flagship_config, make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = flagship_config(num_hidden_layers=2, dtype="bfloat16", dropout_rate=0.2)
    batches = [make_batch(cfg, 4, 20, np.random.default_rng(i)) for i in range(2 * k)]

    def run(graphed):
        model = QwenFamilyModel(cfg, device=dev, seed=0)
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                          OptimizerConfig(total_steps=6, warmup_steps=1),
                          TrainLoopConfig(gradient_accumulation_steps=k), graphed=graphed)
        calls = trace.counter("all_reduce.flat")
        with cs._issued_all_reduces() as issued:
            losses = [trainer.train_step(batches[i % len(batches)]) for i in range(4 * k)]
            torch.cuda.synchronize()
        reduces = trace.counter("all_reduce.flat") - calls
        params = [p.detach().clone() for p in model.parameters()]
        return losses, params, trainer.graphs, trainer.captures, reduces, issued

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert distributed.maybe_initialize(f"localhost:{port}", 1, 0, device="cuda", timeout_s=120)
    try:
        assert distributed.backend() == "nccl"
        graphed, eager = run(True), run(False)
    finally:
        distributed.shutdown()
    assert graphed[2:4] == (k, True) and eager[2:4] == (0, False)
    assert graphed[4] == eager[4] == 4  # one gradient all-reduce an update, replays counted
    # each key's first micro-step runs eagerly (the warm-up), then is captured; replays
    # issue nothing from Python
    assert (graphed[5].count(False), graphed[5].count(True)) == (k + 1, k + 1), graphed[5]
    assert eager[5] == [False] * 4 * (k + 1), eager[5]
    assert all(torch.equal(a, b) for a, b in zip(graphed[0], eager[0]))
    assert all(torch.equal(a, b) for a, b in zip(graphed[1], eager[1]))


def test_compiled_recluster_matches_eager(dev):
    """`RQVAERecluster` on levels of 64, 32 and 48 codes (16-d, 10
    clusters) compiled and eager at epochs 0-3, the codebooks moving between
    epochs: labels bit-identical at every epoch; one graph ("rq-vae
    recluster"), captured at the first call and replayed at the others,
    each replay drawing from the seeds staged for its epoch (its labels
    differ from the first epoch's)."""
    from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
    from gamer_tpu_torch.tasks import rqvae as TR

    cfg = RQVAEConfig(in_dim=32, num_emb_list=[64, 32, 48], e_dim=16, layers=[64], beta=0.01,
                      sk_epsilons=[0.0, 0.0, 0.003])
    runs = {}
    for graphed in (True, False):
        model = RQVAE(cfg, device=dev, seed=2)
        labels = torch.zeros((3, 64), dtype=torch.int64, device=dev)
        recluster = TR.RQVAERecluster(model, labels, graphed)
        before = trace.counter("graph.capture.rq-vae recluster")
        out = []
        for epoch in range(4):
            recluster(7, epoch)
            out.append(labels.clone())
            with torch.no_grad():
                model.codebooks.mul_(1.01).add_(0.01)
        torch.cuda.synchronize()
        runs[graphed] = (out, recluster.staged.graphs,
                         trace.counter("graph.capture.rq-vae recluster") - before)
    (g, g_graphs, g_new), (e, e_graphs, e_new) = runs[True], runs[False]
    assert (g_graphs, g_new, e_graphs, e_new) == (1, 1, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(g, e))
    assert not torch.equal(g[0], g[1])


@pytest.mark.parametrize("n,d,k", [(256, 32, 10), (512, 16, 64)])
def test_kmeans_seeding_card_matches_cpu(dev, n, d, k):
    """The device seeding (`ops/kmeans.init_centers`) of the same points on
    the card and on the CPU, seeds 0-5: equal centers are expected. Where a
    center differs, the first one that does is shown to come from the two
    devices' rounding: on the shared prefix of centers, one of its
    candidates' uniform lies within 1e-4 of the total of a boundary of the
    float64 cumulative sum of the running distances, or the two best
    candidates' potentials lie within 1e-5 of each other."""
    from gamer_tpu_torch.ops import kmeans as K

    rng = np.random.default_rng(n + k)
    x = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    trials = K.seeding_trials(k)
    equal = 0
    for seed in range(6):
        cpu = K.init_centers(x, k, seed)
        card = K.init_centers(x.to(dev), k, seed).cpu()
        if torch.equal(cpu, card):
            equal += 1
            continue
        i0 = int((cpu != card).any(dim=1).nonzero()[0])
        x64, shared = x.double(), cpu[:i0].double()
        dmin = ((x64[:, None] - shared[None]) ** 2).sum(-1).min(1).values
        cum = dmin.clamp(min=1e-12).cumsum(0)
        target = K.seeding_uniforms(seed, k, trials, "cpu")[i0] * cum[-1]
        boundary = float(((cum[None] - target[:, None]).abs().min(1).values / cum[-1]).min())
        cand = torch.searchsorted(cum, target, right=True).clamp(max=n - 1)
        cx = x64[cand]
        pot = torch.minimum(dmin[None], ((x64[None] - cx[:, None]) ** 2).sum(-1)).sum(1)
        top = pot.sort().values
        tie = float((top[1] - top[0]) / top[0]) if len(set(cand.tolist())) > 1 else 1.0
        assert boundary <= 1e-4 or tie <= 1e-5, (seed, i0, boundary, tie)
    assert equal >= 1, "no seed gave the same centers on the card and the CPU"

