"""Fused position-routed SwiGLU MoE-FFN: kernel h (forward) and kernel i (backward).

`fused_moe_ffn` is the counterpart of `gamer_tpu/ops/pallas_moe.py`
`fused_moe_ffn`, on the expert-major layout: xp [P, T, D], wgu [P, D, 2F]
(gate | up), wdown [P, F, Dout], btab [P, NB, 2F] per-behavior bias rows,
beh [P, T] int32 bias ids, `seed` and `rate` of the hash dropout on h, keyed
on (seed, expert p, row t, column f). For CUDA tensors it launches
`csrc/fused_moe_fwd.cu` behind a `torch.autograd.Function` whose backward
launches `csrc/fused_moe_bwd.cu` (`fused_moe_ffn_bwd`): dx plus dWgu, dWd and
dbtab summed in fp32 and cast to the weights' dtype, as the TPU kernel does.
For CPU tensors it runs `fused_moe_ffn_plain`, whose backward is autograd.
Unlike the TPU kernel, T needs no padding to a tile multiple.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from gamer_tpu_torch.ops import _build
from gamer_tpu_torch.ops.fused_attention import (
    _dropout_args, hash_keep, keep_fraction)


def moe_keep_mask(seed: int, P: int, T: int, F: int, rate: float, device=None) -> torch.Tensor:
    """[P, T, F] keep mask of h: the hash of (seed, expert, row, column)."""
    p = torch.arange(P, dtype=torch.int64, device=device).view(P, 1, 1)
    t = torch.arange(T, dtype=torch.int64, device=device).view(1, T, 1)
    f = torch.arange(F, dtype=torch.int64, device=device).view(1, 1, F)
    return hash_keep(seed, p, t, f, rate)


def fused_moe_ffn_plain(xp, wgu, wdown, btab, beh, use_bias: bool = False, seed: int = 0,
                        rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: fp32 products, bias rows selected by id (ids
    outside [0, NB) add nothing), the same hash dropout, output in xp's
    dtype; differentiable by autograd."""
    Fd = wdown.shape[1]
    gu = torch.bmm(xp.float(), wgu.float())  # [P, T, 2F]
    if use_bias:
        onehot = (beh.long()[..., None] == torch.arange(btab.shape[1], device=beh.device))
        gu = gu + torch.bmm(onehot.float(), btab.float())
    h = F.silu(gu[..., :Fd]) * gu[..., Fd:]
    if rate > 0.0:
        keep = moe_keep_mask(seed, xp.shape[0], xp.shape[1], Fd, rate, xp.device)
        h = torch.where(keep, h * (1.0 / keep_fraction(rate)), 0.0)
    return torch.bmm(h, wdown.float()).to(xp.dtype)


def _check(xp, wgu, wdown, btab, beh):
    P, T, D = xp.shape
    Fd, Dout = wdown.shape[1], wdown.shape[2]
    NB = btab.shape[1]
    if (wgu.shape != (P, D, 2 * Fd) or wdown.shape[0] != P or btab.shape != (P, NB, 2 * Fd)
            or beh.shape != (P, T)):
        raise ValueError(f"bad MoE shapes xp {tuple(xp.shape)} wgu {tuple(wgu.shape)} "
                         f"wdown {tuple(wdown.shape)} btab {tuple(btab.shape)} beh {tuple(beh.shape)}")
    if any(t.dtype != xp.dtype for t in (wgu, wdown, btab)):
        raise TypeError("xp, wgu, wdown and btab must share one dtype")
    return P, T, D, Fd, Dout, NB


_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
    ctypes.c_uint, ctypes.c_uint, ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias):
    P, T, D, Fd, Dout, NB = _check(xp, wgu, wdown, btab, beh)
    xp, wgu, wdown, btab = (t.contiguous() for t in (xp, wgu, wdown, btab))
    beh = beh.to(dtype=torch.int32).contiguous()
    out = torch.empty((P, T, Dout), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        _build.launch("fused_moe_fwd", _FWD_ARGTYPES, xp.data_ptr(), wgu.data_ptr(),
                      wdown.data_ptr(), btab.data_ptr(), beh.data_ptr(), out.data_ptr(),
                      P, T, D, Fd, Dout, NB, int(use_bias), *_dropout_args(seed, rate),
                      _build.dtype_code(xp), _build.stream_of(xp))
    fused_moe_ffn.launches += 1
    return out


def fused_moe_ffn_bwd(xp, wgu, wdown, btab, beh, gout, seed: int = 0, rate: float = 0.0,
                      use_bias: bool = False):
    """Kernel i: (dx, dwgu, dwdown, dbtab) of `fused_moe_ffn` for the
    incoming gradient gout [P, T, Dout] (CUDA tensors only). The weight
    gradients are summed in fp32 and come out in the weights' dtype."""
    if xp.device.type != "cuda":
        raise ValueError(f"fused_moe_ffn_bwd launches a CUDA kernel; got {xp.device}")
    P, T, D, Fd, Dout, NB = _check(xp, wgu, wdown, btab, beh)
    if gout.shape != (P, T, Dout):
        raise ValueError(f"gout must be [P, T, Dout], got {tuple(gout.shape)}")
    xp, wgu, wdown, btab = (t.contiguous() for t in (xp, wgu, wdown, btab))
    beh = beh.to(dtype=torch.int32).contiguous()
    gout = gout.to(xp.dtype).contiguous()
    # T is split so that the weight-gradient products fill the card
    splits = lambda tiles, multiple=32: _build.row_splits(T, tiles, xp.device, multiple)
    n_gu, kc_gu = splits(P * math.ceil(D / 64) * math.ceil(2 * Fd / 64))
    n_d, kc_d = splits(P * math.ceil(Fd / 64) * math.ceil(Dout / 64))
    n_b, kc_b = splits(P * math.ceil(2 * Fd / 256), multiple=1)
    ws_size = max(n_gu * P * D * 2 * Fd, n_d * P * Fd * Dout, n_b * P * NB * 2 * Fd)
    ws = torch.empty(ws_size, dtype=torch.float32, device=xp.device)
    dgu = torch.empty((P, T, 2 * Fd), dtype=xp.dtype, device=xp.device)
    hdrop = torch.empty((P, T, Fd), dtype=xp.dtype, device=xp.device)
    dx = torch.empty_like(xp)
    dwgu, dwd = torch.empty_like(wgu), torch.empty_like(wdown)
    dbtab = torch.empty_like(btab) if use_bias else torch.zeros_like(btab)
    with torch.cuda.device(xp.device):
        _build.launch("fused_moe_bwd", _BWD_ARGTYPES, xp.data_ptr(), wgu.data_ptr(),
                      wdown.data_ptr(), btab.data_ptr(), beh.data_ptr(), gout.data_ptr(),
                      dx.data_ptr(), dwgu.data_ptr(), dwd.data_ptr(), dbtab.data_ptr(),
                      dgu.data_ptr(), hdrop.data_ptr(), ws.data_ptr(), P, T, D, Fd, Dout, NB,
                      int(use_bias), *_dropout_args(seed, rate), n_gu, kc_gu, n_d, kc_d,
                      n_b, kc_b, _build.dtype_code(xp), _build.stream_of(xp))
    fused_moe_ffn_bwd.launches += 1
    return dx, dwgu, dwd, dbtab


def fused_moe_ffn_bwd_plain(xp, wgu, wdown, btab, beh, gout, seed: int = 0, rate: float = 0.0,
                            use_bias: bool = False):
    """Plain version of kernel i: autograd through the plain forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xp, wgu, wdown, btab)]
        out = fused_moe_ffn_plain(*leaves, beh, use_bias, seed, rate)
        return torch.autograd.grad(out, leaves, gout, allow_unused=True, materialize_grads=True)


class _FusedMoE(torch.autograd.Function):
    """Kernel h forward, kernel i backward."""

    @staticmethod
    def forward(ctx, xp, wgu, wdown, btab, beh, seed, rate, use_bias):
        ctx.save_for_backward(xp, wgu, wdown, btab, beh)
        ctx.args = (seed, rate, use_bias)
        return _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias)

    @staticmethod
    def backward(ctx, gout):
        xp, wgu, wdown, btab, beh = ctx.saved_tensors
        grads = fused_moe_ffn_bwd(xp, wgu, wdown, btab, beh, gout, *ctx.args)
        return (*grads, None, None, None, None)


def fused_moe_ffn(xp, wgu, wdown, btab, beh, seed: int = 0, act_name: str = "silu",
                  rate: float = 0.0, use_bias: bool = False) -> torch.Tensor:
    """xp [P, T, D], wgu [P, D, 2F], wdown [P, F, Dout], btab [P, NB, 2F],
    beh [P, T] int -> [P, T, Dout]; differentiable in xp, wgu, wdown, btab."""
    if act_name != "silu":
        raise NotImplementedError(f"the fused MoE FFN computes silu, not {act_name!r}")
    if xp.device.type == "cpu":
        return fused_moe_ffn_plain(xp, wgu, wdown, btab, beh, use_bias, seed, rate)
    if xp.device.type != "cuda":
        raise ValueError(f"fused_moe_ffn runs on cuda or cpu, not {xp.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xp, wgu, wdown, btab)):
        return _FusedMoE.apply(xp, wgu, wdown, btab, beh, seed, rate, use_bias)
    return _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias)


fused_moe_ffn.launches = 0  # kernel h launches, for run reports
fused_moe_ffn_bwd.launches = 0  # kernel i launches
