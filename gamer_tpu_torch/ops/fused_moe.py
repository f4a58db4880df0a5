"""Fused position-routed SwiGLU MoE-FFN: kernel h (forward) and kernel i (backward).

`fused_moe_ffn` is the counterpart of `gamer_tpu/ops/pallas_moe.py`
`fused_moe_ffn`, on the expert-major layout: xp [P, T, D], wgu [P, D, 2F]
(gate | up), wdown [P, F, Dout], btab [P, NB, 2F] per-behavior bias rows,
beh [P, T] int32 bias ids, `seed` and `rate` of the hash dropout on h, keyed
on (seed, expert p, row t, column f); the seed an int or a seed in device
memory (`ops/seeds.DeviceSeed`), which the kernels read on the card. For CUDA tensors it launches
`csrc/fused_moe_fwd.cu` behind a `torch.autograd.Function` whose backward
launches `csrc/fused_moe_bwd.cu` (`fused_moe_ffn_bwd`): dx plus dWgu, dWd and
dbtab summed in fp32 and cast to the weights' dtype, as the TPU kernel does.
The activation is silu, relu, or the tanh approximation of gelu for both
"gelu" and "gelu_new" (`ACTS`, jax.nn.gelu's default, as the TPU kernel
computes it); another name raises ValueError. The C entry points pick the
kernels by dtype before any launch: bf16 runs on the tensor cores (h rounded
to bf16 before the down product, dgu and h_drop before the products that read
them, dbtab summed from the fp32 dgu, as the TPU kernel does), fp32 on the
CUDA cores (full fp32). For CPU tensors it runs `fused_moe_ffn_plain`, whose
backward is autograd.

Widths: every D, F and Dout runs through the kernels. The one rule, in
`_padded`: in bf16 the wrapper zero-pads D, F and Dout to multiples of 16 and
slices the outputs and grads back, which is exact (padded x columns meet zero
weight rows, padded F columns give g = u = 0 and act(0) * 0 = 0, and the
dropout hash keys on the real columns, which do not move); at the flagship
widths nothing is padded or copied. Wide D (over 256 in bf16, over 512 in
fp32) takes the kernels' streamed routes. Unlike the TPU kernel, T needs no
padding to a tile multiple.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build
from gamer_tpu_torch.ops.fused_attention import (
    _DROPOUT_ARGTYPES, _dropout_args, hash_keep, keep_fraction)

TM = 64  # row tile of the kernels; the bf16 backward sums dbtab per row tile

ACTS = {"silu": F.silu, "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_new": lambda x: F.gelu(x, approximate="tanh")}
ACT_CODES = {"silu": 0, "relu": 1, "gelu": 2, "gelu_new": 2}  # moe_tc.cuh gamer::moe::Act


def act_code(act_name: str) -> int:
    if act_name not in ACT_CODES:
        raise ValueError(f"the fused MoE FFN computes {sorted(ACT_CODES)}, not {act_name!r}")
    return ACT_CODES[act_name]


def moe_keep_mask(seed: int, P: int, T: int, F: int, rate: float, device=None) -> torch.Tensor:
    """[P, T, F] keep mask of h: the hash of (seed, expert, row, column)."""
    p = torch.arange(P, dtype=torch.int64, device=device).view(P, 1, 1)
    t = torch.arange(T, dtype=torch.int64, device=device).view(1, T, 1)
    f = torch.arange(F, dtype=torch.int64, device=device).view(1, 1, F)
    return hash_keep(seed, p, t, f, rate)


def fused_moe_ffn_plain(xp, wgu, wdown, btab, beh, use_bias: bool = False, seed: int = 0,
                        rate: float = 0.0, act_name: str = "silu") -> torch.Tensor:
    """Plain PyTorch version: fp32 products, bias rows selected by id (ids
    outside [0, NB) add nothing), the same hash dropout, output in xp's
    dtype; differentiable by autograd."""
    act_code(act_name)
    act = ACTS[act_name]
    Fd = wdown.shape[1]
    gu = torch.bmm(xp.float(), wgu.float())  # [P, T, 2F]
    if use_bias:
        onehot = (beh.long()[..., None] == torch.arange(btab.shape[1], device=beh.device))
        gu = gu + torch.bmm(onehot.float(), btab.float())
    h = act(gu[..., :Fd]) * gu[..., Fd:]
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
    return (P, T, D, Fd, Dout, NB, *(_build.aligned(t) for t in (xp, wgu, wdown, btab)),
            beh.to(dtype=torch.int32).contiguous())


def _padded(xp, wdown) -> tuple[int, int, int]:
    """(D, F, Dout) as the kernels take them: multiples of 16 in bf16 (the
    module docstring's one width rule), unchanged in fp32."""
    D, Fd, Dout = xp.shape[2], wdown.shape[1], wdown.shape[2]
    if xp.dtype != torch.bfloat16:
        return D, Fd, Dout
    return tuple(-(-n // 16) * 16 for n in (D, Fd, Dout))


def _pad_gu(t: torch.Tensor, rows: int, Fp: int) -> torch.Tensor:
    """[P, R, 2F] (gate | up) zero-padded to [P, rows, 2 Fp], each half apart."""
    P, R, F2 = t.shape
    t = t.reshape(P, R, 2, F2 // 2)
    return F.pad(t, (0, Fp - F2 // 2, 0, 0, 0, rows - R)).reshape(P, rows, 2 * Fp)


def _unpad_gu(t: torch.Tensor, rows: int, Fd: int) -> torch.Tensor:
    P, R, F2 = t.shape
    return t.reshape(P, R, 2, F2 // 2)[:, :rows, :, :Fd].reshape(P, rows, 2 * Fd)


def weight_grad_splits(T: int, P: int, D: int, F: int, Dout: int, sms: int,
                       bf16: bool) -> tuple[int, int, int, int, int, int]:
    """(n_gu, kc_gu, n_d, kc_d, n_b, kc_b): the splits over T, and the rows a
    split covers, of kernel i's dWgu, dWd and dbtab sums on `sms` SMs
    (`_build.split_rows`: output tiles times splits fit two waves of two CTAs
    an SM, whole 32-row k slices). The products' output tiles are 128 x 128
    in bf16 (tensor cores) and 64 x 64 in fp32; bf16 sums dbtab per 64-row
    tile in pass 1, fp32 in a kernel of 256 columns a CTA. On 132 SMs at the
    flagship (P 5, T 6464, D = Dout 256, F 512) in bf16: dWgu 80 tiles in 6
    splits of 1088 rows (480 CTAs), dWd 40 tiles in 13 splits of 512 (520),
    dbtab in the 101 row tiles."""
    tile = 128 if bf16 else 64
    tiles = lambda m, n: P * math.ceil(m / tile) * math.ceil(n / tile)
    n_gu, kc_gu = _build.split_rows(T, tiles(D, 2 * F), sms, 32)
    n_d, kc_d = _build.split_rows(T, tiles(F, Dout), sms, 32)
    if bf16:
        n_b, kc_b = math.ceil(T / TM), TM
    else:
        n_b, kc_b = _build.split_rows(T, P * math.ceil(2 * F / 256), sms, 1)
    return n_gu, kc_gu, n_d, kc_d, n_b, kc_b


_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + _DROPOUT_ARGTYPES + [
    ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + _DROPOUT_ARGTYPES + [
    ctypes.c_int] * 7 + [ctypes.c_void_p]


def _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name="silu"):
    act = act_code(act_name)
    P, T, D, Fd, Dout, NB, xp, wgu, wdown, btab, beh = _check(xp, wgu, wdown, btab, beh)
    Dp, Fp, Doutp = _padded(xp, wdown)
    if (Dp, Fp, Doutp) != (D, Fd, Dout):
        xp = F.pad(xp, (0, Dp - D))
        wgu, btab = _pad_gu(wgu, Dp, Fp), _pad_gu(btab, NB, Fp)
        wdown = F.pad(wdown, (0, Doutp - Dout, 0, Fp - Fd))
    out = torch.empty((P, T, Doutp), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        _build.launch("fused_moe_fwd", _FWD_ARGTYPES, xp.data_ptr(), wgu.data_ptr(),
                      wdown.data_ptr(), btab.data_ptr(), beh.data_ptr(), out.data_ptr(),
                      P, T, Dp, Fp, Doutp, NB, int(use_bias), act,
                      *_dropout_args(seed, rate, xp.device),
                      _build.dtype_code(xp), _build.stream_of(xp))
    trace.count("launch.h")
    return out if Doutp == Dout else out[..., :Dout]


def fused_moe_ffn_bwd(xp, wgu, wdown, btab, beh, gout, seed: int = 0, rate: float = 0.0,
                      use_bias: bool = False, act_name: str = "silu"):
    """Kernel i: (dx, dwgu, dwdown, dbtab) of `fused_moe_ffn` for the
    incoming gradient gout [P, T, Dout] (CUDA tensors only). The weight
    gradients are summed in fp32 and come out in the weights' dtype."""
    if xp.device.type != "cuda":
        raise ValueError(f"fused_moe_ffn_bwd launches a CUDA kernel; got {xp.device}")
    act = act_code(act_name)
    P, T, D, Fd, Dout, NB, xp, wgu, wdown, btab, beh = _check(xp, wgu, wdown, btab, beh)
    if gout.shape != (P, T, Dout):
        raise ValueError(f"gout must be [P, T, Dout], got {tuple(gout.shape)}")
    gout = gout.to(xp.dtype)
    real = (D, Fd, Dout)
    D, Fd, Dout = _padded(xp, wdown)
    if (D, Fd, Dout) != real:
        xp = F.pad(xp, (0, D - real[0]))
        wgu, btab = _pad_gu(wgu, D, Fd), _pad_gu(btab, NB, Fd)
        wdown = F.pad(wdown, (0, Dout - real[2], 0, Fd - real[1]))
        gout = F.pad(gout, (0, Dout - real[2]))
    gout = _build.aligned(gout)
    sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
    n_gu, kc_gu, n_d, kc_d, n_b, kc_b = weight_grad_splits(T, P, D, Fd, Dout, sms,
                                                           xp.dtype == torch.bfloat16)
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
                      int(use_bias), act, *_dropout_args(seed, rate, xp.device), n_gu, kc_gu,
                      n_d, kc_d, n_b, kc_b, _build.dtype_code(xp), _build.stream_of(xp))
    trace.count("launch.i")
    if (D, Fd, Dout) != real:
        dx, dwd = dx[..., :real[0]], dwd[:, :real[1], :real[2]]
        dwgu, dbtab = _unpad_gu(dwgu, real[0], real[1]), _unpad_gu(dbtab, NB, real[1])
    return dx, dwgu, dwd, dbtab


def fused_moe_ffn_bwd_plain(xp, wgu, wdown, btab, beh, gout, seed: int = 0, rate: float = 0.0,
                            use_bias: bool = False, act_name: str = "silu"):
    """Plain version of kernel i: autograd through the plain forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xp, wgu, wdown, btab)]
        out = fused_moe_ffn_plain(*leaves, beh, use_bias, seed, rate, act_name)
        return torch.autograd.grad(out, leaves, gout, allow_unused=True, materialize_grads=True)


class _FusedMoE(torch.autograd.Function):
    """Kernel h forward, kernel i backward."""

    @staticmethod
    def forward(ctx, xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name):
        ctx.save_for_backward(xp, wgu, wdown, btab, beh)
        ctx.args = (seed, rate, use_bias, act_name)
        return _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name)

    @staticmethod
    def backward(ctx, gout):
        xp, wgu, wdown, btab, beh = ctx.saved_tensors
        grads = fused_moe_ffn_bwd(xp, wgu, wdown, btab, beh, gout, *ctx.args)
        return (*grads, None, None, None, None, None)


def fused_moe_ffn(xp, wgu, wdown, btab, beh, seed: int = 0, act_name: str = "silu",
                  rate: float = 0.0, use_bias: bool = False) -> torch.Tensor:
    """xp [P, T, D], wgu [P, D, 2F], wdown [P, F, Dout], btab [P, NB, 2F],
    beh [P, T] int -> [P, T, Dout]; differentiable in xp, wgu, wdown, btab."""
    act_code(act_name)
    if xp.device.type == "cpu":
        return fused_moe_ffn_plain(xp, wgu, wdown, btab, beh, use_bias, seed, rate, act_name)
    if xp.device.type != "cuda":
        raise ValueError(f"fused_moe_ffn runs on cuda or cpu, not {xp.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xp, wgu, wdown, btab)):
        return _FusedMoE.apply(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name)
    return _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name)
