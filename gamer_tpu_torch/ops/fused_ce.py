"""Fused tied-head cross-entropy: kernel j (forward) and kernel k (backward).

`fused_ce_rows` is the counterpart of `gamer_tpu/ops/pallas_ce.py`
`fused_ce_rows`: per row of the final hidden states h [N, D] against the tied
table [V, D], fp32 logits scaled by inv_t that are never stored, their
logsumexp, and nll = lse - logit[target] on valid rows (0 elsewhere). For
CUDA tensors it launches `csrc/fused_ce_fwd.cu` behind a
`torch.autograd.Function` whose backward launches `csrc/fused_ce_bwd.cu`
(`fused_ce_rows_bwd`): dh = (softmax - onehot) * g * inv_t . E and an fp32 dE
cast to the table's dtype. The C entry points pick the kernels by dtype
before any launch: bf16 runs on the tensor cores (dlog rounded to bf16
before its two products, as the TPU kernel does), fp32 on the CUDA cores
(full fp32). For CPU tensors it runs `fused_ce_rows_plain`, whose backward is
autograd. Neither N nor V needs padding.

Widths: every D runs through the kernels. The one rule, in `_padded_d`: in
bf16 the wrapper zero-pads D to a multiple of 16 (h and the table alike, so
every logit is unchanged) and slices dh and dE back; at the flagship width
nothing is padded or copied. D over 256 (both kernels, both dtypes; the fp32
forward from 513) takes the kernels' wide routes, which tile dh and dE over
the grid and stream the logits over D.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build

TM, VC = 64, 64  # row tile and vocab tile of the kernels


def fused_ce_rows_plain(h, table, targets, valid, inv_t: float):
    """Plain PyTorch version; the target logit is picked by a column compare,
    as in the kernel (a target outside [0, V) reads 0)."""
    logits = (h.float() @ table.float().T) * inv_t  # [N, V]
    lse = torch.logsumexp(logits, dim=-1)
    cols = torch.arange(table.shape[0], device=h.device)
    tl = torch.where(cols[None, :] == targets.long()[:, None], logits, 0.0).sum(dim=-1)
    nll = torch.where(valid == 1, lse - tl, 0.0)
    return nll, lse


def _check(h, table, targets, valid):
    N, D = h.shape
    V = table.shape[0]
    if table.shape != (V, D) or targets.shape != (N,) or valid.shape != (N,):
        raise ValueError(f"bad CE shapes h {tuple(h.shape)} table {tuple(table.shape)} "
                         f"targets {tuple(targets.shape)} valid {tuple(valid.shape)}")
    if table.dtype != h.dtype:
        raise TypeError("h and table must share one dtype")
    Dp = _padded_d(h)
    if Dp != D:
        h, table = F.pad(h, (0, Dp - D)), F.pad(table, (0, Dp - D))
    return (N, Dp, V, _build.aligned(h), _build.aligned(table),
            targets.to(dtype=torch.int32).contiguous(), valid.to(dtype=torch.int32).contiguous())


def _padded_d(h) -> int:
    """D as the kernels take it: a multiple of 16 in bf16 (the module
    docstring's one width rule), unchanged in fp32."""
    D = h.shape[1]
    return -(-D // 16) * 16 if h.dtype == torch.bfloat16 else D


def de_splits(N: int, V: int, sms: int) -> tuple[int, int]:
    """(splits, rows a split) of the dE kernel's rows: its ceil(V / 64)
    vocab tiles times the splits fit two waves of two CTAs on each of `sms`
    SMs (no third, nearly empty wave trails the two), each split whole
    64-row tiles and, where there are enough rows, at least 256.
    On 132 SMs at the flagship N 32,256 and V 1041: 30 splits of 1088 rows,
    510 CTAs."""
    return _build.split_rows(N, math.ceil(V / VC), sms, TM)


_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                              ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch_fwd(h, table, targets, valid, inv_t):
    N, D, V, h, table, targets, valid = _check(h, table, targets, valid)
    nll = torch.empty(N, dtype=torch.float32, device=h.device)
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        _build.launch("fused_ce_fwd", _FWD_ARGTYPES, h.data_ptr(), table.data_ptr(),
                      targets.data_ptr(), valid.data_ptr(), nll.data_ptr(), lse.data_ptr(),
                      N, D, V, float(inv_t), _build.dtype_code(h), _build.stream_of(h))
    trace.count("launch.j")
    return nll, lse


def fused_ce_rows_bwd(h, table, targets, valid, lse, g, inv_t: float):
    """Kernel k: (dh, dtable) of the nll of `fused_ce_rows` for its incoming
    gradient g [N] and saved lse [N] (CUDA tensors only)."""
    if h.device.type != "cuda":
        raise ValueError(f"fused_ce_rows_bwd launches a CUDA kernel; got {h.device}")
    D_real = h.shape[1]
    N, D, V, h, table, targets, valid = _check(h, table, targets, valid)
    # the dE half splits the rows so that its vocab tiles fill the card
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    nsplit, rows = de_splits(N, V, sms)
    per_split = rows // TM
    ws = torch.empty(nsplit * V * D, dtype=torch.float32, device=h.device)
    dh, de = torch.empty_like(h), torch.empty_like(table)
    lse, g = lse.float().contiguous(), g.float().contiguous()
    with torch.cuda.device(h.device):
        _build.launch("fused_ce_bwd", _BWD_ARGTYPES, h.data_ptr(), table.data_ptr(),
                      targets.data_ptr(), valid.data_ptr(), lse.data_ptr(), g.data_ptr(),
                      dh.data_ptr(), de.data_ptr(), ws.data_ptr(), N, D, V, float(inv_t),
                      nsplit, per_split, _build.dtype_code(h), _build.stream_of(h))
    trace.count("launch.k")
    if D != D_real:
        dh, de = dh[:, :D_real], de[:, :D_real]
    return dh, de


def fused_ce_rows_bwd_plain(h, table, targets, valid, g, inv_t: float):
    """Plain version of kernel k: autograd through the plain forward."""
    with torch.enable_grad():
        h, table = (t.detach().requires_grad_(True) for t in (h, table))
        nll, _ = fused_ce_rows_plain(h, table, targets, valid, inv_t)
        return torch.autograd.grad(nll, (h, table), g)


def fused_ce_rows_bwd_lse_plain(h, table, targets, valid, lse, g, inv_t: float):
    """Plain version of kernel k as the kernel takes it, with the lse given:
    dlog = (exp(logit - lse) - onehot) * g * inv_t on valid rows, dh = dlog . E,
    dE = dlog^T . h, in fp32 (a target outside [0, V) matches nothing)."""
    logits = (h.float() @ table.float().T) * inv_t
    cols = torch.arange(table.shape[0], device=h.device)
    onehot = (cols[None, :] == targets.long()[:, None]).float()
    scale = torch.where(valid == 1, g.float() * inv_t, 0.0)
    dlog = (torch.exp(logits - lse.float()[:, None]) - onehot) * scale[:, None]
    return (dlog @ table.float()).to(h.dtype), (dlog.T @ h.float()).to(table.dtype)


def ce_rows_fwd(h, table, targets, valid, inv_t: float):
    """(nll, lse) of `fused_ce_rows` outside autograd: kernel j for CUDA
    tensors, the plain version for CPU tensors."""
    if h.device.type == "cpu":
        with torch.no_grad():
            return fused_ce_rows_plain(h, table, targets, valid, inv_t)
    return _launch_fwd(h, table, targets, valid, inv_t)


def ce_rows_bwd(h, table, targets, valid, lse, g, inv_t: float):
    """(dh, dtable) for the given lse: kernel k for CUDA tensors, its plain
    version for CPU tensors."""
    if h.device.type == "cpu":
        return fused_ce_rows_bwd_lse_plain(h, table, targets, valid, lse, g, inv_t)
    return fused_ce_rows_bwd(h, table, targets, valid, lse, g, inv_t)


class _FusedCE(torch.autograd.Function):
    """Kernel j forward, kernel k backward (the gradient flows from nll)."""

    @staticmethod
    def forward(ctx, h, table, targets, valid, inv_t):
        nll, lse = _launch_fwd(h, table, targets, valid, inv_t)
        ctx.save_for_backward(h, table, targets, valid, lse)
        ctx.inv_t = inv_t
        ctx.mark_non_differentiable(lse)
        return nll, lse

    @staticmethod
    def backward(ctx, g, _glse):
        h, table, targets, valid, lse = ctx.saved_tensors
        dh, de = fused_ce_rows_bwd(h, table, targets, valid, lse, g, ctx.inv_t)
        return dh, de, None, None, None


def fused_ce_rows(h, table, targets, valid, inv_t: float):
    """h [N, D], table [V, D], targets/valid [N] int -> (nll [N], lse [N]) fp32;
    nll is differentiable in h and table."""
    if h.device.type == "cpu":
        return fused_ce_rows_plain(h, table, targets, valid, inv_t)
    if h.device.type != "cuda":
        raise ValueError(f"fused_ce_rows runs on cuda or cpu, not {h.device}")
    if torch.is_grad_enabled() and (h.requires_grad or table.requires_grad):
        return _FusedCE.apply(h, table, targets, valid, inv_t)
    return _launch_fwd(h, table, targets, valid, inv_t)
