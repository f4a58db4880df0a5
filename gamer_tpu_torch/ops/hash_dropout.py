"""Residual hash dropout: kernel K1 (forward, fused with its residual add) and
K2 (backward).

The counterpart of `gamer_tpu/modules/dropout.py` `_hash_keep_mask` /
`_hash_dropout` (:119-146) and of the residual add that consumes it, which
XLA fuses into one pass on the TPU (no `pallas_call`). `hash_dropout(y, seed,
threshold, keep_prob, residual=r)` is r + where(keep, y * scale, 0), or the
plain dropout without `residual`; the keep mask is fmix32 of the element's
logical row-major flat index (times M3, plus the seed) in uint32, kept when
>= `threshold`. For CUDA tensors it launches `csrc/hash_dropout.cu` behind a
`torch.autograd.Function` that saves only (seed, threshold, keep_prob), the
seed an int or a seed in device memory (`ops/seeds.DeviceSeed`, read by the
kernels on the card): the backward regenerates the mask in K2, dy =
where(keep, g * scale, 0), the same kernel without a residual; the
residual's grad is g itself. For CPU tensors it runs the plain versions
`apply_mask` and `hash_dropout_add_plain`, bit-exact with JAX: the
arithmetic in int64 holding uint32 (`ops/fused_attention.fmix32`), the
scale rounded to y's dtype, y * scale rounded to it, then r added.

Both routes take only contiguous tensors of one shape, one dtype (the
port's call sites pass no mixed pair) and one device, with fewer than 2^32
elements, and raise otherwise, so a call site the kernel would refuse fails
on the CPU too. The kernel takes float32 and bfloat16; the plain version
also float64, for the CPU references of the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build, seeds
from gamer_tpu_torch.ops.fused_attention import _M3, _U32, _mul32, fmix32

MAX_NUMEL = 2 ** 32  # the kernel indexes elements in uint32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def hash_keep_mask(seed, shape, threshold: int, device=None) -> torch.Tensor:
    """Boolean keep mask of `shape`: fmix32(i * M3 + seed) >= threshold for
    the logical row-major flat index i; `seed` an int or a `DeviceSeed`."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x = (_mul32(idx, _M3) + seeds.hash_term(seed, device)) & _U32
    return (fmix32(x) >= threshold).reshape(shape)


def apply_mask(x: torch.Tensor, seed, threshold: int, keep_prob: float) -> torch.Tensor:
    """Plain version of K1 without a residual and of K2: where(keep, x *
    scale, 0), the scale rounded to x's dtype first."""
    keep = hash_keep_mask(seed, x.shape, threshold, x.device)
    scale = torch.full((), 1.0 / keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def hash_dropout_add_plain(y: torch.Tensor, seed, threshold: int, keep_prob: float,
                           residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K1: residual + apply_mask(y), or apply_mask(y)."""
    d = apply_mask(y, seed, threshold, keep_prob)
    return d if residual is None else residual + d


@functools.lru_cache(maxsize=None)
def _scale(keep_prob: float, dtype: torch.dtype) -> float:
    """1 / keep_prob rounded to `dtype`, as the plain version rounds it."""
    return float(torch.tensor(1.0 / keep_prob, dtype=dtype))


def _check(y: torch.Tensor, residual: torch.Tensor | None) -> None:
    # the plain version also serves the CPU's float64 references
    dtypes = KERNEL_DTYPES if y.device.type == "cuda" else KERNEL_DTYPES + (torch.float64,)
    if y.dtype not in dtypes:
        raise TypeError(f"the hash dropout takes {dtypes} on {y.device.type}, not {y.dtype}")
    if not y.is_contiguous() or (residual is not None and not residual.is_contiguous()):
        raise ValueError("the hash dropout kernel takes contiguous tensors")
    if residual is not None and residual.dtype != y.dtype:
        raise TypeError(f"the hash dropout kernel takes y and its residual in one dtype, not "
                        f"{y.dtype} and {residual.dtype}")
    if residual is not None and (residual.shape != y.shape or residual.device != y.device):
        raise ValueError(f"residual {tuple(residual.shape)} on {residual.device} does not match "
                         f"y {tuple(y.shape)} on {y.device}")
    if y.numel() >= MAX_NUMEL:
        raise ValueError(f"the hash dropout kernel takes fewer than 2^32 elements, not {y.numel()}")


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_uint, ctypes.c_void_p] + [ctypes.c_uint] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _launch(y, seed, threshold, keep_prob, residual=None) -> torch.Tensor:
    if y.device.type != "cuda":
        raise ValueError(f"the hash dropout kernel runs on cuda, not {y.device}")
    out = torch.empty_like(y)
    if y.numel():
        with torch.cuda.device(y.device):
            _build.launch("hash_dropout", _ARGTYPES, y.data_ptr(),
                          None if residual is None else residual.data_ptr(), out.data_ptr(),
                          y.numel(), *seeds.kernel_args(seed, y.device), int(threshold),
                          _scale(keep_prob, y.dtype),
                          _build.dtype_code(y), _build.stream_of(y))
    return out


def hash_dropout_fwd(y: torch.Tensor, seed, threshold: int, keep_prob: float,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """K1 outside autograd: residual + dropout(y) (or dropout(y)); the plain
    version for CPU tensors."""
    _check(y, residual)
    if y.device.type == "cpu":
        return hash_dropout_add_plain(y, seed, threshold, keep_prob, residual)
    out = _launch(y, seed, threshold, keep_prob, residual)
    if y.numel():  # an empty tensor launches nothing
        trace.count("launch.K1")
    return out


def hash_dropout_bwd(g: torch.Tensor, seed, threshold: int, keep_prob: float) -> torch.Tensor:
    """K2: where(keep, g * scale, 0) of the incoming grad g (in y's dtype);
    the plain version for CPU tensors."""
    _check(g, None)
    if g.device.type == "cpu":
        return apply_mask(g, seed, threshold, keep_prob)
    out = _launch(g, seed, threshold, keep_prob)
    if g.numel():
        trace.count("launch.K2")
    return out


class _HashDropout(torch.autograd.Function):
    """K1 forward, K2 backward; saves only the seed (an int, or a
    `DeviceSeed`: the table and the add), threshold and keep probability.
    The residual's grad is g itself."""

    @staticmethod
    def forward(ctx, y, residual, seed, threshold, keep_prob):
        ctx.args = (seed, threshold, keep_prob)
        return hash_dropout_fwd(y, seed, threshold, keep_prob, residual)

    @staticmethod
    def backward(ctx, g):
        dy = hash_dropout_bwd(g.contiguous(), *ctx.args) if ctx.needs_input_grad[0] else None
        return dy, g if ctx.needs_input_grad[1] else None, None, None, None


def hash_dropout(y: torch.Tensor, seed, threshold: int, keep_prob: float,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """residual + where(keep, y * scale, 0), or the dropout alone without
    `residual`; differentiable in y and the residual."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_dropout runs on cuda or cpu, not {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or
                                    (residual is not None and residual.requires_grad)):
        return _HashDropout.apply(y, residual, seed, threshold, keep_prob)
    return hash_dropout_fwd(y, seed, threshold, keep_prob, residual)
