"""Residual-stream dropout by a stateless hash.

PyTorch counterpart of the "hash" implementation of
`gamer_tpu/modules/dropout.py` (`_hash_keep_mask`, `_hash_dropout`): the keep
mask is fmix32 of (flat element index * M3 + seed) in uint32, kept when
>= the 32-bit threshold of `keep_threshold`, and the kept values are scaled
by 1/keep_prob. The mask is a pure function of (seed, index), so the backward
regenerates it from the seed instead of saving it, and a remat recompute
draws it again exactly. The arithmetic runs in int64 holding uint32
(`ops/fused_attention.fmix32`), bit-exact with JAX; it is plain elementwise
PyTorch, as in JAX it lies outside every Pallas kernel.

The port uses this hash on every residual and plain-path dropout site, where
the JAX package's "bits" impl draws from its rng stream (which torch cannot
reproduce).

Under a process group each process holds a slice of the global batch, and
JAX hashes the global batch's coordinates. Every hash of the port is linear
in its coordinates before fmix32, so `row_seed` moves a process's seed by
its first global row: the local coordinates then draw the global mask
(`row0` of `hash_dropout`, the attention and MoE call sites).
"""

from __future__ import annotations

import torch

from gamer_tpu_torch.ops.fused_attention import (
    _M2, _M3, _U32, _mul32, drop_threshold, fmix32, keep_fraction)


def row_seed(seed: int, row0: int, row_stride: int, mult: int = _M3) -> int:
    """The seed under which a hash keyed on local coordinates draws the mask
    of the global batch, for rows that start at global row `row0`: a hash of
    `coord * mult + seed` whose coordinate advances `row_stride` a batch row
    (the residual's flat index: S * D; attention's b * H + h: H, with
    `mult` M2; the MoE's row t = b * n + block: n) sees
    `local * mult + (row0 * row_stride * mult + seed)`, mod 2^32."""
    return (int(seed) + row0 * row_stride * mult) & _U32


def attention_row_seed(seed: int, row0: int, num_heads: int) -> int:
    """`row_seed` of an attention-probability mask, whose hash row is
    b * num_heads + h (times M2)."""
    return row_seed(seed, row0, num_heads, _M2) if row0 else seed


def keep_threshold(rate: float) -> tuple[int, float]:
    """The 32-bit drop threshold (drop when the hash < it) and the exact keep
    probability; any rate < 1 keeps a nonzero keep probability."""
    return drop_threshold(rate), keep_fraction(rate)


def _hash_keep_mask(seed: int, shape, threshold: int, device=None) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x = (_mul32(idx, _M3) + (int(seed) & _U32)) & _U32
    return (fmix32(x) >= threshold).reshape(shape)


def _apply_mask(x: torch.Tensor, seed: int, threshold: int, keep_prob: float) -> torch.Tensor:
    keep = _hash_keep_mask(seed, x.shape, threshold, x.device)
    scale = torch.tensor(1.0 / keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


class _HashDropout(torch.autograd.Function):
    """Saves only the seed; the backward regenerates the mask."""

    @staticmethod
    def forward(ctx, x, seed, threshold, keep_prob):
        ctx.args = (seed, threshold, keep_prob)
        return _apply_mask(x, seed, threshold, keep_prob)

    @staticmethod
    def backward(ctx, g):
        return _apply_mask(g, *ctx.args), None, None, None


def hash_dropout(x: torch.Tensor, seed: int, rate: float, row0: int = 0) -> torch.Tensor:
    """Inverted dropout of `x` by the hash keyed on `seed`; `x`'s rows
    (dim 0) are rows `row0`, `row0 + 1`, ... of the global batch."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    threshold, keep_prob = keep_threshold(rate)
    if row0:
        seed = row_seed(seed, row0, x.numel() // x.shape[0])
    return _HashDropout.apply(x, int(seed), threshold, keep_prob)
