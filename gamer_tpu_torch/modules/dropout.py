"""Residual-stream dropout by a stateless hash.

PyTorch counterpart of the "hash" implementation of
`gamer_tpu/modules/dropout.py` (`_hash_keep_mask`, `_hash_dropout`): the keep
mask is fmix32 of (flat element index * M3 + seed) in uint32, kept when
>= the 32-bit threshold of `keep_threshold`, and the kept values are scaled
by 1/keep_prob. The mask is a pure function of (seed, index), so the backward
regenerates it from the seed instead of saving it, and a remat recompute
draws it again exactly. `hash_dropout_add(r, y, ...)` is `r + hash_dropout(y,
...)` in one pass, the form of every residual site. Both run through
`ops/hash_dropout.py`: on the card the CUDA kernel K1 (forward, fused with
the residual add, as XLA fuses it on the TPU) and K2 (backward); on the CPU
its plain version, bit-exact with JAX. Inputs are made contiguous here (the
mask is defined on the logical index, so the result is unchanged).

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

from gamer_tpu_torch.ops import hash_dropout as HD
from gamer_tpu_torch.ops import seeds as SD
from gamer_tpu_torch.ops.fused_attention import _M2, _M3, _U32, drop_threshold, keep_fraction


def row_seed(seed, row0: int, row_stride: int, mult: int = _M3):
    """The seed under which a hash keyed on local coordinates draws the mask
    of the global batch, for rows that start at global row `row0`: a hash of
    `coord * mult + seed` whose coordinate advances `row_stride` a batch row
    (the residual's flat index: S * D; attention's b * H + h: H, with
    `mult` M2; the MoE's row t = b * n + block: n) sees
    `local * mult + (row0 * row_stride * mult + seed)`, mod 2^32. A seed
    in device memory (`ops/seeds.DeviceSeed`) keeps its table entry and
    carries the offset in its add."""
    return SD.shift(seed, (row0 * row_stride * mult) & _U32)


def attention_row_seed(seed, row0: int, num_heads: int):
    """`row_seed` of an attention-probability mask, whose hash row is
    b * num_heads + h (times M2)."""
    return row_seed(seed, row0, num_heads, _M2) if row0 else seed


def keep_threshold(rate: float) -> tuple[int, float]:
    """The 32-bit drop threshold (drop when the hash < it) and the exact keep
    probability; any rate < 1 keeps a nonzero keep probability."""
    return drop_threshold(rate), keep_fraction(rate)


def hash_dropout(x: torch.Tensor, seed, rate: float, row0: int = 0) -> torch.Tensor:
    """Inverted dropout of `x` by the hash keyed on `seed`; `x`'s rows
    (dim 0) are rows `row0`, `row0 + 1`, ... of the global batch."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    threshold, keep_prob = keep_threshold(rate)
    if row0:
        seed = row_seed(seed, row0, x.numel() // x.shape[0])
    return HD.hash_dropout(x.contiguous(), seed, threshold, keep_prob)


def hash_dropout_add(r: torch.Tensor, y: torch.Tensor, seed, rate: float,
                     row0: int = 0) -> torch.Tensor:
    """`r + hash_dropout(y, seed, rate, row0)` in one pass (K1 with its
    residual on the card); r and y have one shape."""
    if rate == 0.0:
        return r + y
    if rate == 1.0:
        return r + torch.zeros_like(y)
    threshold, keep_prob = keep_threshold(rate)
    if row0:
        seed = row_seed(seed, row0, y.numel() // y.shape[0])
    return HD.hash_dropout(y.contiguous(), seed, threshold, keep_prob,
                           residual=r.contiguous())
