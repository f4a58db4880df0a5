"""The optimizer update over every parameter tensor at once: kernel L.

The counterpart of XLA's fusion of the optax chain of
`gamer_tpu/train/state.py:90-95` (`clip_by_global_norm`, then the family's
update) inside the jitted train step, which has no `pallas_call`.
`csrc/fused_optimizer.cu` walks a device table of per-tensor records
(`RecordTable`): L1 (`global_norm_sq`) sums g^2 in fp64 into a replicated
and a model-axis total, deterministically; L2 (`apply_update`) clips (a
per-element select on the norm, never a host branch) and applies the
family's rule to p and its moments in place, reading the learning rate and
the bias corrections from a device scalar buffer. Nothing is read back to
the host, so a captured training step replays L as it is
(`train/loop.Trainer`).

The plain version is `train/state.plain_update`, the per-tensor PyTorch
code; `train/state.Optimizer` takes it for CPU tensors and L for CUDA
tensors. Both wrappers raise for a tensor that is not on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build

CHUNK = 16384  # elements a CTA (csrc/fused_optimizer.cu kChunk)
FAMILIES = {"adamw": 0, "adam": 1, "fallback_adam": 1, "sgd": 2, "adagrad": 3, "rmsprop": 4}
SHARDED, DECAYED = 1, 2  # record flags

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 7 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


class RecordTable:
    """The device record table of one set of tensors: for each, its
    parameter, grad and the family's two moments (None where it keeps no
    such moment) and its flags, cut into chunks of `CHUNK` elements; with
    the fp64 scratch of L1 (partial sums a chunk) and its two totals. It
    holds the parameters and moments it points to; the grads it does not
    (they are new tensors each step), so its owner uses it only with grads
    at the addresses it was built for (`train/state.Optimizer` keys its
    tables by them)."""

    def __init__(self, params, grads, ms, vs, flags, device: torch.device):
        params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
        self.kept = (params, ms, vs)  # held: the table points into them
        n_rec = len(params)
        words = np.zeros(8 * n_rec, np.int64)
        chunks = []
        for r, (p, g, m, v, f) in enumerate(zip(params, grads, ms, vs, flags)):
            for t in (p, g, m, v):
                if t is None:
                    continue
                if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                    raise ValueError(f"kernel L takes contiguous float32 tensors on {device}, not "
                                     f"{t.dtype} on {t.device}")
                if t.shape != p.shape:
                    raise ValueError(f"record {r}: shapes {tuple(t.shape)} and {tuple(p.shape)}")
            words[8 * r:8 * r + 7] = (p.data_ptr(), g.data_ptr(),
                                      m.data_ptr() if m is not None else 0,
                                      v.data_ptr() if v is not None else 0,
                                      p.numel(), int(f), len(chunks))
            chunks += [r] * -(-p.numel() // CHUNK)
        if not chunks:
            raise ValueError("kernel L needs at least one nonempty tensor")
        self.n_rec, self.n_chunks = n_rec, len(chunks)
        host = torch.from_numpy(np.concatenate([words, np.asarray(chunks, np.int64)]))
        self._host = host.pin_memory()  # kept: the copy reads it asynchronously
        self.table = torch.empty(host.shape, dtype=torch.int64, device=device)
        self.table.copy_(self._host, non_blocking=True)
        self.partials = torch.empty(2 * self.n_chunks, dtype=torch.float64, device=device)
        self.totals = torch.empty(2, dtype=torch.float64, device=device)


def _call(table: RecordTable, scalars, family: int, hyper: tuple, clip: int, phase: int):
    dev = table.table.device
    if dev.type != "cuda":
        raise ValueError(f"kernel L runs on cuda, not {dev}")
    with torch.cuda.device(dev):
        _build.launch("fused_optimizer", _ARGTYPES, table.table.data_ptr(), table.n_rec,
                      table.n_chunks, table.partials.data_ptr(), table.totals.data_ptr(),
                      scalars.data_ptr() if scalars is not None else None, family, *hyper,
                      clip, phase, torch.cuda.current_stream(dev).cuda_stream)


def global_norm_sq(table: RecordTable) -> torch.Tensor:
    """L1: `table.totals` = (sum of g^2 over the replicated tensors, over
    the tensors split on a model axis), fp64 on the card."""
    _call(table, None, 0, (0.0,) * 7, 0, 0)
    trace.count("launch.L1")
    return table.totals


def apply_update(table: RecordTable, scalars: torch.Tensor, optim: str, b1: float, b2: float,
                 eps: float, weight_decay: float, max_norm: float | None) -> None:
    """L2: clip by the global norm sqrt(sum of `table.totals`) when
    `max_norm` is set and positive, then the `optim` family's update of every
    record in place; `scalars` [lr, 1 - b1^t, 1 - b2^t, ...] fp32 on the card."""
    if scalars.dtype != torch.float32 or scalars.device != table.table.device:
        raise ValueError("the scalar buffer must be float32 on the table's device")
    clip = int(bool(max_norm) and max_norm > 0)
    # c1, c2 as the plain version's alpha: 1 - b in double, rounded to fp32
    hyper = (b1, b2, 1.0 - b1, 1.0 - b2, eps, weight_decay, max_norm if clip else 0.0)
    _call(table, scalars, FAMILIES[optim], hyper, clip, 1)
    trace.count("launch.L2")
