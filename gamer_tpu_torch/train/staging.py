"""Host-to-device copies of per-step values into static device buffers.

A captured training step (`train/loop.Trainer`) reads its batch, its dropout
seeds and its scalars from device buffers whose addresses never change; the
host rewrites them before each replay. `Staging` does that without waiting
for the card: each value is written into a pinned host buffer and copied
with a non-blocking copy on the current stream, so the copy runs in stream
order before the next replay. The pinned buffers are double-buffered behind
CUDA events: before the host overwrites a buffer it waits for the copy that
last read it, so it never overwrites one whose copy has not run. On the CPU
the values are copied in directly. `StaticInputs` keeps one set of such
buffers a key (the names, shapes and dtypes of a call's arrays), as
`jax.jit` keeps one executable a key.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from gamer_tpu_torch.core import trace


class Staging:
    """Writes values into the device tensors `dst` ({name: tensor})."""

    def __init__(self, dst: Mapping[str, torch.Tensor]):
        self.dst = dict(dst)
        self.cuda = next(iter(self.dst.values())).device.type == "cuda"
        self._turn = 0
        self._pinned, self._events = [], [None, None]
        if self.cuda:
            self._pinned = [{k: torch.empty(t.shape, dtype=t.dtype).pin_memory()
                             for k, t in self.dst.items()} for _ in range(2)]

    def write(self, values: Mapping[str, object]) -> None:
        """Copy each of `values` (numpy arrays, tensors or numbers, of its
        buffer's shape) into its device buffer; returns before the copies
        run. A value already on the card is copied device to device."""
        srcs = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v)))
                .reshape(self.dst[k].shape) for k, v in values.items()}
        if not self.cuda:
            for k, src in srcs.items():
                self.dst[k].copy_(src)
            return
        slot, self._turn = self._turn, self._turn ^ 1
        if self._events[slot] is not None:
            with trace.span("stage.wait"):
                self._events[slot].synchronize()  # the copy that last read this slot has run
        pinned = self._pinned[slot]
        for k, src in srcs.items():
            if src.is_cuda:
                self.dst[k].copy_(src)
            else:
                pinned[k].copy_(src)
                self.dst[k].copy_(pinned[k], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._events[slot] = event


class StaticInputs:
    """Static device buffers on `device`, one set a key, each written
    through its `Staging`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._by_key: dict[tuple, tuple[dict, Staging]] = {}

    def write(self, arrays: Mapping[str, object]) -> Tuple[tuple, dict]:
        """Stage `arrays` ({name: numpy array or tensor}) into the buffers of
        their key; returns (the key, {name: static device tensor})."""
        key = tuple((n, tuple(v.shape), dtype_of(v)) for n, v in arrays.items())
        if key not in self._by_key:
            static = {n: torch.empty(shape, dtype=dtype, device=self.device)
                      for n, shape, dtype in key}
            self._by_key[key] = (static, Staging(static))
        static, staging = self._by_key[key]
        staging.write(arrays)
        return key, static


def as_array(v):
    """A tensor as it is, anything else as a numpy array."""
    return v if isinstance(v, torch.Tensor) else np.asarray(v)


def dtype_of(v) -> torch.dtype:
    """The torch dtype of a tensor or numpy array."""
    return v.dtype if isinstance(v, torch.Tensor) else torch.from_numpy(np.empty(0, v.dtype)).dtype
