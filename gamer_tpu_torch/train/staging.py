"""Host-to-device copies of per-step values into static device buffers.

A captured training step (`train/loop.Trainer`) reads its batch, its dropout
seeds and its scalars from device buffers whose addresses never change; the
host rewrites them before each replay. `Staging` does that without waiting
for the card: each value is written into a pinned host buffer and copied
with a non-blocking copy on the current stream, so the copy runs in stream
order before the next replay. The pinned buffers are double-buffered behind
CUDA events: before the host overwrites a buffer it waits for the copy that
last read it, so it never overwrites one whose copy has not run. On the CPU
the values are copied in directly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


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
