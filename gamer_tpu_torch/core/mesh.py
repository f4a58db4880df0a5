"""The process-level mesh of the port.

The port's counterpart of `gamer_tpu/core/mesh.py`. The JAX package builds
one (data, model) device mesh and lets XLA insert the collectives. Here one
process owns one card, so the data axis is the process group
(`core/distributed.py`): `n_data` is its size, each process feeds its own
rows, and `train/loop.Trainer` sums the gradients. The model axis (expert,
vocab and codebook tables sharded by `ShardingRules`) is not ported: a
model axis above 1 raises (ROADMAP §1.10, model-axis sharding).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gamer_tpu_torch.core import distributed
from gamer_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class MeshContext:
    """This process's place on the (data, model) mesh and its device."""

    def __init__(self, n_model: int = 1, device: str | torch.device | None = None):
        if n_model != 1:
            raise NotImplementedError(
                f"model axis {n_model}: the port shards only the data axis (model-axis "
                "sharding of experts and tables is ROADMAP §1.10)")
        self.device = resolve_device(device)

    @property
    def n_data(self) -> int:
        return distributed.process_count()

    @property
    def n_model(self) -> int:
        return 1

    def shard_batch(self, batch: Any) -> Any:
        """This process's batch (its rows of the global batch, see
        `distributed.shard_examples`) as tensors on its device."""
        if isinstance(batch, dict):
            return {k: self.shard_batch(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self.shard_batch(v) for v in batch)
        return torch.as_tensor(np.asarray(batch) if not isinstance(batch, torch.Tensor)
                               else batch, device=self.device)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round n up to a multiple (vocab/table padding for clean sharding)."""
    return ((n + multiple - 1) // multiple) * multiple


def local_batch_size(global_batch: int, ctx: MeshContext) -> int:
    if global_batch % ctx.n_data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {ctx.n_data}")
    return global_batch // ctx.n_data
