"""Checkpoint save/restore.

The port's counterpart of `gamer_tpu/core/checkpoint.py`, which writes orbax
PyTree checkpoints. Here a tag ("best", "last", "last_state", "epoch_<N>")
is a directory `<dir>/<tag>/` holding `state.pt`: a `torch.save` of a tree of
dicts of tensors (moved to the CPU) and plain numbers, loaded back with
`weights_only=True`, so values round-trip bit for bit. Beside it
`<dir>/<tag>.meta.json` holds the step/metric metadata, as in the JAX
package. Only process 0 writes; under a process group every process then
waits at a barrier, so none reads a checkpoint before it is whole.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from gamer_tpu_torch.core import distributed
from gamer_tpu_torch.core.logging import get_logger, process_index

logger = get_logger("checkpoint")

_STATE = "state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def save(self, tag: str, tree: Any, metadata: dict | None = None) -> None:
        if process_index() == 0:
            self._write(tag, tree, metadata)
        distributed.barrier()

    def _write(self, tag: str, tree: Any, metadata: dict | None) -> None:
        path = self._path(tag)
        tmp = f"{path}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_to_cpu(tree), os.path.join(tmp, _STATE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)  # a reader never sees half a checkpoint
        if metadata is not None:
            with open(path + ".meta.json", "w") as f:
                json.dump(metadata, f, indent=2, default=str)
        logger.info("Saved checkpoint %s", path)

    def restore(self, tag: str, map_location: str | torch.device | None = "cpu") -> Any:
        return torch.load(os.path.join(self._path(tag), _STATE), map_location=map_location,
                          weights_only=True)

    def metadata(self, tag: str) -> dict | None:
        p = self._path(tag) + ".meta.json"
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def exists(self, tag: str) -> bool:
        return os.path.exists(os.path.join(self._path(tag), _STATE))
