"""CUDA graphs of device functions, captured once per key and replayed.

The port's counterpart of `jax.jit`'s cache of compiled executables: a
device function (one that reads its inputs from static device buffers, reads
no device value into Python and changes no host state) is captured once per
key (the shapes and dtypes of its inputs, and whatever else changes the
launches it makes) and every later call with that key replays the graph.
PyTorch's whole-network capture recipe: the first call of a key runs the
function eagerly on a side stream (the warm-up, and the real call: its
outputs are returned), then `torch.cuda.graph` records it. A replay's
outputs live in the graph's memory, which the next replay overwrites, so
they are cloned out before they are returned. The graphs of one
`GraphCache` share one memory pool; each owner (a `Trainer`'s training
step, its eval step, a search object) has its own cache and so its own
pool. A capture that fails raises.

`GraphCache.captured` counts captures by cache name across the process,
as the kernel wrappers count their launches.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Hashable

import torch

from gamer_tpu_torch.core import distributed

logger = logging.getLogger("gamer_tpu_torch.graphs")


def capture_enabled(graphed: bool, device) -> bool:
    """Whether an owner's device parts are captured: `graphed`, on the card,
    and without a process group (whose collectives run eagerly)."""
    return graphed and torch.device(device).type == "cuda" and not distributed.is_initialized()


class GraphCache:
    """CUDA graphs of one owner's device functions, by key, in one pool."""

    captured: dict[str, int] = {}  # captures made in this process, by cache name

    def __init__(self, device, name: str):
        self.device = torch.device(device)
        self.name = name
        self._graphs: dict[Hashable, tuple] = {}
        self._pool = None
        self._side = None

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, fn: Callable[[], Any],
            hold: Callable[[], Any] | None = None) -> Any:
        """`fn()` through the CUDA graph of `key`: replayed when captured
        (its outputs cloned out of the graph's memory), else run eagerly on a
        side stream and then captured. `hold()`, called after the capture,
        gives what the graph reads and must outlive it (kept with it)."""
        entry = self._graphs.get(key)
        if entry is not None:
            entry[0].replay()
            return _clone(entry[1])
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = fn()
        current.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            graph_out = fn()
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[key] = (graph, graph_out, hold() if hold is not None else None)
        GraphCache.captured[self.name] = GraphCache.captured.get(self.name, 0) + 1
        logger.info("captured the %s's CUDA graph %d (%s)", self.name, len(self._graphs), key)
        return out


def _clone(tree):
    """Tensors of a (nested tuple, list or dict) output, cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree
