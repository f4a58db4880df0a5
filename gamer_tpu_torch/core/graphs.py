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

Each owner's captures, replays and eager runs are counted by its cache
name in the counters of `core/trace.py` (`graph.capture.<name>`,
`graph.replay.<name>`, `graph.eager.<name>`), beside the kernel wrappers'
launches. Every key also holds `trace.marking()`: a graph with device marks
is a capture of its own, and a graph without them is the same graph a run
without tracing captures; a marked graph's marks are read at its replays
(`trace.replay`).

`StagedGraphs` pairs a cache with the static input buffers of
`train/staging.StaticInputs`: the host part of a call stages its arrays into
the buffers of their key, and the device part, a function of those buffers,
runs through the graph of that key. The zoo's training step and scorer and
the RQ-VAE's training step, emit and reclustering are each one.

Which owners capture (`capture_enabled`): on the card, `graphed`, unless the
device part holds a collective that a graph cannot hold. An owner states the
group its device part reduces over, if any: a `Trainer`'s step reduces over
its data group; the eval step, the searches, the zoo's and the RQ-VAE's
device parts reduce over nothing (their sums over a group, where they have
any, run on the host side of the call). An NCCL collective is launched on
the capturing stream and is captured with the rest; a gloo collective stages
the card's tensors through the host, so a device part that reduces over a
gloo group runs eagerly. Under a live model axis (`core/mesh.py`) every
forward holds the model group's collectives (`distributed.model_all_reduce`,
which gloo stages through the host): the owners of such a model run
eagerly.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Hashable

import torch

from gamer_tpu_torch.core import distributed, trace
from gamer_tpu_torch.train.staging import StaticInputs

logger = logging.getLogger("gamer_tpu_torch.graphs")


def capture_enabled(graphed: bool, device, reduces: bool = False, group=None,
                    model_axis=None) -> bool:
    """Whether an owner's device parts are captured: `graphed`, on the card,
    without a live `model_axis` (`distributed.ModelAxis`), and, where the
    device part reduces over `group` (`reduces`; None is the world) under a
    process group, only if that group's backend is NCCL."""
    if not graphed or torch.device(device).type != "cuda":
        return False
    if model_axis is not None and model_axis.live:
        return False
    return not (reduces and distributed.is_initialized()) or distributed.backend(group) == "nccl"


def model_axis_of(model):
    """The `distributed.ModelAxis` of a model sharded by a `core/mesh.MeshContext`, else None."""
    ctx = getattr(model, "mesh_ctx", None)
    return ctx.model_axis if ctx is not None else None


class GraphCache:
    """CUDA graphs of one owner's device functions, by key, in one pool."""

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
        gives what the graph reads and must outlive it (kept with it). The
        key is taken with `trace.marking()`."""
        key = (key, trace.marking())
        entry = self._graphs.get(key)
        if entry is not None:
            trace.count("graph.replay." + self.name)
            trace.replay(entry[0], entry[3])
            return _clone(entry[1])
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = fn()
        current.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        trace.begin_capture()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                graph_out = fn()
        finally:
            marks = trace.end_capture()
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[key] = (graph, graph_out, hold() if hold is not None else None, marks)
        trace.count("graph.capture." + self.name)
        logger.info("captured the %s's CUDA graph %d (%s)", self.name, len(self._graphs), key)
        return out


class StagedGraphs:
    """A device function on staged inputs, captured once per input key.

    `stage(arrays)` is the host part: it writes a call's arrays (numpy
    arrays or CPU tensors, by name) into static device buffers, one set a
    key (their names, shapes and dtypes), through pinned memory without
    waiting for the card. `run(key, fn, static)` is the device part: `fn`
    of those buffers, which reads no device value into Python and makes no
    tensor from host data, through the CUDA graph of `key` where
    `capture_enabled` (of `graphed`, the device, the group the device part
    reduces over if `reduces`, and the model's `model_axis`), else eagerly
    (`graphed=False`, the CPU, a gloo group it reduces over, a live model
    axis)."""

    def __init__(self, device, name: str, graphed: bool = True, reduces: bool = False,
                 group=None, model_axis=None):
        self.device = torch.device(device)
        self.graphed = graphed
        self.reduces, self.group, self.model_axis = reduces, group, model_axis
        self._inputs = StaticInputs(self.device)
        self._graphs = GraphCache(self.device, name)

    @property
    def captures(self) -> bool:
        return capture_enabled(self.graphed, self.device, self.reduces, self.group,
                               self.model_axis)

    @property
    def graphs(self) -> int:
        """CUDA graphs captured: one per key (a marked one is a key of its own)."""
        return len(self._graphs)

    def stage(self, arrays) -> tuple[tuple, dict]:
        """(the key, {name: static device buffer}) of `arrays`, staged."""
        return self._inputs.write(arrays)

    def run(self, key: Hashable, fn: Callable[[dict], Any], static: dict,
            hold: Callable[[], Any] | None = None) -> Any:
        """`fn(static)`, replayed or captured under `key` (`GraphCache.run`,
        whose `hold` it takes) when captures are on, else run eagerly."""
        if self.captures:
            return self._graphs.run(key, lambda: fn(static), hold)
        trace.count("graph.eager." + self._graphs.name)
        return fn(static)


def _clone(tree):
    """Tensors of a (nested tuple, list or dict) output, cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree
