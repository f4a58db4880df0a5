"""The process-level mesh of the port and its sharding rules.

The port's counterpart of `gamer_tpu/core/mesh.py`. The JAX package builds
one (data, model) device mesh and lets XLA insert the collectives. Here one
process owns one card, and the processes of the group (`core/distributed.py`)
form the mesh: rank r sits at (data r // n_model, model r % n_model), the
layout of JAX's `np.asarray(devices).reshape(data, model)`.

- data axis: each data index feeds its own rows of the global batch, and
  `train/loop.Trainer` sums the gradients over the data group (the ranks of
  one model index);
- model axis: the parameters that `ShardingRules` name are split on it
  (the stacked MoE experts by expert, the vocab, item and codebook tables by
  rows), each rank keeping its block (`shard_params`). The sharded modules
  run their block and combine over the model group (the ranks of one data
  index) with `distributed.ModelAxis`: the expert-parallel MoE
  (`modules/moe.py`), the vocab-parallel lookup, CE and logits
  (`models/generative/qwen_family.py`, `modules/losses.py`). Only the Qwen
  family runs sharded; `shard_params` raises for another model.

A spec is a tuple of axis names or None, one a dimension, as JAX's
`PartitionSpec`; `()` replicates.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gamer_tpu_torch.convert import flax_path
from gamer_tpu_torch.core import distributed
from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.core.logging import get_logger

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class ProcessMesh:
    """A (data, model) grid of process ranks."""

    data: int
    model: int

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def coords(self, rank: int) -> tuple[int, int]:
        """(data index, model index) of `rank`."""
        return rank // self.model, rank % self.model

    def data_ranks(self, model_index: int) -> list[int]:
        """The ranks that hold model shard `model_index` (a data group)."""
        return [d * self.model + model_index for d in range(self.data)]

    def model_ranks(self, data_index: int) -> list[int]:
        """The ranks of data index `data_index` (a model group)."""
        return [data_index * self.model + m for m in range(self.model)]


def default_mesh(data: int | None = None, model: int = 1,
                 processes: int | None = None) -> ProcessMesh:
    """A (data, model) mesh over the process group's ranks (`processes`,
    default the group's size). With `data=None` the data axis takes every
    process the model axis leaves; one process is a 1 x 1 mesh."""
    n = distributed.process_count() if processes is None else processes
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} processes not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    return ProcessMesh(data, model)


@dataclass
class ShardingRules:
    """Regex-on-parameter-path -> spec rules, on the flax path of each port
    parameter (`convert.flax_path`, e.g. "layers_0/mlp/experts_gate"); the
    first match wins, unmatched parameters are replicated."""

    rules: Sequence[tuple[str, tuple]] = field(default_factory=list)

    def spec_for(self, path: str) -> tuple:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return spec
        return ()


# the JAX package's rules, letter for letter
DEFAULT_RULES = ShardingRules(
    rules=[
        # stacked MoE expert weights [E, d_in, d_ff] (modules/moe.py) -> EP
        (r"experts_(gate|up|down|wi|wo)$", (MODEL_AXIS,)),
        # vocab / item / codebook tables -> row-sharded
        (r"(embed_tokens|item_embedding|shared|item_m|item_c)/(emb/)?embedding$", (MODEL_AXIS,)),
        (r"codebooks$", (None, MODEL_AXIS)),
        (r"lm_head/kernel$", (None, MODEL_AXIS)),
    ]
)


class MeshContext:
    """This process's place on the (data, model) mesh, its device and the
    process groups of its data and model axes. Every rank creates every
    group, in the same order (`torch.distributed.new_group` needs that);
    a group that spans the whole world is the default group (None)."""

    def __init__(self, mesh: ProcessMesh | None = None, rules: ShardingRules | None = None,
                 device: str | torch.device | None = None):
        self.mesh = mesh if mesh is not None else default_mesh()
        self.rules = rules if rules is not None else DEFAULT_RULES
        self.device = resolve_device(device)
        world = distributed.process_count()
        if self.mesh.size != world:
            raise ValueError(f"mesh {self.mesh.data}x{self.mesh.model} != {world} processes")
        self.data_index, self.model_index = self.mesh.coords(distributed.process_index())
        self.data_group = self.model_group = None
        if distributed.is_initialized() and self.n_model > 1:
            for m in range(self.n_model):
                group = dist.new_group(self.mesh.data_ranks(m))
                if m == self.model_index:
                    self.data_group = group
            if self.n_data > 1:
                for d in range(self.n_data):
                    group = dist.new_group(self.mesh.model_ranks(d))
                    if d == self.data_index:
                        self.model_group = group
        self.model_axis = distributed.ModelAxis(self.model_index, self.n_model, self.model_group)

    @property
    def n_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    def first_row(self, local_rows: int) -> int:
        """The global batch row of this rank's first row."""
        return self.data_index * local_rows

    def shard_batch(self, batch: Any) -> Any:
        """This process's batch (its data index's rows of the global batch,
        see `distributed.shard_examples`) as tensors on its device."""
        if isinstance(batch, dict):
            return {k: self.shard_batch(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self.shard_batch(v) for v in batch)
        return torch.as_tensor(np.asarray(batch) if not isinstance(batch, torch.Tensor)
                               else batch, device=self.device)

    def param_shardings(self, model: torch.nn.Module) -> dict[str, tuple]:
        """`param_shardings` of `model` on this mesh by these rules."""
        return param_shardings(model, self.mesh, self.rules)

    def sharded_dims(self, model: torch.nn.Module) -> dict[str, int]:
        """{parameter name: torch dimension split on the model axis} of
        `model` once sharded (`shard_params`), else of its whole shapes."""
        if getattr(model, "mesh_ctx", None) is self:
            return dict(model.sharded_dims)
        dims = {}
        if self.n_model == 1:
            return dims
        for name, spec in self.param_shardings(model).items():
            if MODEL_AXIS in spec:
                dim = spec.index(MODEL_AXIS)
                kernel = flax_path(model, name).endswith("/kernel")
                dims[name] = model.get_parameter(name).dim() - 1 - dim if kernel else dim
        return dims

    def shard_params(self, model: torch.nn.Module) -> torch.nn.Module:
        """Keep this rank's block of every parameter the rules split on the
        model axis, in place, and hand the model (and its modules that take
        a `model_axis`) this context. Returns `model`. Raises for a split the
        model does not run (its `model_axis_params` pattern)."""
        dims = self.sharded_dims(model)
        unsupported = [n for n in dims
                       if not re.fullmatch(getattr(model, "model_axis_params", r"(?!)"), n)]
        if unsupported:
            raise NotImplementedError(
                f"{type(model).__name__} does not run {', '.join(sorted(unsupported))} "
                "split on the model axis; the port shards the Qwen family's token table and "
                "experts")
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, dim in dims.items():
                p = params[name]
                n = p.shape[dim] // self.n_model
                p.data = p.data.narrow(dim, self.model_index * n, n).clone()
        model.mesh_ctx = self
        model.sharded_dims = dims
        for mod in model.modules():
            if hasattr(mod, "model_axis"):
                mod.model_axis = self.model_axis
        return model

    def whole_state(self, tree: dict, dims: dict[str, int]) -> dict:
        """{name: whole tensor} of {parameter name: this rank's block} (a
        state dict, optimizer moments): each tensor split on dimension
        dims[name] gathered over the model group; every rank of the group
        calls it in the same order."""
        return {k: self.model_axis.all_gather(v.detach().contiguous(), dims[k])
                if k in dims else v for k, v in tree.items()}

    def block_state(self, tree: dict, dims: dict[str, int]) -> dict:
        """{name: this rank's block} of {parameter name: whole tensor}."""
        out = {}
        for k, v in tree.items():
            if k in dims:
                n = v.shape[dims[k]] // self.n_model
                v = v.narrow(dims[k], self.model_index * n, n)
            out[k] = v
        return out


def param_shardings(model: torch.nn.Module, mesh: ProcessMesh,
                    rules: ShardingRules = DEFAULT_RULES) -> dict[str, tuple]:
    """{parameter name: spec} of a model (whole, unsharded shapes) by the
    rules, fitted to the mesh (`_fit_spec`). Specs are in the flax layout (a
    Linear's kernel is the transpose of its torch weight), so they equal the
    JAX package's `MeshContext.param_shardings` path for path."""
    out = {}
    for name, p in model.named_parameters():
        path = flax_path(model, name)
        shape = tuple(p.shape)[::-1] if path.endswith("/kernel") else tuple(p.shape)
        out[name] = _fit_spec(rules.spec_for(path), shape, mesh, path)
    return out


def _fit_spec(spec: tuple, shape: tuple, mesh: ProcessMesh, path: str = "") -> tuple:
    """Drop trailing spec axes beyond the array rank; replicate any dimension
    whose mesh-axis size doesn't divide it (e.g. odd vocab on a 2-way axis).

    Replication is a fallback, not a policy: it is logged as a warning so an
    indivisible table is never *silently* replicated; pad the dimension
    (e.g. vocab via `pad_to_multiple`) to get the sharding the rules ask for.
    """
    parts = list(spec)[: len(shape)]
    fitted = []
    for dim, axis in zip(shape, parts + [None] * (len(shape) - len(parts))):
        if axis is None:
            fitted.append(None)
            continue
        size = mesh.shape[axis]
        if dim % size == 0:
            fitted.append(axis)
        else:
            if size > 1:
                get_logger("mesh").warning(
                    "replicating %s dim %d (not divisible by %s=%d) — pad it to shard as ruled",
                    path or "param", dim, axis, size)
            fitted.append(None)
    while fitted and fitted[-1] is None:
        fitted.pop()
    return tuple(fitted)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round n up to a multiple (vocab/table padding for clean sharding)."""
    return ((n + multiple - 1) // multiple) * multiple


def local_batch_size(global_batch: int, ctx: MeshContext) -> int:
    if global_batch % ctx.n_data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {ctx.n_data}")
    return global_batch // ctx.n_data
