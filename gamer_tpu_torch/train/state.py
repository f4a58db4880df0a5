"""Optimizer configuration, learning-rate schedules and the optimizer.

PyTorch counterpart of `gamer_tpu/train/state.py`. The JAX package builds an
optax chain; the port writes the same update rules out for a dict of fp32
tensors updated in place, to optax's formulas (not `torch.optim`'s, which
differ: `clip_grad_norm_` adds 1e-6 to the norm, adagrad starts its
accumulator at 0, rmsprop adds eps outside the square root):

  clip_by_global_norm   g * max_norm / |g|  when |g| >= max_norm
  adamw                 adam moments with bias correction, u = m^ / (sqrt(v^) + eps),
                        then + weight_decay * p on decayed parameters, then * -lr
  adam/sgd/adagrad/     coupled L2 first (g + weight_decay * p on decayed
  rmsprop               parameters), then the family's rule, then * -lr
  adagrad               s = 0.1 + sum g^2, u = g / sqrt(s + 1e-7)
  rmsprop               v = 0.9 v + 0.1 g^2 (from 0), u = g / sqrt(v + 1e-8)

The schedule counts optimizer updates (`schedule_horizon`): its step is the
number of updates applied before this one; it is host state, and each update
writes its learning rate and bias corrections into a device buffer that the
update reads (`Optimizer.prepare`), so an update reads no device value into
Python. On the card the update is kernel L (`ops/fused_optimizer.py`);
`plain_update` is its plain version, for the CPU. On a model axis the global
norm sums each split parameter's squares over the model group and counts each
replicated one once, so it equals the one-process norm. No decay applies to
parameters whose flax name ends in "scale" or "bias" (`decay_mask`).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Mapping

import numpy as np
import torch

from gamer_tpu_torch.convert import flax_path
from gamer_tpu_torch.core.config import Config
from gamer_tpu_torch.ops import fused_optimizer as FO
from gamer_tpu_torch.train.staging import Staging


class OptimizerConfig(Config):
    optim: str = "adamw"  # adamw | adam | sgd | adagrad | rmsprop
    learning_rate: float = 5e-4
    lr_scheduler_type: str = "cosine"  # cosine | linear | constant
    warmup_ratio: float = 0.04
    warmup_steps: int = 0
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    total_steps: int = 10_000


def schedule_horizon(n_examples: int, micro: int, accum: int, epochs: int) -> int:
    """Total optimizer updates for the LR schedule: accumulation advances the
    schedule once per cycle, so the horizon counts updates, not micro-steps."""
    return max(n_examples // (micro * max(accum, 1)), 1) * epochs


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps`, then held."""
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """lr as a function of the update count (optax's warmup-cosine, joined
    linear, or constant schedule)."""
    warmup = cfg.warmup_steps or int(cfg.warmup_ratio * cfg.total_steps)
    decay_steps = max(cfg.total_steps - warmup, 1)
    peak = cfg.learning_rate
    if cfg.lr_scheduler_type == "cosine":
        ramp = _linear(0.0, peak, warmup)

        def cosine(count: int) -> float:
            if count < warmup:
                return ramp(count)
            t = min(count - warmup, decay_steps)
            return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return cosine
    if cfg.lr_scheduler_type == "linear":
        ramp, down = _linear(0.0, peak, max(warmup, 1)), _linear(peak, 0.0, decay_steps)
        return lambda count: ramp(count) if count < warmup else down(count - warmup)
    return lambda count: peak


def decay_mask(model: torch.nn.Module) -> dict[str, bool]:
    """{parameter name: decayed}: every parameter except those whose flax
    name ends in "scale" (norms) or "bias"."""
    return {name: not flax_path(model, name).endswith(("scale", "bias"))
            for name, _ in model.named_parameters()}


# each family's two moments as kernel L's records hold them (m, v)
_MOMENTS = {"adamw": ("mu", "nu"), "adam": ("mu", "nu"), "fallback_adam": ("mu", "nu"),
            "sgd": (None, None), "adagrad": (None, "sum_sq"), "rmsprop": (None, "nu")}


class Optimizer:
    """The optimizer chain of `make_optimizer` over named fp32 tensors.

    An update has a host half and a device half. `prepare` advances the
    update count and writes this update's learning rate and bias corrections
    into the device scalar buffer `scalars` (fp32 [lr, 1 - b1^t, 1 - b2^t,
    0], through pinned memory, no wait). `apply` clips and updates in place
    and reads nothing back to the host: on the card it runs kernel L
    (`ops/fused_optimizer.py`: L1 the global norm, then L2 the update) over
    a record table of the tensors, built once per set of grad addresses;
    on the CPU the plain version `plain_update`. `step` is both."""

    TABLES = 8  # record tables kept, one per set of grad addresses

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.Tensor],
                 decay: Mapping[str, bool], sharded: frozenset = frozenset(), model_axis=None):
        self.cfg = cfg
        self.sharded, self.model_axis = sharded, model_axis
        self.optim = cfg.optim.lower().replace("_torch", "")
        if self.optim not in ("adamw", "adam", "sgd", "adagrad", "rmsprop"):
            logging.getLogger("gamer_tpu_torch.train").warning(
                "unrecognized optimizer %r; using adam", cfg.optim)
            self.optim = "fallback_adam"
        self.params = dict(params)
        self.decay = dict(decay)
        self.schedule = make_schedule(cfg)
        self.count = 0  # updates applied
        zeros = lambda: {k: torch.zeros_like(p) for k, p in self.params.items()}
        if self.optim in ("adamw", "adam", "fallback_adam"):
            self.mu, self.nu = zeros(), zeros()
        elif self.optim == "adagrad":
            self.sum_sq = {k: torch.full_like(p, 0.1) for k, p in self.params.items()}
        elif self.optim == "rmsprop":
            self.nu = zeros()
        device = next(iter(self.params.values())).device
        self.scalars = torch.zeros(4, dtype=torch.float32, device=device)
        self._staging = Staging({"scalars": self.scalars})
        self._tables: dict[tuple, FO.RecordTable] = {}
        self.last_table: FO.RecordTable | None = None  # the table of the last `apply` on the card

    @property
    def betas(self) -> tuple[float, float, float]:
        """(b1, b2, eps) of the adam family (the fallback's are optax's defaults)."""
        if self.optim == "fallback_adam":
            return 0.9, 0.999, 1e-8
        return self.cfg.adam_b1, self.cfg.adam_b2, self.cfg.adam_eps

    @property
    def coupled(self) -> bool:
        """Whether the family adds L2 decay to the grads (adamw decays
        decoupled, the fallback not at all)."""
        return self.optim in ("adam", "sgd", "adagrad", "rmsprop") and bool(self.cfg.weight_decay)

    def state_dict(self) -> dict:
        """The update count and the family's moments or accumulators, for
        checkpoints (the tensors themselves, not copies)."""
        slots = {name: getattr(self, name) for name in ("mu", "nu", "sum_sq")
                 if hasattr(self, name)}
        return {"count": self.count, **slots}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Restore `state_dict()` output in place."""
        self.count = int(state["count"])
        for name, tensors in state.items():
            if name != "count":
                for k, t in tensors.items():
                    getattr(self, name)[k].copy_(t)

    def prepare(self) -> float:
        """The host half of an update: count it and write its learning rate
        and bias corrections into `scalars`. Returns the learning rate."""
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2, _ = self.betas
        t = self.count
        self._staging.write({"scalars": np.array([lr, 1 - b1 ** t, 1 - b2 ** t, 0.0], np.float32)})
        return lr

    @torch.no_grad()
    def apply(self, grads: Mapping[str, torch.Tensor]) -> None:
        """The device half: clip and update the parameters in place with the
        scalars of the last `prepare`; kernel L on the card, `plain_update`
        on the CPU."""
        if self.scalars.device.type == "cpu":
            plain_update(self, grads)
            return
        table = self._table(grads)
        totals = FO.global_norm_sq(table)
        if self.sharded:  # the split tensors' squares over the model group
            self.model_axis.all_reduce(totals[1:])
        b1, b2, eps = self.betas
        FO.apply_update(table, self.scalars, self.optim, b1, b2, eps, self.cfg.weight_decay,
                        self.cfg.max_grad_norm)

    def step(self, grads: Mapping[str, torch.Tensor]) -> float:
        """Apply one update in place; returns the learning rate it used."""
        lr = self.prepare()
        self.apply(grads)
        return lr

    def _table(self, grads: Mapping[str, torch.Tensor]) -> FO.RecordTable:
        """The record table of these grads (kept by their addresses)."""
        gs = [grads[k] for k in self.params]
        key = tuple(g.data_ptr() for g in gs)
        table = self._tables.get(key)
        if table is None:
            ms, vs = ([getattr(self, m)[k] if m else None for k in self.params]
                      for m in _MOMENTS[self.optim])
            decays = self.optim == "adamw" or self.coupled
            flags = [(FO.SHARDED if k in self.sharded else 0)
                     | (FO.DECAYED if decays and self.decay[k] else 0) for k in self.params]
            table = FO.RecordTable(self.params.values(), gs, ms, vs, flags, self.scalars.device)
            if len(self._tables) >= self.TABLES:
                self._tables.pop(next(iter(self._tables)))
            self._tables[key] = table
        self.last_table = table
        return table


def _clip(opt: Optimizer, grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """optax's clip_by_global_norm as a select on the device: g where the
    norm is under `max_grad_norm`, else g / norm * max_grad_norm."""
    max_norm = opt.cfg.max_grad_norm
    if not max_norm or max_norm <= 0:
        return dict(grads)
    squares = lambda split: sum((g.float().square().sum() for k, g in grads.items()
                                 if (k in opt.sharded) == split),
                                torch.zeros((), device=next(iter(grads.values())).device))
    total = squares(False)
    if opt.sharded:
        total = total + opt.model_axis.all_reduce(squares(True).reshape(1))[0]
    norm = torch.sqrt(total)
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm) for k, g in grads.items()}


@torch.no_grad()
def plain_update(opt: Optimizer, grads: Mapping[str, torch.Tensor]) -> None:
    """The plain version of kernel L: clip, then the family's update of each
    tensor in place, with the learning rate and bias corrections read from
    `opt.scalars` as tensors (no read into Python)."""
    cfg = opt.cfg
    lr, bc1, bc2 = opt.scalars[0], opt.scalars[1], opt.scalars[2]
    grads = _clip(opt, grads)
    for k, p in opt.params.items():
        g = grads[k]
        if opt.coupled and opt.decay[k]:
            g = g + cfg.weight_decay * p
        if opt.optim in ("adamw", "adam", "fallback_adam"):
            b1, b2, eps = opt.betas
            opt.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            opt.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (opt.mu[k] / bc1) / (torch.sqrt(opt.nu[k] / bc2) + eps)
            if opt.optim == "adamw" and opt.decay[k]:
                u = u + cfg.weight_decay * p
        elif opt.optim == "sgd":
            u = g
        elif opt.optim == "adagrad":
            opt.sum_sq[k].addcmul_(g, g)
            s = opt.sum_sq[k]
            u = g * torch.where(s > 0, torch.rsqrt(s + 1e-7), 0.0)
        else:  # rmsprop
            opt.nu[k].mul_(0.9).addcmul_(g, g, value=0.1)
            u = g * torch.rsqrt(opt.nu[k] + 1e-8)
        p.sub_(u * lr)


def make_optimizer(cfg: OptimizerConfig, model: torch.nn.Module) -> Optimizer:
    """The optimizer family of `cfg.optim` over `model`'s parameters (adamw
    decays decoupled; adam, sgd, adagrad and rmsprop add coupled L2 decay;
    an unknown name falls back to adam without decay, as in JAX); over the
    blocks of a model sharded on a model axis (`core/mesh.shard_params`)."""
    ctx = getattr(model, "mesh_ctx", None)
    sharded = frozenset(ctx.sharded_dims(model)) if ctx is not None else frozenset()
    return Optimizer(cfg, dict(model.named_parameters()), decay_mask(model), sharded,
                     ctx.model_axis if sharded else None)
