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
number of updates applied before this one. On a model axis the global norm
sums each split parameter's squares over the model group and counts each
replicated one once, so it equals the one-process norm. No decay applies to parameters
whose flax name ends in "scale" or "bias" (`decay_mask`).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Mapping

import torch

from gamer_tpu_torch.convert import flax_path
from gamer_tpu_torch.core.config import Config


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


class Optimizer:
    """The optimizer chain of `make_optimizer` over named fp32 tensors."""

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

    def _clip(self, grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        max_norm = self.cfg.max_grad_norm
        if not max_norm or max_norm <= 0:
            return dict(grads)
        squares = lambda split: sum((g.float().square().sum() for k, g in grads.items()
                                     if (k in self.sharded) == split),
                                    torch.zeros((), device=next(iter(grads.values())).device))
        total = squares(False)
        if self.sharded:
            total = total + self.model_axis.all_reduce(squares(True).reshape(1))[0]
        norm = torch.sqrt(total)
        if norm < max_norm:
            return dict(grads)
        return {k: g / norm * max_norm for k, g in grads.items()}

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

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> float:
        """Apply one update in place; returns the learning rate it used."""
        cfg = self.cfg
        lr = self.schedule(self.count)
        grads = self._clip(grads)
        self.count += 1
        t = self.count
        coupled = (self.optim in ("adam", "sgd", "adagrad", "rmsprop") and cfg.weight_decay)
        for k, p in self.params.items():
            g = grads[k]
            if coupled and self.decay[k]:
                g = g + cfg.weight_decay * p
            if self.optim in ("adamw", "adam", "fallback_adam"):
                b1, b2, eps = ((0.9, 0.999, 1e-8) if self.optim == "fallback_adam"
                               else (cfg.adam_b1, cfg.adam_b2, cfg.adam_eps))
                self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
                self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (self.mu[k] / (1 - b1 ** t)) / (torch.sqrt(self.nu[k] / (1 - b2 ** t)) + eps)
                if self.optim == "adamw" and self.decay[k]:
                    u = u + cfg.weight_decay * p
            elif self.optim == "sgd":
                u = g
            elif self.optim == "adagrad":
                self.sum_sq[k].addcmul_(g, g)
                s = self.sum_sq[k]
                u = g * torch.where(s > 0, torch.rsqrt(s + 1e-7), 0.0)
            else:  # rmsprop
                self.nu[k].mul_(0.9).addcmul_(g, g, value=0.1)
                u = g * torch.rsqrt(self.nu[k] + 1e-8)
            p.add_(u, alpha=-lr)
        return lr


def make_optimizer(cfg: OptimizerConfig, model: torch.nn.Module) -> Optimizer:
    """The optimizer family of `cfg.optim` over `model`'s parameters (adamw
    decays decoupled; adam, sgd, adagrad and rmsprop add coupled L2 decay;
    an unknown name falls back to adam without decay, as in JAX); over the
    blocks of a model sharded on a model axis (`core/mesh.shard_params`)."""
    ctx = getattr(model, "mesh_ctx", None)
    sharded = frozenset(ctx.sharded_dims(model)) if ctx is not None else frozenset()
    return Optimizer(cfg, dict(model.named_parameters()), decay_mask(model), sharded,
                     ctx.model_axis if sharded else None)
