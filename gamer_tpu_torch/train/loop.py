"""Generic training loop.

PyTorch counterpart of `gamer_tpu/train/loop.py`: one train step (forward,
backward, optimizer), gradient accumulation as `optax.MultiSteps` does it
(k micro-step grads averaged as a running mean, one optimizer update per k
micro-steps, the schedule counting updates), per-epoch (or every-N-updates)
eval as a global token mean with dropout off, early stopping with patience,
and the JSONL metric stream. With an `output_dir` it checkpoints as the JAX
loop does (`core/checkpoint.py`): "best" (the model's state dict) on every
improvement, "last_state" (parameters, optimizer moments and count, micro-step,
a mid-cycle accumulator; epoch and best in its metadata) after every epoch and
every steps-mode eval, "last" at the end, and with `snapshot_every_epochs`
"epoch_<N>" snapshots keeping the newest `snapshot_limit`; `resume` restores
"last_state" and continues from the epoch after it.

The loop consumes `loss_fn(batch, seeds) -> (loss, aux)`, differentiable
in the model's parameters; each micro-step's dropout seeds are drawn from a
CPU `torch.Generator` seeded by `(loop seed, micro-step)`.

A micro-step is the counterpart of JAX's jitted step (`_build_train_step`),
in two parts. The host part stages the batch's arrays, the step's dropout
seeds (drawn from the generator into the model's [dropout_sites] int32 seed
table, `ops/seeds.py`), the accumulation divisor and, on an update, the
optimizer's scalars (`Optimizer.prepare`) into static device buffers,
through pinned memory without waiting for the card (`train/staging.py`).
The device part, `_device_step`, is forward, backward, the running-mean
accumulation into static accumulators, and on the update micro-step the
optimizer's device half (kernel L on the card); it reads no device value
into Python. On CUDA the device part is captured
once per (input shapes and dtypes, accumulation phase) as a CUDA graph, as
`jax.jit` traces once per shape: the first step of each runs eagerly on a
side stream (PyTorch's whole-network capture recipe: the warm-up is the
real step), then the capture records it, and every later step replays it
(`core/graphs.StagedGraphs`). All training-step graphs of a `Trainer` share
one memory pool. `graphed=False` keeps the eager device part (the same
code, launched op by op); a model without a seed table (`dropout_sites`)
gets the generator itself and runs only eagerly. A capture that fails
raises.

`evaluate` is JAX's jitted eval step (`_build_eval_step`) the same way
(`EvalStep`): each batch staged into static buffers, the loss and the
running sums on the card, captured once per batch shape, in a pool of its
own; one host read at the end.

Under a process group (`core/distributed.py`) each process feeds its own
rows, and the step is the JAX package's global one: the loss is one token
mean over every process's tokens. A micro-step all-reduces (loss * denom,
denom), whose ratio is the returned loss, and weighs its local grads by
denom / global denom; an update all-reduces the accumulated grads once, as
one flat buffer in parameter order, before the optimizer clips them. Every
process then applies the same sum, so parameters stay bit-identical.
`evaluate` sums its totals and weights over the group the same way. The
training step's two all-reduces are in its device part: under an NCCL group
they are captured with it and every replay runs them; under a gloo group,
which stages the card's tensors through the host, the step runs eagerly
(`core/graphs.capture_enabled`). A batch's weight w comes from the loss
("denom") or, without one, from its valid rows, staged with the step's
scalars. The eval step's device part holds no collective (its sums are
reduced after the batches), so it is captured under any group.

On a (data, model) mesh (the `core/mesh.MeshContext` whose `shard_params`
the model went through) these sums run over the data
group, and the model ranks of a data index compute the same loss on the same
rows. A live model axis puts collectives in every forward, which time
themselves on the host, so both steps of a sharded model run eagerly.
Checkpoints and `best_params` hold whole tensors: each split parameter (and
its optimizer moments and accumulated grad) gathered over the model group,
written by process 0, so a sharded run's checkpoint loads in one process;
`load_train_state` takes this rank's blocks of whole tensors.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from gamer_tpu_torch.core import distributed, trace
from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.core.config import Config
from gamer_tpu_torch.core.graphs import StagedGraphs
from gamer_tpu_torch.core.metrics import MetricWriter
from gamer_tpu_torch.ops.seeds import draw
from gamer_tpu_torch.train.staging import Staging, as_array
from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

logger = logging.getLogger("gamer_tpu_torch.train")


class TrainLoopConfig(Config):
    epochs: int = 200
    patience: int = 20  # early-stop after N evals without improvement (<= 0: off)
    # "epoch": eval every eval_every_epochs; "steps": eval every
    # eval_every_steps optimizer updates, mid-epoch
    eval_strategy: str = "epoch"
    eval_every_epochs: int = 1
    eval_every_steps: int = 2000
    eval_delay: int = 0  # skip evals before this epoch (epoch mode) / update (steps mode)
    log_every_steps: int = 50
    gradient_accumulation_steps: int = 1
    metric_mode: str = "min"  # "min" (valid loss) or "max" (ranking metric)
    seed: int = 42
    save_checkpoints: bool = True
    # periodic per-epoch snapshots, keeping the newest N
    snapshot_every_epochs: int = 0  # 0 = off
    snapshot_limit: int = 2
    resume: bool = False  # restore the full train state from "last_state"


class Trainer:
    def __init__(
        self,
        loss_fn: Callable[[dict, torch.Generator], tuple[torch.Tensor, dict]],
        model: torch.nn.Module,
        opt_cfg: OptimizerConfig,
        loop_cfg: TrainLoopConfig,
        output_dir: str | None = None,
        metric_writer: MetricWriter | None = None,
        eval_fn: Callable[[torch.nn.Module], tuple[float, dict]] | None = None,
        eval_loss_fn: Callable[[dict], tuple[torch.Tensor, dict]] | None = None,
        graphed: bool = True,
    ):
        self.loss_fn = loss_fn
        self.ctx = getattr(model, "mesh_ctx", None)
        self.data_group = self.ctx.data_group if self.ctx is not None else None
        self.dims = self.ctx.sharded_dims(model) if self.ctx is not None else {}
        # the eval loss runs with dropout off: early stopping and the best
        # parameters must not follow dropout noise
        self.eval_loss_fn = eval_loss_fn
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = loop_cfg
        self.writer = metric_writer
        self.eval_fn = eval_fn
        self.ckpt = (CheckpointManager(output_dir)
                     if output_dir and loop_cfg.save_checkpoints else None)
        self.optimizer = make_optimizer(opt_cfg, model)
        self.params = dict(model.named_parameters())
        self.step = 0  # micro-steps taken
        self._best_state: dict[str, torch.Tensor] | None = None
        # the compiled step (module docstring): static buffers, graphs, pool
        self.graphed = graphed
        self.device = self.optimizer.scalars.device
        k = max(loop_cfg.gradient_accumulation_steps, 1)
        # the running mean of a cycle's grads, mid-cycle state of a checkpoint
        self._acc = {n: torch.zeros_like(p) for n, p in self.params.items()} if k > 1 else None
        n_seeds = getattr(model, "dropout_sites", None)
        self._seeds = (torch.zeros(n_seeds, dtype=torch.int32, device=self.device)
                       if n_seeds is not None else None)
        self._div = torch.ones((), dtype=torch.float32, device=self.device)
        # a batch's valid rows: its weight in the global mean of a loss without "denom"
        self._row_w = torch.ones((), dtype=torch.float64, device=self.device)
        per_step = {"div": self._div, "row_w": self._row_w}
        self._per_step = Staging(per_step if self._seeds is None
                                 else {**per_step, "seeds": self._seeds})
        model_axis = self.ctx.model_axis if self.ctx is not None else None
        self.staged = StagedGraphs(self.device, "training step", graphed, reduces=True,
                                  group=self.data_group, model_axis=model_axis)
        self._eval: EvalStep | None = None

    # ------------------------------------------------------------------ steps

    def generator(self, step: int) -> torch.Generator:
        """The dropout-seed generator of micro-step `step`."""
        return torch.Generator().manual_seed((self.cfg.seed * 1_000_003 + step) % (2 ** 63))

    def train_step(self, batch: dict) -> torch.Tensor:
        """One micro-step: forward, backward, accumulate; an optimizer
        update every `gradient_accumulation_steps` micro-steps. Returns the
        (detached) loss."""
        k = max(self.cfg.gradient_accumulation_steps, 1)
        mini = self.step % k
        with trace.step("train.step", self.device):
            inputs, seeds = self._prepare(batch, mini, k)
            if self.captures:
                loss = self._graph_step(inputs, seeds, mini, k)
            else:
                trace.count("graph.eager.training step")
                loss = self._device_step(inputs, seeds, mini, k)
        if mini == k - 1 and distributed.is_initialized():
            trace.count("all_reduce.flat")  # the update's all-reduce ran, replays too
        self.step += 1
        return loss

    @property
    def captures(self) -> bool:
        """Whether the device part is captured and replayed as CUDA graphs:
        on the card, `graphed`, and, under a process group, only if its data
        group is NCCL and the model has no live model axis
        (`core/graphs.capture_enabled`)."""
        return self.staged.captures

    @property
    def graphs(self) -> int:
        """CUDA graphs captured: one per input geometry and accumulation phase."""
        return self.staged.graphs

    def _prepare(self, batch: dict, mini: int, k: int) -> tuple[dict, Any]:
        """The host part of a micro-step: the batch into its static device
        buffers, the dropout seeds and the accumulation divisor into theirs
        (under a process group also the batch's valid rows), and on the
        update micro-step the optimizer's scalars. Returns (the device batch,
        the seed table or, for a model without one, the generator)."""
        _, static = self.staged.stage({n: as_array(v) for n, v in batch.items()})
        per_step = {"div": np.float32(mini + 1)}
        if distributed.is_initialized():
            per_step["row_w"] = np.float64(valid_rows(batch))
        seeds = self.generator(self.step)
        if self._seeds is not None:
            per_step["seeds"] = draw(seeds, self._seeds.numel()).to(torch.int32)
            seeds = self._seeds
        self._per_step.write(per_step)
        if mini == k - 1:
            self.optimizer.prepare()
        return static, seeds

    def _device_step(self, inputs: dict, seeds, mini: int, k: int) -> torch.Tensor:
        """The device part of a micro-step on the staged inputs; changes no
        host state, so it can run inside a capture (its all-reduces too,
        under an NCCL group)."""
        grouped = distributed.is_initialized()
        for p in self.params.values():
            p.grad = None
        loss, aux = self.loss_fn(inputs, seeds)
        if grouped:  # the global token mean and this process's share of it
            w = aux["denom"].double() if "denom" in aux else self._row_w
            stats = distributed.all_reduce_sum(torch.stack([loss.detach().double() * w, w]),
                                               self.data_group)
            share = (w / stats[1]).float()
        loss.backward()
        trace.mark("update", self.device)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        if grouped:
            grads = {n: g * share for n, g in grads.items()}
            loss = (stats[0] / stats[1]).float()
        if self._acc is not None:  # running mean, as optax.MultiSteps: acc + (g - acc) / (n + 1)
            for n, g in grads.items():
                if mini == 0:
                    self._acc[n].copy_(g)
                else:
                    self._acc[n].add_((g - self._acc[n]) / self._div)
            grads = self._acc
        for p in self.params.values():
            p.grad = None
        if mini == k - 1:
            if grouped:
                distributed.all_reduce_flat(list(grads.values()), self.data_group)
            self.optimizer.apply(grads)
        trace.mark(trace.UNMARKED, self.device)
        return loss.detach()

    def _graph_step(self, inputs: dict, seeds, mini: int, k: int) -> torch.Tensor:
        """The device part through the CUDA graph of its key, captured at its
        first step (which runs eagerly on a side stream: the warm-up)."""
        if not isinstance(seeds, torch.Tensor):
            raise ValueError("the captured step reads its dropout seeds from device memory: the "
                             "model must give its seed count (`dropout_sites`); pass "
                             "graphed=False to run it eagerly")
        phase = "update" if k == 1 else ("first" if mini == 0 else
                                         "last" if mini == k - 1 else "middle")
        key = (tuple((n, tuple(t.shape), t.dtype) for n, t in inputs.items()), phase)
        # an update's graph reads the optimizer's record table: kept with it
        hold = (lambda: self.optimizer.last_table) if mini == k - 1 else None
        return self.staged.run(key, lambda static: self._device_step(static, seeds, mini, k),
                               inputs, hold)

    @property
    def updates(self) -> int:
        """Optimizer updates applied."""
        return self.optimizer.count

    def _whole(self, tree: dict) -> dict:
        """{parameter name: whole tensor} of this rank's blocks."""
        return self.ctx.whole_state(tree, self.dims) if self.dims else tree

    def _block(self, tree: dict) -> dict:
        return self.ctx.block_state(tree, self.dims) if self.dims else tree

    def model_state(self) -> dict:
        """The model's state dict of whole tensors."""
        return self._whole(self.model.state_dict())

    def train_state(self) -> dict:
        """Everything a resumed run needs: parameters, optimizer state,
        micro-step and a mid-cycle gradient accumulator (whole tensors)."""
        opt = {k: (self._whole(v) if isinstance(v, dict) else v)
               for k, v in self.optimizer.state_dict().items()}
        k = max(self.cfg.gradient_accumulation_steps, 1)
        acc = self._acc if self._acc is not None and self.step % k else {}
        return {"params": self.model_state(), "opt": opt, "step": self.step,
                "acc": self._whole(acc)}

    def load_train_state(self, state: dict) -> None:
        self.model.load_state_dict(self._block(state["params"]))
        self.optimizer.load_state_dict({k: (self._block(v) if isinstance(v, dict) else v)
                                        for k, v in state["opt"].items()})
        self.step = int(state["step"])
        for k, v in self._block(state["acc"]).items():  # a mid-cycle accumulator
            self._acc[k].copy_(v)

    # ------------------------------------------------------------------ loops

    def evaluate(self, batches: Iterable[dict]) -> float:
        """Global mean loss over batches: batch means re-weighted by the
        loss's valid-target count (aux "denom"), else by valid rows, so the
        result is one token mean whatever the batch split (and, under a
        process group, over every process's batches). Each batch goes
        through the eval step (`EvalStep`: captured once per batch shape on
        the card, as the training step is); the sums are read once, at the
        end."""
        step = self.eval_step()
        step.reset()
        for batch in batches:
            step.add(batch)
        sums = step.sums
        if distributed.is_initialized():
            sums = distributed.all_reduce_sum(sums.double(), self.data_group)
        total, weight = sums.tolist()
        return total / max(weight, 1.0)

    def eval_step(self) -> "EvalStep":
        """The eval step of `evaluate`, made at first use: `eval_loss_fn`, or
        without one the training loss with the dropout seeds of
        `generator(0)` (in a seed table where the model has one)."""
        if self._eval is None:
            loss_fn = self.eval_loss_fn
            if loss_fn is None:
                seeds = self.generator(0)
                if self._seeds is not None:
                    seeds = draw(seeds, self._seeds.numel()).to(torch.int32).to(self.device)
                loss_fn = lambda b: self.loss_fn(b, seeds)  # noqa: E731
            self._eval = EvalStep(loss_fn, self.device, self.graphed,
                                  model_axis=self.staged.model_axis)
        return self._eval

    def fit(self, train_batches: Callable[[int], Iterator[dict]],
            eval_batches: Callable[[], Iterator[dict]] | None = None) -> dict:
        cfg = self.cfg
        best = np.inf if cfg.metric_mode == "min" else -np.inf
        better = (lambda a, b: a < b) if cfg.metric_mode == "min" else (lambda a, b: a > b)
        evals_since_best = 0
        history: list[dict] = []
        accum = max(cfg.gradient_accumulation_steps, 1)
        start_epoch = 0
        if cfg.resume and self.ckpt and self.ckpt.exists("last_state"):
            self.load_train_state(self.ckpt.restore("last_state"))
            meta = self.ckpt.metadata("last_state") or {}
            start_epoch = int(meta.get("epoch", -1)) + 1
            best = float(meta.get("best", best))
            logger.info("resumed from epoch %d (step %d, best %.4f)", start_epoch, self.step, best)

        def run_eval(epoch: int, epoch_loss: float | None) -> bool:
            """One eval, best tracking and the early-stop check; True = stop."""
            nonlocal best, evals_since_best
            metric = None
            if self.eval_fn is not None:
                metric, extras = self.eval_fn(self.model)
                if self.writer:
                    self.writer.log({"eval/metric": metric,
                                     **{f"eval/{k}": v for k, v in extras.items()}},
                                    step=self.step)
            elif eval_batches is not None:
                metric = self.evaluate(eval_batches())
                if self.writer:
                    self.writer.log({"eval/loss": metric}, step=self.step)
            if metric is None:
                return False
            logger.info("epoch %d: eval metric %.4f (best %.4f)", epoch, metric, best)
            entry = {"epoch": epoch, "eval": metric, "step": self.step}
            if epoch_loss is not None:
                entry["train_loss"] = epoch_loss
            history.append(entry)
            if better(metric, best):
                best = metric
                evals_since_best = 0
                if self.ckpt:
                    self.ckpt.save("best", self.model_state(),
                                   {"epoch": epoch, "metric": float(metric), "step": self.step})
                else:
                    self._best_state = {k: v.detach().clone()
                                        for k, v in self.model_state().items()}
            else:
                evals_since_best += 1
                if cfg.patience > 0 and evals_since_best >= cfg.patience:
                    logger.info("early stopping at epoch %d", epoch)
                    return True
            if self.ckpt and cfg.eval_strategy == "steps":
                self.ckpt.save("last_state", self.train_state(),
                               {"epoch": epoch, "best": float(best), "step": self.step})
            return False

        stop = False
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            n_steps, loss_acc = 0, None
            for batch in train_batches(epoch):
                loss = self.train_step(batch)
                loss_acc = loss if loss_acc is None else loss_acc + loss
                n_steps += 1
                if self.writer and n_steps % cfg.log_every_steps == 0:
                    self.writer.log({"train/loss": float(loss), "epoch": epoch}, step=self.step)
                if (cfg.eval_strategy == "steps"
                        and self.step % (cfg.eval_every_steps * accum) == 0
                        and self.step // accum >= cfg.eval_delay):
                    stop = run_eval(epoch, None)
                    if stop:
                        break
            if stop:
                break
            epoch_loss = float(loss_acc) / n_steps if n_steps else 0.0
            logger.info("epoch %d: train loss %.4f (%d steps, %.1fs)", epoch, epoch_loss,
                        n_steps, time.time() - t0)
            if (cfg.eval_strategy == "epoch" and (epoch + 1) % cfg.eval_every_epochs == 0
                    and epoch >= cfg.eval_delay):
                if run_eval(epoch, epoch_loss):
                    break
            if self.ckpt:
                if cfg.snapshot_every_epochs > 0 and (epoch + 1) % cfg.snapshot_every_epochs == 0:
                    self.ckpt.save(f"epoch_{epoch}", self.model_state(), {"epoch": epoch})
                    if distributed.is_main_process():
                        self._prune_snapshots(cfg.snapshot_limit)
                self.ckpt.save("last_state", self.train_state(),
                               {"epoch": epoch, "best": float(best), "step": self.step})
        if self.ckpt:
            self.ckpt.save("last", self.model_state(), {"step": self.step})
        logger.info("the fit captured %d CUDA graphs of the training step; graphs by owner: %s",
                    self.graphs, trace.graph_summary() or "none")
        return {"best_metric": float(best), "history": history, "steps": self.step,
                "graphs": self.graphs}

    # --------------------------------------------------------------- restore

    def _prune_snapshots(self, limit: int) -> None:
        snaps = sorted((int(m.group(1)), m.group(0)) for m in
                       (re.fullmatch(r"epoch_(\d+)", n) for n in os.listdir(self.ckpt.directory))
                       if m)
        for _, name in snaps[:-limit] if limit > 0 else []:
            shutil.rmtree(os.path.join(self.ckpt.directory, name), ignore_errors=True)
            meta = os.path.join(self.ckpt.directory, name + ".meta.json")
            if os.path.exists(meta):
                os.remove(meta)

    def best_params(self) -> dict[str, Any]:
        """The state dict (whole tensors) of the best eval: the "best"
        checkpoint, or without an output directory the copy kept in memory,
        else the current one."""
        if self.ckpt and self.ckpt.exists("best"):
            return self.ckpt.restore("best", map_location=self.model.device
                                     if hasattr(self.model, "device") else "cpu")
        if self._best_state is not None:
            return self._best_state
        return {k: v.detach() for k, v in self.model_state().items()}


class EvalStep:
    """JAX's jitted eval step (`Trainer._build_eval_step`) and the device
    sums of its `evaluate`, for a loss `loss_fn(batch) -> (loss, aux)`.

    `add(batch)` is one batch in two parts. The host part stages the
    batch's arrays and its valid-row count (the sum of "row_valid", else 1)
    into static device buffers (`core/graphs.StagedGraphs`). The device
    part runs the loss and adds loss * w and w into `sums` ([total,
    weight], of `dtype`), w being aux "denom" (the valid-target count) where
    the loss gives one and `by_rows` is off, else the valid rows; it reads
    nothing into Python and holds no collective (a caller under a process
    group reduces `sums` afterwards). On CUDA, and `graphed`, the device
    part is captured once per input key (a short last batch is a second
    key, as `jax.jit` compiles again for it) and replayed, under any process
    group; only a live `model_axis` (whose forward holds collectives) keeps
    it eager. The eval graphs have a memory pool of their own. The caller
    reads `sums` once."""

    def __init__(self, loss_fn: Callable[[dict], tuple[torch.Tensor, dict]], device,
                 graphed: bool = True, dtype: torch.dtype = torch.float32,
                 by_rows: bool = False, model_axis=None):
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.by_rows = by_rows
        self.sums = torch.zeros(2, dtype=dtype, device=self.device)
        self.staged = StagedGraphs(self.device, "eval step", graphed, model_axis=model_axis)

    @property
    def captures(self) -> bool:
        """On the card and `graphed`, under any process group, unless the
        model has a live model axis (`core/graphs.capture_enabled`)."""
        return self.staged.captures

    @property
    def graphs(self) -> int:
        """CUDA graphs captured: one per input key."""
        return self.staged.graphs

    def reset(self) -> None:
        self.sums.zero_()

    def stage(self, batch: dict) -> tuple[tuple, dict]:
        """The host part: (the input key, the static device batch, whose
        "row_w" entry is the batch's valid-row count)."""
        return self.staged.stage({**{n: as_array(v) for n, v in batch.items()},
                                  "row_w": torch.tensor(valid_rows(batch), dtype=self.sums.dtype)})

    def device_part(self, static: dict) -> None:
        """Adds the batch's loss * w and w into `sums`."""
        batch = {n: t for n, t in static.items() if n != "row_w"}
        loss, aux = self.loss_fn(batch)
        w = (static["row_w"] if self.by_rows or "denom" not in aux
             else aux["denom"].to(self.sums.dtype))
        self.sums.add_(torch.stack([loss.detach().to(self.sums.dtype) * w, w]))

    @torch.no_grad()
    def add(self, batch: dict) -> None:
        key, static = self.stage(batch)
        self.staged.run(key, self.device_part, static)


def valid_rows(batch: dict) -> float:
    """A batch's valid rows (the sum of "row_valid", else 1): its weight in a
    global mean where the loss gives no valid-target count."""
    return float(np.asarray(batch.get("row_valid", np.ones(1))).sum())
