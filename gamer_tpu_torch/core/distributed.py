"""Multi-process data parallelism on `torch.distributed`.

The port's counterpart of `gamer_tpu/core/distributed.py`: process bootstrap,
per-process example sharding, rank helpers, and the few collectives the port
needs (a flat gradient sum, metric sums, a barrier). One process owns one
card; the training loop sums gradients itself (`train/loop.Trainer`), so the
global step is the JAX package's: one token mean over every process's
tokens. The helpers take a process group (`group`, default the whole
world): under a model axis (`core/mesh.py`) the data group of a rank is the
ranks that hold the same parameter shards, and `ModelAxis` holds the
collectives over its model group that the sharded modules differentiate
through.

Rendezvous, in precedence order:
 1. explicit kwargs to `maybe_initialize`;
 2. GAMER_COORDINATOR ("host:port") / GAMER_NUM_PROCESSES / GAMER_PROCESS_ID;
 3. torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, in place of
    the JAX package's GAMER_DISTRIBUTED=1 pod auto-detection.
The card is `cuda:LOCAL_RANK` (torchrun's variable), else the rank modulo
the visible cards. The backend is NCCL for CUDA and gloo for the CPU;
GAMER_BACKEND (or `backend=`) overrides it, e.g. gloo for two processes that
share one card, which NCCL refuses. Every group has a timeout
(GAMER_DIST_TIMEOUT seconds, default 300), so a broken rendezvous or a lost
peer raises instead of hanging.

With none of these set the run is one process and `maybe_initialize`
returns False without creating a group or touching CUDA.
"""

from __future__ import annotations

import datetime
import gc
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.core.logging import get_logger

logger = get_logger("distributed")

DEFAULT_TIMEOUT_S = 300.0


def _rendezvous(coordinator_address, num_processes, process_id):
    """(address "host:port", world size, rank) from the kwargs, the GAMER_*
    variables or torchrun's, in that order; None when unconfigured."""
    env = os.environ
    if num_processes is None and "GAMER_NUM_PROCESSES" in env:
        num_processes = int(env["GAMER_NUM_PROCESSES"])
    if process_id is None and "GAMER_PROCESS_ID" in env:
        process_id = int(env["GAMER_PROCESS_ID"])
    coordinator_address = coordinator_address or env.get("GAMER_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = num_processes if num_processes is not None else int(env["WORLD_SIZE"])
        process_id = process_id if process_id is not None else int(env.get("RANK", 0))
    if coordinator_address is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError(f"rendezvous at {coordinator_address} needs the number of processes "
                         "and this process's id")
    return coordinator_address, int(num_processes), int(process_id)


def maybe_initialize(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | torch.device | None = None,
                     backend: str | None = None,
                     timeout_s: float | None = None) -> bool:
    """Create the process group if a rendezvous is configured; idempotent.

    `device` is the task's device ("cuda", the default, or "cpu"): CUDA binds
    this process to its card and takes NCCL. Returns True when a group
    exists (after creating it), False when unconfigured."""
    if dist.is_initialized():
        return True
    rdv = _rendezvous(coordinator_address, num_processes, process_id)
    if rdv is None:
        return False
    address, world, rank = rdv
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs CUDA; pass device='cpu' for gloo")
        local_rank = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
    backend = backend or os.environ.get("GAMER_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    timeout = timeout_s or float(os.environ.get("GAMER_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    logger.info("distributed: process %d/%d via %s (%s, %s)", rank, world, address, backend,
                f"cuda:{local_rank}" if dev.type == "cuda" else "cpu")
    return True


def shutdown() -> None:
    """Destroy the process group, if any. Unreachable objects go first: a
    CUDA graph that holds the group's collectives (a `Trainer`'s step
    captured under NCCL) must be freed before the group's communicators."""
    if dist.is_initialized():
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def backend(group=None) -> str | None:
    """The backend ("nccl", "gloo") of `group` (the world by default); None without a group."""
    return dist.get_backend(group) if is_initialized() else None


def group_rank(group=None) -> int:
    """This process's rank in `group` (the world by default); 0 without a group."""
    return dist.get_rank(group) if is_initialized() else 0


def group_size(group=None) -> int:
    """The number of processes of `group` (the world by default); 1 without a group."""
    return dist.get_world_size(group) if is_initialized() else 1


def first_row(local_rows: int, group=None) -> int:
    """The global batch row of this process's first row: the equal local
    batches of `group`'s processes (the data group) stack in rank order
    into the global batch."""
    return group_rank(group) * local_rows


def shard_examples(examples, index: int | None = None, count: int | None = None, group=None):
    """This process's stride-shard of an example list among `group`'s
    processes, truncated to the common per-process length so every process
    runs the same number of steps (the training analog of eval's example
    striding, ref: DistributedSampler in SeqRec/tasks/test_SMB_decoder.py:434-438).
    """
    idx = group_rank(group) if index is None else index
    cnt = group_size(group) if count is None else count
    if cnt <= 1:
        return examples
    per = len(examples) // cnt
    return examples[idx::cnt][:per]


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over `group`, in place (a no-op without a group)."""
    if is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_flat(tensors: list[torch.Tensor], group=None) -> None:
    """Sum same-dtype tensors over `group` in place, as one flat all-reduce
    in the list's order. The counter `all_reduce.flat` (`core/trace.py`)
    counts the training step's all-reduces that ran: the step's host part
    adds one for each update it runs (`train/loop.Trainer.train_step`), since
    a captured step replays the all-reduce without calling this."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def model_all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over a model group in place: one collective, counted in the
    counter `all_reduce.model`. While tracing is on it is the span
    `all_reduce.model`, which synchronizes the card before and after, so
    the span's host time holds the collective alone."""
    timed = trace.enabled() and t.is_cuda
    with trace.span("all_reduce.model"):
        if timed:
            torch.cuda.synchronize(t.device)
        # 16-bit values travel as fp32: the sums of partial results stay exact
        buf = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if buf is not t:
            t.copy_(buf)
        if timed:
            torch.cuda.synchronize(t.device)
    trace.count("all_reduce.model")
    return t


class ModelAxis:
    """A rank's place on the model axis: its `index` of `size` shards and
    the collectives over its model `group`. The autograd pairs are
    conjugate: `reduce` sums partial results (backward: the replicated
    grad as it is), `copy` hands replicated tensors to a sharded region
    (backward: the ranks' partial grads summed), `gather` concatenates the
    ranks' blocks (backward: this rank's block). Without a process group
    they do no collective (a test runs the shards in turn and sums them)."""

    def __init__(self, index: int = 0, size: int = 1, group=None):
        self.index, self.size, self.group = index, size, group

    @property
    def live(self) -> bool:
        return self.size > 1 and is_initialized()

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(t, self) if self.live else t

    def copy(self, *ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return _Copy.apply(self, *ts) if self.live else ts

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(t, self, dim) if self.live else t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the group in place, outside autograd."""
        return model_all_reduce(t, self.group) if self.live else t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' equal blocks concatenated along `dim`, outside autograd:
        a zero-filled buffer with this rank's block, summed over the group
        (exact: every other term is 0)."""
        if not self.live:
            return t
        shape = list(t.shape)
        n = shape[dim]
        shape[dim] = n * self.size
        buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
        buf.narrow(dim, self.index * n, n).copy_(t)
        return model_all_reduce(buf, self.group)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return axis.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *ts):
        ctx.axis = axis
        ctx.like = [(t.shape, t.dtype, t.device) for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g
              for g, (shape, dtype, device) in zip(gs, ctx.like)]
        flat = ctx.axis.all_reduce(torch.cat([g.float().reshape(-1) for g in gs]))
        out, offset = [], 0
        for g in gs:
            out.append(flat[offset:offset + g.numel()].view_as(g).to(g.dtype))
            offset += g.numel()
        return (None, *out)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, t.shape[dim]
        return axis.all_gather(t.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n).contiguous(), None, None


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def spawn_local(argvs: list[list[str]], backend: str | None = None, cwd: str | None = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list[str]:
    """Run `python <argv>` for each argv of `argvs` as rank r of one group on
    this machine (GAMER_* variables, a free localhost port; GAMER_BACKEND
    when `backend` is given; the group's timeout `timeout_s`; unless set,
    OMP_NUM_THREADS gives each process its share of the cores), wait for all
    within `timeout_s`, kill any left, and raise with its output's end if
    one failed. Returns each process's output."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for r, argv in enumerate(argvs):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("GAMER_", "MASTER_")) and k not in ("RANK", "WORLD_SIZE")}
        # the processes share this host's cores
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // len(argvs))))
        env.update(GAMER_COORDINATOR=f"localhost:{port}", GAMER_NUM_PROCESSES=str(len(argvs)),
                   GAMER_PROCESS_ID=str(r), GAMER_DIST_TIMEOUT=str(timeout_s),
                   PYTHONPATH=os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p))
        if backend:
            env["GAMER_BACKEND"] = backend
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=cwd or root,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {r} of {len(argvs)} exited {p.returncode}:\n"
                               f"{log[-4000:]}")
    return logs
