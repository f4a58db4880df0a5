"""Capture under a process group, on the CPU.

- The rule of `core/graphs.capture_enabled` as a table: the CPU,
  `graphed=False`, no group, an NCCL group, a gloo group and a live model
  axis, each for an owner whose device part reduces over a group (a
  `Trainer`'s step) and one whose device part reduces over nothing (the
  eval step, the searches, the zoo's and the RQ-VAE's device parts). The
  backend query is monkeypatched, so no NCCL is needed.
- The grouped `Trainer` device part in a one-process gloo group: both of
  its all-reduces and its weight (the loss's "denom", or without one the
  batch's valid rows staged with the step's scalars) run with reading a
  tensor into Python and making a tensor from host data patched to raise,
  as a CUDA graph's capture needs; its losses equal the ungrouped step's,
  and the counter `all_reduce.flat` counts the updates that ran.

The capture itself runs only on the card (`tests/test_torch_kernels_gpu.py
-k nccl`, `chip_smoke.py` phase 11a).
"""

import contextlib
import socket

import numpy as np
import pytest
import torch

from gamer_tpu_torch.core import distributed, trace
from gamer_tpu_torch.core import graphs as G
from gamer_tpu_torch.core.distributed import ModelAxis
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
from gamer_tpu_torch.train import loop as TL
from gamer_tpu_torch.train import state as TS
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_qwen_family import make_batch, tiny_kwargs

# (device, graphed, process group backend or None, live model axis) ->
# (captures with a collective in the device part, captures without one)
RULE = [
    (("cpu", True, None, False), (False, False)),
    (("cpu", True, "nccl", False), (False, False)),
    (("cuda", False, None, False), (False, False)),
    (("cuda", False, "nccl", False), (False, False)),
    (("cuda", True, None, False), (True, True)),
    (("cuda", True, "nccl", False), (True, True)),
    (("cuda", True, "gloo", False), (False, True)),
    (("cuda", True, "nccl", True), (False, False)),
    (("cuda", True, "gloo", True), (False, False)),
]


@pytest.mark.parametrize("case,want", RULE, ids=lambda v: "-".join(map(str, v)))
def test_capture_rule(case, want, monkeypatch):
    device, graphed, backend, axis_live = case
    grouped = backend is not None
    monkeypatch.setattr(distributed, "is_initialized", lambda: grouped)
    monkeypatch.setattr(distributed, "backend", lambda group=None: backend)
    axis = ModelAxis(0, 2 if axis_live else 1)
    assert axis.live == (axis_live and grouped)
    group = object()  # the data group the device part reduces over
    got = tuple(G.StagedGraphs.__new__(G.StagedGraphs) for _ in range(2))
    for owner, reduces in zip(got, (True, False)):
        owner.device, owner.graphed = torch.device(device), graphed
        owner.reduces, owner.group, owner.model_axis = reduces, group, axis
    assert tuple(o.captures for o in got) == want
    assert tuple(G.capture_enabled(graphed, device, r, group, axis)
                 for r in (True, False)) == want


def test_capture_rule_reads_the_owners_group(monkeypatch):
    """The backend is asked of the group the device part reduces over."""
    asked = []
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "backend", lambda group=None: asked.append(group) or "nccl")
    group = object()
    assert G.capture_enabled(True, "cuda", True, group) and asked == [group]
    assert G.capture_enabled(True, "cuda", False, group) and asked == [group]


@contextlib.contextmanager
def host_io_forbidden():
    """While the block runs, reading a tensor into Python and making a tensor
    from host data raise (`tests/test_torch_compiled_rec.no_host_io`, for a
    block)."""
    def read(*args, **kwargs):
        raise AssertionError("a tensor was read into Python")

    def make(*args, **kwargs):
        raise AssertionError("a tensor was made from host data")
    with pytest.MonkeyPatch.context() as mp:
        for name in ("__bool__", "__float__", "__int__", "item", "tolist"):
            mp.setattr(torch.Tensor, name, read)
        for name in ("as_tensor", "tensor", "from_numpy"):
            mp.setattr(torch, name, make)
        yield


@contextlib.contextmanager
def one_process_gloo_group():
    """A one-process gloo group while the block runs."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert distributed.maybe_initialize(f"localhost:{port}", 1, 0, device="cpu", backend="gloo",
                                        timeout_s=60)
    try:
        yield
    finally:
        distributed.shutdown()


def _trainer(k: int, denom: bool):
    cfg = TQ.build_config("Qwen3Multi", **tiny_kwargs(dropout_rate=0.2))
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=0)
    loss_fn = make_loss_fn(model, deterministic=False)
    if not denom:
        loss_fn = (lambda f: lambda *a: (f(*a)[0], {}))(loss_fn)
    trainer = TL.Trainer(loss_fn, model,
                         TS.OptimizerConfig(learning_rate=3e-3, warmup_steps=1, total_steps=4,
                                            max_grad_norm=0.5),
                         TL.TrainLoopConfig(gradient_accumulation_steps=k, seed=0))
    return cfg, model, trainer


def _batches(cfg, k: int):
    batches = [make_batch(cfg, B=3, seed=s) for s in range(k)]
    for b in batches:  # a batch-padding row: the valid rows (2) differ from the rows (3)
        b["row_valid"] = np.array([1, 1, 0], np.int32)
    return batches


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("denom", [True, False])
def test_grouped_device_step_reads_nothing_and_copies_nothing(k, denom):
    """Each micro-step's device part in a one-process gloo group (both
    all-reduces on the update) under `host_io_forbidden`, against the same
    steps ungrouped (a second trainer from the same weights): losses within
    1e-6, parameters within 1e-6 of their largest."""
    cfg, _, plain = _trainer(k, denom)
    batches = _batches(cfg, k)
    want = [plain.train_step(b) for b in batches]
    got = []
    with one_process_gloo_group():
        _, model, trainer = _trainer(k, denom)
        for mini, b in enumerate(batches):
            inputs, seeds = trainer._prepare(b, mini, k)
            if not denom:  # the valid rows, staged with the step's scalars
                assert float(trainer._row_w) == 2.0
            with host_io_forbidden():
                got.append(trainer._device_step(inputs, seeds, mini, k))
            trainer.step += 1  # as `train_step`: the next micro-step's seeds
    np.testing.assert_allclose([g.numpy() for g in got], [w.numpy() for w in want], rtol=1e-6)
    for (n, p), q in zip(model.named_parameters(), plain.model.parameters()):
        assert (p - q).abs().max() <= 1e-6 * max(q.abs().max(), 1.0), n


@pytest.mark.parametrize("k", [1, 2])
def test_flat_all_reduce_calls_count_the_updates_that_ran(k):
    """The counter `all_reduce.flat` grows by one for each update the grouped
    `Trainer` ran (the host part counts it: a captured step replays the
    all-reduce without calling the function), by none for a micro-step
    without an update, and by none without a group."""
    cfg, _, trainer = _trainer(k, True)
    batches = _batches(cfg, k) * 2
    before = trace.counter("all_reduce.flat")
    with one_process_gloo_group():
        for i, b in enumerate(batches):
            trainer.train_step(b)
            assert trace.counter("all_reduce.flat") - before == (i + 1) // k
        distributed.all_reduce_flat([torch.ones(3)])  # a direct call is not an update
    assert trace.counter("all_reduce.flat") - before == trainer.updates == 2
    assert not trainer.captures and trainer.graphs == 0  # the CPU never captures
    trainer.train_step(batches[0])  # no group: no all-reduce
    assert trace.counter("all_reduce.flat") - before == 2
