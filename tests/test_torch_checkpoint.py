"""The port's checkpoints on the CPU: `core/checkpoint.CheckpointManager`
round-trips bit for bit (parameters, optimizer moments and count, nested
trees, bf16), `Trainer` writes "best" / "last" / "last_state" and resumes
from "last_state" exactly, and the counterpart of
tests/test_e2e_smb.py::test_resume_and_snapshots through the CLI: resume
continues from last_state's epoch and snapshots keep the newest two."""

import os

import numpy as np
import pytest
import torch

from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
from gamer_tpu_torch.entry import flagship_config, make_batch
from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
from gamer_tpu_torch.train.state import OptimizerConfig
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)


def _trainer(tmp_path, **loop):
    cfg = flagship_config(tiny=True, dropout_rate=0.1)
    model = QwenFamilyModel(cfg, device="cpu", seed=0)
    return Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                   OptimizerConfig(learning_rate=1e-3, total_steps=20),
                   TrainLoopConfig(seed=0, gradient_accumulation_steps=2, **loop),
                   output_dir=str(tmp_path)), cfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_manager_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, generator=g), "b": {"c": torch.randn(5, generator=g).bfloat16(),
                                                       "n": 7}, "step": 12}
    mgr = CheckpointManager(str(tmp_path))
    assert not mgr.exists("best") and mgr.metadata("best") is None
    mgr.save("best", tree, {"epoch": 3, "metric": 1.5})
    again = mgr.restore("best")
    assert mgr.exists("best") and mgr.metadata("best") == {"epoch": 3, "metric": 1.5}
    for (k, want), got in zip(_flat(tree).items(), _flat(again).values()):
        if torch.is_tensor(want):
            assert got.dtype == want.dtype and torch.equal(got, want), k
        else:
            assert got == want, k
    mgr.save("best", {"a": torch.zeros(1)})  # overwrite in place
    assert torch.equal(mgr.restore("best")["a"], torch.zeros(1))


def test_train_state_round_trips_and_resumes_exactly(tmp_path):
    """Three micro-steps (one update and half an accumulation cycle), saved
    as "last_state" and restored into a fresh trainer: parameters, Adam
    moments, update count, micro-step and the pending accumulator are
    bit-identical, and the next two steps give bit-identical parameters."""
    cfg = flagship_config(tiny=True)
    batches = [make_batch(cfg, 2, 6, np.random.default_rng(s)) for s in range(5)]
    a, _ = _trainer(tmp_path / "a")
    for b in batches[:3]:
        a.train_step(b)
    a.ckpt.save("last_state", a.train_state(), {"epoch": 0})
    b_, _ = _trainer(tmp_path / "b")
    b_.load_train_state(a.ckpt.restore("last_state"))
    want, got = _flat(a.train_state()), _flat(b_.train_state())
    assert sorted(want) == sorted(got) and any("/opt/mu/" in k for k in want)
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    for b in batches[3:]:
        a.train_step(b)
        b_.train_step(b)
    for (n, p), q in zip(a.model.named_parameters(), b_.model.parameters()):
        assert torch.equal(p, q), n


def test_trainer_writes_best_last_and_reads_best(tmp_path):
    cfg = flagship_config(tiny=True)
    train = [make_batch(cfg, 2, 6, np.random.default_rng(s)) for s in range(2)]
    trainer, cfg = _trainer(tmp_path, epochs=2, patience=0)
    eval_loss = make_loss_fn(trainer.model, cfg, deterministic=True)
    trainer.eval_loss_fn = eval_loss
    res = trainer.fit(lambda epoch: iter(train), lambda: iter(train[:1]))
    for tag in ("best", "last", "last_state"):
        assert trainer.ckpt.exists(tag), tag
    best = trainer.ckpt.metadata("best")
    assert best["metric"] == pytest.approx(res["best_metric"])
    # best_params reads the "best" checkpoint, whose eval loss is the best metric
    model = QwenFamilyModel(cfg, device="cpu", seed=1)
    model.load_state_dict(trainer.best_params())
    loss, _ = make_loss_fn(model, cfg, deterministic=True)(train[0])
    assert float(loss) == pytest.approx(res["best_metric"], rel=1e-6)


def test_resume_and_snapshots(tmp_path):
    from gamer_tpu_torch.__main__ import main

    write_synthetic_dataset(str(tmp_path / "data"), "Demo", SyntheticSpec(
        n_users=30, n_items=40, num_levels=2, level_sizes=(8, 10), min_len=6, max_len=16,
        seed=11))
    out = tmp_path / "resume_ckpt"
    args = ["train_SMB_decoder", "--dataset", "Demo", "--data_path", tmp_path / "data",
            "--tasks", "smb_explicit_decoder", "--backbone", "Qwen3",
            "--max_his_len", 6, "--batch_size", 8, "--n_layers", 1,
            "--hidden_size", 16, "--model_max_length", 128,
            "--output_dir", out, "--save_epochs", 1, "--device", "cpu"]
    r1 = main([str(a) for a in args + ["--epochs", 2]])
    assert (out / "last_state").exists()
    snaps = [d for d in os.listdir(out) if d.startswith("epoch_") and not d.endswith(".json")]
    assert len(snaps) == 2  # limit
    r2 = main([str(a) for a in args + ["--epochs", 4, "--resume_from_checkpoint"]])
    # resumed training continued past the first run's step count, from epoch 2
    assert r2["steps"] > r1["steps"]
    assert [h["epoch"] for h in r2["history"]] == [2, 3]
    snaps = sorted(d for d in os.listdir(out) if d.startswith("epoch_") and "." not in d)
    assert snaps == ["epoch_2", "epoch_3"]
