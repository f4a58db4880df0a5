"""The port's multi-process data parallelism (`core/distributed.py`,
`core/mesh.py`, the group reductions of `train/loop.Trainer`, the global
dropout coordinates, the sharded tasks), on gloo on the CPU:

- `shard_examples` stride and truncation; the rendezvous precedence; an
  unconfigured `maybe_initialize` creates no group;
- two processes against one over the same global batches of a tiny
  Qwen3Multi with unequal valid-token counts per process, at dropout 0 and
  0.2: train losses and eval loss at 1e-5, as `tests/test_multihost.py`,
  and the parameters after two SGD updates at 1e-5, the two processes'
  parameters bit-identical;
- the row offsets of the dropout seeds give the JAX package's masks of the
  global batch bit for bit (residual, attention, MoE hashes);
- `test_SMB_decoder` striped over two processes gives one process's metrics;
- `entry.dryrun_multiprocess(2)`.

Run as a script, this file is one worker process:
`python tests/test_torch_distributed.py <mode> <out_dir>` with the GAMER_*
rendezvous variables set.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
WORKER_TIMEOUT_S = 240  # each worker's, and its group's timeout
DROPOUTS = (0.0, 0.2)
SPEC = dict(n_users=24, n_items=40, n_clusters=4, num_levels=2, level_sizes=(8, 10), min_len=6,
            max_len=14, seed=5)


def _global_batches(cfg, n: int, rows: int = 4, blocks: int = 4, seed: int = 0):
    """`n` global batches whose halves (the two processes' rows) hold
    unequal numbers of valid targets: rows 2 and 3 lose most labels, and a
    padding row (row_valid 0) sits in the second half."""
    from gamer_tpu_torch.entry import make_batch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = make_batch(cfg, rows, blocks, rng)
        b["labels"][2, :12] = -100
        b["labels"][3, 3:17] = -100
        b["row_valid"][3] = 0
        out.append(b)
    return out


def _train_run(dropout: float) -> dict:
    """4 `Trainer` micro-steps (2 updates of 2) and an eval of the tiny
    Qwen3Multi on `_global_batches`; under a group each process feeds its
    half of every batch. Returns the losses, the eval loss and the final
    parameters (flat, and a digest of their bytes)."""
    from gamer_tpu_torch.core import distributed
    from gamer_tpu_torch.entry import flagship_config
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = flagship_config(tiny=True, dtype="float32", dropout_rate=dropout)
    model = QwenFamilyModel(cfg, device="cpu", seed=0)
    trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                      # SGD: the parameters' change is lr x the summed grads (Adam
                      # would turn last-bit differences of near-zero grads, e.g.
                      # rare tokens' embedding rows, into steps of lr)
                      OptimizerConfig(optim="sgd", learning_rate=0.5, weight_decay=0.0,
                                      lr_scheduler_type="constant", total_steps=4),
                      TrainLoopConfig(save_checkpoints=False, gradient_accumulation_steps=2),
                      eval_loss_fn=make_loss_fn(model, cfg, deterministic=True))
    n, r = distributed.process_count(), distributed.process_index()
    local = lambda b: {k: v[r * len(v) // n:(r + 1) * len(v) // n] for k, v in b.items()}
    losses = [float(trainer.train_step(local(b))) for b in _global_batches(cfg, 4)]
    eval_loss = trainer.evaluate([local(b) for b in _global_batches(cfg, 2, seed=1)])
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()
    return {"losses": losses, "eval_loss": eval_loss, "params": flat.tolist(),
            "digest": hashlib.sha256(flat.tobytes()).hexdigest(), "count": n}


def _write_dataset(root: str) -> str:
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset

    data = os.path.join(root, "data")
    write_synthetic_dataset(data, "Synth", SyntheticSpec(**SPEC))
    return data


def _test_args(data: str, ckpt: str, results: str) -> list[str]:
    return ["test_SMB_decoder", "--dataset", "Synth", "--data_path", data, "--max_his_len", "10",
            "--test_task", "smb_explicit", "--ckpt_path", ckpt, "--num_beams", "4",
            "--test_batch_size", "8", "--results_file", results, "--device", "cpu"]


def _worker(mode: str, out: str) -> None:
    """One process of a group: its `mode`'s result in out/rank<r>.json."""
    torch.set_num_threads(1)
    from gamer_tpu_torch.core import distributed

    if mode == "test_smb":  # the task starts the group itself (Task.invoke)
        from gamer_tpu_torch.__main__ import main

        with open(os.path.join(out, "paths.json")) as f:
            paths = json.load(f)
        result = main(_test_args(paths["data"], paths["ckpt"],
                                 os.path.join(out, "results.json")))
    else:
        assert distributed.maybe_initialize(device="cpu")
        result = {str(d): _train_run(d) for d in DROPOUTS}
    with open(os.path.join(out, f"rank{distributed.process_index()}.json"), "w") as f:
        json.dump(result, f)
    distributed.shutdown()


def _spawn(n: int, mode: str, out: str) -> list[dict]:
    """`n` worker processes of this file in one gloo group; their results."""
    from gamer_tpu_torch.core.distributed import spawn_local

    spawn_local([[THIS, mode, out]] * n, cwd=out, timeout_s=WORKER_TIMEOUT_S)
    results = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- bootstrap


def test_shard_examples_stride_and_truncation():
    from gamer_tpu_torch.core.distributed import shard_examples

    ex = list(range(10))
    shards = [shard_examples(ex, index=i, count=3) for i in range(3)]
    assert [len(s) for s in shards] == [3, 3, 3]  # the same step count everywhere
    assert shards[1] == [1, 4, 7]
    assert len(set(sum(shards, []))) == 9  # disjoint
    assert shard_examples(ex, index=0, count=1) == ex
    assert shard_examples(ex) == ex  # no group: everything


def test_maybe_initialize_unconfigured_creates_no_group(monkeypatch):
    import torch.distributed as dist

    from gamer_tpu_torch.core import distributed

    for k in ("GAMER_COORDINATOR", "GAMER_NUM_PROCESSES", "GAMER_PROCESS_ID", "MASTER_ADDR",
              "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    # "cuda" (the tasks' default) too: unconfigured, CUDA is never asked for
    for device in (None, "cuda", "cpu"):
        assert distributed.maybe_initialize(device=device) is False
    assert not dist.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.first_row(8) == 0


def test_rendezvous_precedence(monkeypatch):
    from gamer_tpu_torch.core.distributed import _rendezvous

    monkeypatch.setenv("MASTER_ADDR", "torchrun-host")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    for k in ("GAMER_COORDINATOR", "GAMER_NUM_PROCESSES", "GAMER_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert _rendezvous(None, None, None) == ("torchrun-host:1234", 4, 3)
    monkeypatch.setenv("GAMER_COORDINATOR", "gamer-host:99")
    monkeypatch.setenv("GAMER_NUM_PROCESSES", "2")
    monkeypatch.setenv("GAMER_PROCESS_ID", "1")
    assert _rendezvous(None, None, None) == ("gamer-host:99", 2, 1)
    assert _rendezvous("kw-host:7", 8, 5) == ("kw-host:7", 8, 5)


def test_mesh_context_data_axis_only():
    from gamer_tpu_torch.core.mesh import MeshContext, local_batch_size, pad_to_multiple

    ctx = MeshContext(device="cpu")
    assert (ctx.n_data, ctx.n_model) == (1, 1)
    batch = ctx.shard_batch({"x": np.arange(6).reshape(2, 3)})
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
    assert local_batch_size(8, ctx) == 8 and pad_to_multiple(1041, 8) == 1048
    # one process: a 1 x 1 mesh; a model axis needs the processes to fill it
    from gamer_tpu_torch.core.mesh import ProcessMesh, default_mesh

    assert ctx.mesh == ProcessMesh(1, 1) and (ctx.data_index, ctx.model_index) == (0, 0)
    assert default_mesh(model=2, processes=4) == ProcessMesh(2, 2)
    assert ProcessMesh(2, 2).coords(3) == (1, 1) and ProcessMesh(2, 2).model_ranks(1) == [2, 3]
    with pytest.raises(ValueError, match="mesh 1x2 != 1 processes"):
        MeshContext(ProcessMesh(1, 2), device="cpu")


# --------------------------------------------------------------------------- dropout masks


def _jax_mask(kind: str, seed: int, B: int, S: int, rate: float) -> np.ndarray:
    """The JAX package's keep mask of the whole global batch."""
    import jax.numpy as jnp

    from gamer_tpu.modules.dropout import _hash_keep_mask, keep_threshold
    from gamer_tpu.ops.pallas_attention import dropout_keep_tile

    if kind == "residual":  # [B, S, D]: the flat index over the global array
        threshold, _ = keep_threshold(rate, bits=32)
        return np.asarray(_hash_keep_mask(jnp.uint32(seed), (B, S, 16), B * S * 16, threshold))
    if kind == "attention":  # [B, H, S, S]: the kernel's (b * H + h, row, col)
        return np.stack([np.stack([np.asarray(dropout_keep_tile(
            jnp.uint32(seed), b * 3 + h, 0, 0, (S, S), rate)) for h in range(3)])
            for b in range(B)])
    # MoE [P, T, F] with T = B * n: the kernel's (expert p, row t, column f)
    P, n = 5, S // 5
    return np.stack([np.asarray(dropout_keep_tile(jnp.uint32(seed), p, 0, 0, (B * n, 12), rate))
                     for p in range(P)])


def _port_mask(kind: str, seed: int, rows: int, row0: int, S: int, rate: float) -> np.ndarray:
    """The port's keep mask of `rows` local rows that start at global row
    `row0`, through the seed offset each call site applies."""
    from gamer_tpu_torch.modules.dropout import attention_row_seed, hash_dropout, row_seed
    from gamer_tpu_torch.ops.fused_attention import attention_keep_mask
    from gamer_tpu_torch.ops.fused_moe import moe_keep_mask

    if kind == "residual":
        return (hash_dropout(torch.ones(rows, S, 16), seed, rate, row0) != 0).numpy()
    if kind == "attention":
        return attention_keep_mask(attention_row_seed(seed, row0, 3), rows, 3, S, S,
                                   rate).numpy()
    n = S // 5
    return moe_keep_mask(row_seed(seed, row0, n) if row0 else seed, 5, rows * n, 12,
                         rate).numpy()


@pytest.mark.parametrize("kind", ["residual", "attention", "moe"])
def test_row_offsets_give_the_global_masks_of_jax(kind):
    B, S, rate, seed = 6, 20, 0.2, 1_234_567
    want = _jax_mask(kind, seed, B, S, rate)
    for rows, row0 in ((2, 0), (2, 2), (2, 4), (3, 3)):
        got = _port_mask(kind, seed, rows, row0, S, rate)
        if kind == "moe":  # rows t of the local slice are global rows row0 * n + t
            n = S // 5
            np.testing.assert_array_equal(got, want[:, row0 * n:(row0 + rows) * n])
        else:
            np.testing.assert_array_equal(got, want[row0:row0 + rows])
    # without the offset a second process would repeat the first one's mask
    assert (_port_mask(kind, seed, 2, 0, S, rate) != want[2:4] if kind != "moe"
            else _port_mask(kind, seed, 2, 0, S, rate) != want[:, 8:16]).any()


# --------------------------------------------------------------------------- two processes


@pytest.fixture(scope="module")
def two_process_training(tmp_path_factory):
    torch.set_num_threads(1)
    results = _spawn(2, "train", str(tmp_path_factory.mktemp("mp_train")))
    return results, {str(d): _train_run(d) for d in DROPOUTS}


@pytest.mark.parametrize("dropout", DROPOUTS)
def test_two_processes_train_like_one(two_process_training, dropout):
    results, single = two_process_training
    multi = [r[str(dropout)] for r in results]
    one = single[str(dropout)]
    assert [m["count"] for m in multi] == [2, 2] and one["count"] == 1
    # the processes' parameters are bit-identical after every update
    assert multi[0]["digest"] == multi[1]["digest"]
    for m in multi:
        np.testing.assert_allclose(m["losses"], one["losses"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m["eval_loss"], one["eval_loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m["params"], one["params"], rtol=1e-5, atol=1e-6)


def test_two_process_test_smb_decoder_matches_one(tmp_path):
    from gamer_tpu_torch.__main__ import main

    data = _write_dataset(str(tmp_path))
    ckpt = str(tmp_path / "ckpt")
    main(["train_SMB_decoder", "--dataset", "Synth", "--data_path", data, "--max_his_len", "10",
          "--tasks", "smb_explicit_decoder_2", "--batch_size", "8", "--epochs", "1",
          "--n_layers", "1", "--hidden_size", "16", "--output_dir", ckpt, "--device", "cpu"])
    one = main(_test_args(data, ckpt, str(tmp_path / "one.json")))
    out = tmp_path / "mp"
    out.mkdir()
    (out / "paths.json").write_text(json.dumps({"data": data, "ckpt": ckpt}))
    multi = _spawn(2, "test_smb", str(out))
    assert sum(one["counts"].values()) > 8  # more rows than one chunk
    for res in multi:
        assert res["counts"] == one["counts"]
        for b, metrics in one["per_behavior"].items():
            np.testing.assert_allclose([res["per_behavior"][b][k] for k in metrics],
                                       list(metrics.values()), rtol=1e-6, atol=1e-6)
        for k, v in one["merged"].items():
            assert abs(res["merged"][k] - v) <= 1e-6, (k, res["merged"][k], v)
    saved = json.loads((out / "results.json").read_text())  # written by process 0
    assert saved["counts"] == one["counts"]


def test_dryrun_multiprocess_two_processes():
    """The data axis alone (data 2 x model 1); the model axis is in
    `tests/test_torch_model_axis.py`."""
    from gamer_tpu_torch.entry import dryrun_multiprocess

    result = dryrun_multiprocess(2, model=1, device="cpu", timeout_s=WORKER_TIMEOUT_S)
    assert len(result["losses"]) == 2 and np.isfinite(result["losses"]).all()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
