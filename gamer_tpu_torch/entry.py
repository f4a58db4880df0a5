"""Entry point of the port: the flagship Qwen3Multi training loss.

Counterpart of `__graft_entry__.py` (`_flagship_config`, `_make_batch`,
`entry`, `dryrun_multichip`): `entry()` returns `(fn, (model, batch))` where
`fn(model, batch)` is the training loss of flagship Qwen3Multi (dropout on,
seeds from a fixed generator), differentiable in the model's parameters.
`dryrun_multiprocess(n)` runs the sharded pipeline in n processes on gloo,
on a (data, model) mesh as `dryrun_multichip` builds it. Like every entry point of the port they run on CUDA unless the caller
passes `device="cpu"`.

    python -m gamer_tpu_torch.entry <out_dir> <device> <model axis>   # one dry-run worker
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from gamer_tpu_torch.models.generative.qwen_family import (
    QwenFamilyConfig, QwenFamilyModel, build_config)


def flagship_config(tiny: bool = False, **overrides) -> QwenFamilyConfig:
    """Flagship GAMER scale (config/s2s-models/Qwen3Multi/config.json with
    the 1024-code + 17-token vocabulary), or the tiny shapes of the JAX
    entry's tiny config."""
    if tiny:
        kw = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, intermediate_size=96, dropout_rate=0.0,
                  num_positions=5, num_experts=6, num_behavior=3, behavior_embedding_dim=16,
                  behavior_base=14, model_max_length=256)
    else:
        kw = dict(vocab_size=1024 + 17, hidden_size=256, num_hidden_layers=8,
                  num_attention_heads=6, num_key_value_heads=3, head_dim=64,
                  intermediate_size=512, dropout_rate=0.0, num_positions=5, num_experts=6,
                  num_behavior=3, behavior_embedding_dim=64, behavior_base=14,
                  model_max_length=1024)
    kw.update(overrides)
    return build_config("Qwen3Multi", **kw)


def make_batch(cfg: QwenFamilyConfig, batch_size: int, blocks: int,
               rng: np.random.Generator | None = None) -> dict:
    """A batch of `blocks` whole item blocks [<behavior>, codes] a row, no
    padding, as numpy arrays."""
    rng = rng or np.random.default_rng(0)
    P = cfg.num_positions
    S = blocks * P
    ids = rng.integers(cfg.behavior_base + cfg.num_behavior, cfg.vocab_size,
                       (batch_size, S)).astype(np.int32)
    ids[:, ::P] = rng.integers(cfg.behavior_base, cfg.behavior_base + cfg.num_behavior,
                               (batch_size, blocks))
    sessions = np.repeat(np.sort(rng.integers(0, 5, (batch_size, blocks)), axis=1), P, axis=1)
    actions = np.repeat(rng.integers(1, 4, (batch_size, blocks)), P, axis=1)
    return {
        "input_ids": ids,
        "attention_mask": np.ones((batch_size, S), np.int32),
        "session_ids": sessions.astype(np.int32),
        "actions": actions.astype(np.int32),
        "extended_session_ids": np.arange(S, dtype=np.int32)[None].repeat(batch_size, 0),
        "labels": ids.copy(),
        "row_valid": np.ones((batch_size,), np.int32),
    }


def entry(tiny: bool = False, device: str | torch.device | None = None):
    """(fn, (model, batch)): fn(model, batch) is the flagship training loss
    (batch 8 x 20 blocks), differentiable in model's parameters."""
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    cfg = flagship_config(tiny)
    model = QwenFamilyModel(cfg, device=device)
    batch = make_batch(cfg, batch_size=8, blocks=20)

    def fn(model: QwenFamilyModel, batch: dict) -> torch.Tensor:
        loss_fn = make_loss_fn(model, model.cfg, deterministic=False)
        return loss_fn(batch, torch.Generator().manual_seed(0))[0]

    return fn, (model, batch)


def dryrun_config(model_axis: int) -> QwenFamilyConfig:
    """The dry run's tiny flagship: remat on, dropout 0.2, fp32; on a model
    axis the vocab grows by 3 (odd) and pads to a multiple of 8 x model_axis,
    so the table really splits (as `dryrun_multichip`)."""
    cfg = flagship_config(tiny=True, dropout_rate=0.2, remat=True, dtype="float32")
    if model_axis > 1:
        from gamer_tpu_torch.core.mesh import pad_to_multiple

        cfg = cfg.replace(vocab_size=cfg.vocab_size + 3,
                          padded_vocab_size=pad_to_multiple(cfg.vocab_size + 3, 8 * model_axis))
    return cfg


def _dryrun(device, model_axis: int = 1) -> dict:
    """Two gradient-accumulated `Trainer` micro-steps (one update) of
    `dryrun_config(model_axis)` on global batches of 4 rows x 4 blocks, this
    process feeding its data index's rows of each and holding its model
    index's blocks of the table and experts; then a 4-beam search with the
    trained parameters. Returns losses, codes and scores as lists (one
    process runs the whole model on the whole batches)."""
    from gamer_tpu_torch.core import distributed, trace
    from gamer_tpu_torch.core.mesh import MeshContext, default_mesh, local_batch_size
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.decode.trie import LeveledTrie
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    rows, blocks = 4, 4
    grouped = distributed.process_count() > 1
    ctx = MeshContext(default_mesh(model=model_axis if grouped else 1), device=device)
    lb = local_batch_size(rows, ctx)
    r0 = ctx.first_row(lb)
    cfg = dryrun_config(model_axis)
    model = ctx.shard_params(QwenFamilyModel(cfg, device=ctx.device, seed=0))
    if ctx.n_model > 1:
        assert model.embed_tokens.weight.shape[0] == cfg.padded_vocab_size // ctx.n_model, (
            "vocab table not split on the model axis")
    trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                      OptimizerConfig(total_steps=10),
                      TrainLoopConfig(epochs=1, save_checkpoints=False,
                                      gradient_accumulation_steps=2))
    rng = np.random.default_rng(0)
    losses = []
    calls = trace.counter("all_reduce.model")
    for _ in range(2):  # two micro-steps = one accumulation cycle
        batch = make_batch(cfg, rows, blocks, rng)
        local = {k: v[r0:r0 + lb] for k, v in batch.items()}
        losses.append(float(trainer.train_step(ctx.shard_batch(local))))
    assert trainer.updates == 1 and np.isfinite(losses).all(), losses
    train_collectives = trace.counter("all_reduce.model") - calls

    P = cfg.num_positions
    L, size = P - 1, 16
    codes = np.random.default_rng(1).integers(0, size, (12, L))
    bases = [cfg.behavior_base + cfg.num_behavior + lvl * size for lvl in range(L)]
    trie = LeveledTrie.build(codes, [size] * L, bases)
    dbatch = make_batch(cfg, rows, 3, np.random.default_rng(2))
    dbatch["prompt_len"] = np.full((rows,), 3 * P, np.int32)
    search = make_beam_search_fn(model, trie, BeamSearchConfig(num_beams=4))
    out_codes, scores = search(ctx.shard_batch(dbatch), 1)
    return {"losses": losses, "codes": out_codes.cpu().tolist(),
            "scores": scores.float().cpu().tolist(),
            "process_count": distributed.process_count(),
            "mesh": [ctx.n_data, ctx.n_model], "model_collectives": train_collectives}


def _dryrun_worker(out_dir: str, device: str, model_axis: str) -> None:
    """One process of `dryrun_multiprocess`: joins the group its GAMER_*
    variables configure and writes its `_dryrun` result."""
    from gamer_tpu_torch.core import distributed

    distributed.maybe_initialize(device=device, backend="gloo")
    try:
        result = _dryrun(device, int(model_axis))
        with open(os.path.join(out_dir, f"rank{distributed.process_index()}.json"), "w") as f:
            json.dump(result, f)
    finally:
        distributed.shutdown()


def dryrun_multiprocess(n: int, model: int | None = None,
                        device: str | torch.device | None = None,
                        timeout_s: float = 300.0) -> dict:
    """The sharded pipeline in `n` processes on gloo, on a (n // model,
    model) mesh; `model=None` takes JAX's rule (model 2 when n is even, as
    `dryrun_multichip`). Each process runs `_dryrun` on its data index's
    rows of the same global batches with its model index's blocks, then the
    same search. Every process's codes must equal those of one process fed
    the whole global batches with the whole model (run here), its scores
    agree within 1e-4 and its losses within 1e-5. Raises on a failed or
    late worker. Returns the one-process result."""
    from gamer_tpu_torch.core.device import resolve_device
    from gamer_tpu_torch.core.distributed import spawn_local

    if model is None:
        model = 2 if n % 2 == 0 and n >= 2 else 1
    dev = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as out:
        spawn_local([["-m", "gamer_tpu_torch.entry", out, dev, str(model)]] * n,
                    backend="gloo", timeout_s=timeout_s)
        results = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                results.append(json.load(f))
    single = _dryrun(dev, model)
    for r, res in enumerate(results):
        assert res["process_count"] == n and res["mesh"] == [n // model, model], res["mesh"]
        np.testing.assert_array_equal(res["codes"], single["codes"],
                                      err_msg=f"process {r}: codes differ from one process's")
        np.testing.assert_allclose(res["scores"], single["scores"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(res["losses"], single["losses"], rtol=1e-5)
    print(f"dryrun_multiprocess({n}): mesh {n // model}x{model}, losses {single['losses']} "
          f"over {n} gloo processes = one process's; decode codes equal, scores within 1e-4; "
          f"{results[0]['model_collectives']} model-group collectives in the two micro-steps",
          flush=True)
    return single


if __name__ == "__main__":
    _dryrun_worker(sys.argv[1], sys.argv[2], sys.argv[3])
