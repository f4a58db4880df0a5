"""Entry point of the port: the flagship Qwen3Multi training loss.

Counterpart of `__graft_entry__.py` (`_flagship_config`, `_make_batch`,
`entry`): `entry()` returns `(fn, (model, batch))` where `fn(model, batch)`
is the training loss of flagship Qwen3Multi (dropout on, seeds from a fixed
generator), differentiable in the model's parameters. Like every entry point
of the port it runs on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

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
