"""train_SMB_decoder: the scoring loss of the flagship GAMER pipeline.

PyTorch counterpart of `use_fused_ce` and `make_loss_fn` in
`gamer_tpu/tasks/train_smb_decoder.py`: the temperature-scaled causal-LM loss
of a batch and its valid-target count, either the training loss (dropout on,
differentiable; `train/loop.Trainer` consumes it) or the eval loss (dropout
off, no grad). The data plane and the CLI are not ported yet.
"""

from __future__ import annotations

import torch

from gamer_tpu_torch.models.generative.qwen_family import (
    QwenFamilyConfig, QwenFamilyModel, prepare_train_inputs)
from gamer_tpu_torch.modules.losses import (
    causal_lm_loss_with_denom, fused_causal_lm_loss_with_denom)


def use_fused_ce(cfg: QwenFamilyConfig) -> bool:
    """The fused tied-head CE applies when the head is tied and `ce_impl`
    is not "jnp"."""
    return cfg.tie_word_embeddings and cfg.ce_impl != "jnp"


def make_loss_fn(model: QwenFamilyModel, cfg: QwenFamilyConfig | None = None,
                 deterministic: bool = True):
    """Returns loss_fn(batch, generator=None) -> (loss, {"denom": valid-target
    count}).

    `deterministic=False` is the training loss: dropout on, its seeds drawn
    from `generator` (a CPU `torch.Generator`), differentiable in the
    model's parameters. `deterministic=True` is the eval loss: dropout off,
    no grad. `batch` holds [B, S] `input_ids`, `attention_mask`, `labels`
    (and, per preset, `session_ids`, `actions`, `extended_session_ids`,
    `row_valid`), as tensors or numpy arrays; they move to the model's
    device."""
    cfg = cfg or model.cfg
    fused = use_fused_ce(cfg)

    def loss_fn(batch: dict, generator: torch.Generator | None = None):
        with torch.set_grad_enabled(not deterministic and torch.is_grad_enabled()):
            return _loss(batch, generator)

    def _loss(batch: dict, generator):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        inputs = prepare_train_inputs(cfg, batch)
        out = model(**inputs, route_mode="periodic", return_hidden=fused,
                    deterministic=deterministic, generator=generator)
        if fused:
            table = model.lm_table().to(cfg.torch_dtype)
            loss, denom = fused_causal_lm_loss_with_denom(
                out["hidden"], table, batch["labels"], cfg.temperature, batch.get("row_valid"))
        else:
            loss, denom = causal_lm_loss_with_denom(
                out["logits"], batch["labels"], cfg.temperature, batch.get("row_valid"))
        return loss, {"denom": denom}

    return loss_fn
