"""Discriminative base: configs, loss dispatch and scoring heads.

PyTorch counterpart of `gamer_tpu/models/discriminative/base.py` (ref:
SeqRec/modules/model_base/seq_model.py:8-119). Models are `nn.Module`s with
the JAX models' methods (`encode_with_table`, `hidden_states`,
`calculate_loss`, `predict_scores`; `forward` is flax's `__call__`); the
CE-over-full-table / BPR losses and full/sample-sort scoring live here as
plain functions. Plain PyTorch on the card or the CPU: the JAX package runs
no Pallas kernel in this family.

A model's constructor takes `device` (None means CUDA and raises without
it; the tests pass "cpu") and `seed`: its weights come from a CPU
`torch.Generator` seeded with it, with flax's initializers. A training
forward takes `generator`, a CPU `torch.Generator` from which it draws
its masked-LM positions and one hash-dropout seed a site in call order
(`modules/transformer.DropoutSeeds`); None means deterministic. In place
of the generator it takes the step's seed table on the device, its
masked-LM draws then handed over (`uniforms=`): `training_draws` draws both
from a generator on the host, as the forward would, for a step whose device
part reads them from static buffers. Each model states how many seeds
(`dropout_sites`) and which uniforms (`uniform_shapes`) its forward takes.

Batch contract (ref SMB_dis_dataset.py:318-338): item ids are +1 shifted so
0 is the padding index; `seq_len` counts real events.
"""

from __future__ import annotations

from typing import Optional

import torch

from gamer_tpu_torch.core.config import Config, config_field
from gamer_tpu_torch.core.registry import Registry
from gamer_tpu_torch.modules.losses import bpr_loss, sequence_ce_loss
from gamer_tpu_torch.ops.seeds import draw

DIS_MODELS = Registry("discriminative model")


class DisModelConfig(Config):
    n_layers: int = 2
    n_heads: int = 2
    hidden_size: int = 64
    inner_size: int = 256
    dropout_prob: float = 0.5
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    loss_type: str = "CE"  # or BPR
    # BERT4Rec
    mask_ratio: float = 0.2
    ft_ratio: float = 0.5
    # GRU4Rec
    embedding_size: int = 64
    # MBHT (ref config/dis-models/MBHT/config.json)
    enable_hg: bool = True
    enable_ms: bool = True
    hyper_len: int = 6
    scales: list = config_field([5, 4, 20])
    # MBSTR (ref MBSTR/config.py)
    num_buckets: int = 32
    max_distance: int = 40
    behavior_head: bool = True
    behavior_attention: bool = True
    behavior_moe: bool = True
    behavior_position_bias: bool = True
    n_shared_experts: int = 3
    n_specific_experts: int = 1
    # shared geometry
    n_behaviors: int = 3
    n_users: int = 0


def gather_last(output: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    """[B, L, H], [B] -> [B, H] at position seq_len-1 (ref seq_model.py:44-48)."""
    idx = torch.clamp(seq_len.long() - 1, 0, output.shape[1] - 1)
    return output[torch.arange(output.shape[0], device=output.device), idx]


def uniform_draw(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) of `shape` from the CPU `generator`, on `device` (the
    masked-LM draws; JAX draws them with `jax.random.uniform`). A forward
    given a seed table instead of a generator must be handed its draws
    (`training_draws`)."""
    if not isinstance(generator, torch.Generator):
        raise ValueError("a training forward needs a torch.Generator for its random draws, or "
                         "its draws handed over (`uniforms=`)")
    return torch.rand(shape, generator=generator).to(device)


def training_draws(model, B: int, L: int, generator: torch.Generator) -> dict:
    """The host draws of one training forward of `model` on a [B, L] batch,
    from `generator` in the order that forward draws them from it: the
    masked-LM uniforms of `model.uniform_shapes(B, L)` ("uniform_0", ...),
    then the int32 seed table of its `dropout_sites` sites ("seeds"). CPU
    tensors, to be staged; `draw_uniforms` gives a forward's `uniforms=`."""
    out = {f"uniform_{i}": torch.rand(shape, generator=generator)
           for i, shape in enumerate(model.uniform_shapes(B, L))}
    out["seeds"] = draw(generator, model.dropout_sites).to(torch.int32)
    return out


def draw_uniforms(draws: dict):
    """The `uniforms=` of a forward from its staged `training_draws`: None,
    the one [B, L] tensor, or BERT4Rec's (rows, mask) pair."""
    us = [draws[k] for k in sorted(draws) if k.startswith("uniform_")]
    return None if not us else us[0] if len(us) == 1 else tuple(us)


def range_mask(scores: torch.Tensor, item_range) -> torch.Tensor:
    """Scores outside [lo, hi) of the item axis set to -inf."""
    if item_range is None:
        return scores
    ids = torch.arange(scores.shape[-1], device=scores.device)
    ok = (ids >= item_range[0]) & (ids < item_range[1])
    return torch.where(ok[None], scores, -torch.inf)


def dis_calculate_loss(model, batch: dict, generator: Optional[torch.Generator],
                       loss_type: str, n_items: int) -> torch.Tensor:
    """CE over the full item table or BPR with one sampled negative
    (ref seq_model.py:64-82), for the models with `encode_with_table`."""
    seq_out, item_table = model.encode_with_table(batch["inputs"], batch["seq_len"], batch,
                                                  generator=generator)
    valid = batch.get("row_valid")
    valid = valid == 1 if valid is not None else None
    if loss_type == "BPR":
        pos = item_table[batch["target"].long()]
        neg = item_table[batch["neg_item"].long()]
        return bpr_loss((seq_out * pos).sum(-1), (seq_out * neg).sum(-1), valid)
    return sequence_ce_loss(seq_out @ item_table.T, batch["target"], valid)


def full_sort_scores(seq_out: torch.Tensor, item_table: torch.Tensor,
                     item_range: tuple[int, int] | None = None,
                     n_items: int | None = None) -> torch.Tensor:
    """[B, H] x [n_items+1, H] -> [B, n_items+1] (ref seq_model.py:104-119).
    With item_range, scores outside the window are -inf."""
    return range_mask(seq_out @ item_table.T, item_range)


def sample_sort_scores(seq_out: torch.Tensor, item_table: torch.Tensor,
                       candidates: torch.Tensor) -> torch.Tensor:
    """[B, H], [B, C] candidate ids -> [B, C] (ref seq_model.py:93-102)."""
    emb = item_table[candidates.long()]  # [B, C, H]
    return torch.einsum("bch,bh->bc", emb, seq_out)
