"""SASRec: self-attentive sequential recommendation.

PyTorch counterpart of `gamer_tpu/models/discriminative/sasrec.py` (ref:
SeqRec/models/discriminative/SASRec/model.py:69-87): item + learned position
embedding, LayerNorm + dropout, causal transformer encoder, last-state
representation scored against the item table.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.models.discriminative.base import DIS_MODELS, DisModelConfig, gather_last
from gamer_tpu_torch.modules.transformer import (
    DropoutSeeds, TransformerEncoder, attention_allowed, embedding)


@DIS_MODELS.register("SASRec")
class SASRec(nn.Module):
    def __init__(self, cfg: DisModelConfig, n_items: int, max_his_len: int,
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.n_items, self.max_his_len = cfg, n_items, max_his_len
        g = torch.Generator().manual_seed(seed)
        H = cfg.hidden_size
        self.item_embedding = embedding(n_items + 1, H, g, cfg.initializer_range)
        self.position_embedding = embedding(max_his_len, H, g, cfg.initializer_range)
        self.input_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.encoder = TransformerEncoder(cfg.n_layers, H, cfg.n_heads, cfg.inner_size,
                                          cfg.hidden_act, cfg.layer_norm_eps, g)
        self.to(device)

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward takes: the input's, then four a
        layer (`TransformerEncoderLayer`)."""
        return 1 + 4 * self.cfg.n_layers

    def uniform_shapes(self, B: int, L: int) -> list:
        """Masked-LM draws a training forward takes: none."""
        return []

    def encode_with_table(self, item_seq: torch.Tensor, seq_len: torch.Tensor,
                          batch: dict | None = None,
                          generator: Optional[torch.Generator] = None):
        """([B, H] last state, item table [n_items+1, H]); `generator` None
        means deterministic."""
        drop = DropoutSeeds(generator, self.cfg.dropout_prob)
        L = item_seq.shape[1]
        x = (self.item_embedding(item_seq.long())
             + self.position_embedding(torch.arange(L, device=item_seq.device))[None])
        x = drop(self.input_ln(x))
        x = self.encoder(x, attention_allowed(item_seq, bidirectional=False), drop)
        return gather_last(x, seq_len), self.item_embedding.weight

    def forward(self, item_seq, seq_len, batch=None, generator=None):
        return self.encode_with_table(item_seq, seq_len, batch, generator)[0]
