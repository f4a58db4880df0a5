"""BERT4Rec: bidirectional masked-item sequential recommendation.

PyTorch counterpart of `gamer_tpu/models/discriminative/bert4rec.py` (ref:
SeqRec/models/discriminative/BERT4Rec/model.py): mask token = n_items+1,
mixed MLM/fine-tune masking controlled by ft_ratio (:70-86), output
FFN+GELU+LN and a DotProductPredictionHead with bias over n_items+1
(:51-59, transformer.py:186-215). Eval places the mask token at the last
position and scores candidates there.

The masking draws (`ft_rows`, the MLM positions) come from the caller's CPU
`torch.Generator` where JAX uses `jax.random.uniform`, which torch cannot
reproduce; `calculate_loss` also takes the uniform draws themselves, so a
test can hand over JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.models.discriminative.base import (
    DIS_MODELS, DisModelConfig, gather_last, range_mask, uniform_draw)
from gamer_tpu_torch.modules.losses import sequence_ce_loss
from gamer_tpu_torch.modules.transformer import (
    DropoutSeeds, TransformerEncoder, attention_allowed, dense, embedding)


@DIS_MODELS.register("BERT4Rec")
class BERT4Rec(nn.Module):
    def __init__(self, cfg: DisModelConfig, n_items: int, max_his_len: int,
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.n_items, self.max_his_len = cfg, n_items, max_his_len
        g = torch.Generator().manual_seed(seed)
        H = cfg.hidden_size
        self.item_embedding = embedding(n_items + 2, H, g, cfg.initializer_range)
        self.position_embedding = embedding(max_his_len, H, g, cfg.initializer_range)
        self.input_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.encoder = TransformerEncoder(cfg.n_layers, H, cfg.n_heads, cfg.inner_size,
                                          cfg.hidden_act, cfg.layer_norm_eps, g)
        self.output_ffn = dense(H, H, g)
        self.output_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.head_out = dense(H, H, g)
        self.head_bias = nn.Parameter(torch.zeros(n_items + 1))
        self.to(device)

    @property
    def mask_token(self) -> int:
        return self.n_items + 1

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward takes: the input's, then four a
        layer (`TransformerEncoderLayer`)."""
        return 1 + 4 * self.cfg.n_layers

    def uniform_shapes(self, B: int, L: int) -> list:
        """Masked-LM draws of `calculate_loss`, in draw order: the per-row
        fine-tune coin, then the MLM positions."""
        return [(B, 1), (B, L)]

    def hidden_states(self, item_seq: torch.Tensor,
                      generator: Optional[torch.Generator] = None):
        """[B, L] -> ([B, L, H] head-projected states, item table [n+2, H], bias)."""
        drop = DropoutSeeds(generator, self.cfg.dropout_prob)
        L = item_seq.shape[1]
        pos = torch.arange(L, device=item_seq.device) % self.max_his_len
        x = self.item_embedding(item_seq.long()) + self.position_embedding(pos)[None]
        x = drop(self.input_ln(x))
        x = self.encoder(x, attention_allowed(item_seq, bidirectional=True), drop)
        x = self.output_ln(F.gelu(self.output_ffn(x), approximate="tanh"))
        x = F.relu(self.head_out(x))
        return x, self.item_embedding.weight, self.head_bias

    def calculate_loss(self, item_seq: torch.Tensor, seq_len: torch.Tensor,
                       generator: Optional[torch.Generator], row_valid=None,
                       uniforms: Optional[tuple] = None) -> torch.Tensor:
        """Masked training (ref :70-86,126-132): a per-row coin decides
        fine-tune (mask position seq_len) vs MLM (random mask_ratio
        positions). `uniforms` = (u_rows [B, 1], u_mask [B, L]) in [0, 1),
        else drawn from `generator` (which also seeds the dropout)."""
        cfg = self.cfg
        B, L = item_seq.shape
        dev = item_seq.device
        if uniforms is None:
            uniforms = (uniform_draw((B, 1), generator, dev), uniform_draw((B, L), generator, dev))
        ft_rows = uniforms[0].to(dev) < cfg.ft_ratio
        last_pos = F.one_hot(torch.clamp(seq_len.long(), 0, L - 1), L).bool()
        mlm_mask = (uniforms[1].to(dev) < cfg.mask_ratio) & (item_seq != 0) & ~ft_rows
        mask = mlm_mask | (last_pos & ft_rows)
        labels = item_seq * mask
        masked_seq = torch.where(mask, self.mask_token, item_seq)
        states, table, bias = self.hidden_states(masked_seq, generator)
        logits = states @ table[: self.n_items + 1].T + bias[None, None, :]
        flat_logits = logits.reshape(-1, self.n_items + 1)
        flat_labels = labels.reshape(-1)
        valid = flat_labels != 0
        if row_valid is not None:
            valid = valid & torch.repeat_interleave(row_valid == 1, L)
        return sequence_ce_loss(flat_logits, flat_labels, valid)

    def predict_scores(self, item_seq: torch.Tensor, seq_len: torch.Tensor,
                       item_range=None) -> torch.Tensor:
        """Full-sort scores at the last (mask) position. The eval dataset has
        already appended the mask slot (ref SMB_dis_dataset.py:438-440)."""
        states, table, bias = self.hidden_states(item_seq)
        last = gather_last(states, seq_len)
        return range_mask(last @ table[: self.n_items + 1].T + bias[None, :], item_range)

    def forward(self, item_seq, seq_len, batch=None, generator=None):
        return gather_last(self.hidden_states(item_seq, generator)[0], seq_len)
