"""MBSTR: multi-behavior sequential transformer (behavior-aware attention).

PyTorch counterpart of `gamer_tpu/models/discriminative/mbstr.py` (ref:
SeqRec/models/discriminative/MBSTR/model.py + modules/layers/mbs_transformer.py):
per-behavior Q/K/V tensors selected by one-hot (ref :162-210), behavior-pair
attention mixing W1/W2 with softmax(alpha) (ref :196-242), per-behavior-pair
T5-style relative position bias (ref :10-72,130-158), behavior-MoE FFN
(ref :252-293), and a CGC prediction head (shared + behavior-specific
experts, gated; ref :331-409). Masked-item training like BERT4Rec; eval
scores the appended mask slot. Each `behavior_*` switch keeps both of its
branches. The raw parameters (`query`/`key`/`value` [b+1, H, h, d], `W1`,
`W2`, `alpha1`, `alpha2`, `rel_bias`, `w_gates`) keep JAX's layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.models.discriminative.base import (
    DIS_MODELS, DisModelConfig, gather_last, range_mask, uniform_draw)
from gamer_tpu_torch.modules.losses import sequence_ce_loss
from gamer_tpu_torch.modules.transformer import (
    DETERMINISTIC, DropoutSeeds, _act, attention_allowed, dense, embedding, normal_param)
from gamer_tpu_torch.ops.masks import NEG_INF


def behavior_pair_matrix(type_seq: torch.Tensor, n_behaviors: int) -> torch.Tensor:
    """[B, L] behavior ids (0 = pad) -> [B, L, L] pair class in [0, b*b+1)
    (ref mbs_transformer.py:306-308)."""
    t = type_seq.long()
    pair = (t[:, :, None] - 1) * n_behaviors + t[:, None, :]
    nonzero = (t[:, :, None] * t[:, None, :]) != 0
    return torch.where(nonzero, pair, 0)


def rel_pos_bucket(qlen: int, klen: int, num_buckets: int, max_distance: int,
                   device=None) -> torch.Tensor:
    """[qlen, klen] bucket of key - query; the log in float32, truncated to
    int32, as JAX computes it. The divisor's log is taken on `device` of a
    float32 fill (no copy from the host, which a CUDA graph's capture
    refuses): the value and the op of a tensor made from the Python float."""
    q = torch.arange(qlen, device=device)
    k = torch.arange(klen, device=device)
    n = -(k[None, :] - q[:, None])
    half = num_buckets // 2
    ret = (n < 0).to(torch.int32) * half
    n = n.abs()
    max_exact = half // 2
    ratio = torch.log(torch.clamp(n, min=1).float() / max_exact) / torch.log(
        torch.full((), max_distance / max_exact, dtype=torch.float32, device=device))
    large = max_exact + (ratio * (half - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=half - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), large)


class MBSAttention(nn.Module):
    def __init__(self, cfg: DisModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        b, h, H = cfg.n_behaviors, cfg.n_heads, cfg.hidden_size
        d, C, std = H // h, b * b + 1, cfg.initializer_range
        self.behavioral = cfg.behavior_attention and b > 1
        if self.behavioral:
            for name in ("query", "key", "value"):
                setattr(self, name, normal_param((b + 1, H, h, d), std, generator))
            self.W1 = normal_param((b, h, d, d), std, generator)
            self.alpha1 = normal_param((C, b, h), std, generator)
            self.W2 = normal_param((b, h, d, d), std, generator)
            self.alpha2 = normal_param((C, b, h), std, generator)
        else:
            for name in ("q", "k", "v"):
                self.add_module(name, dense(H, H, generator))
        if cfg.behavior_position_bias:
            self.rel_bias = normal_param((C, cfg.num_buckets, h), std, generator)
        self.ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, x, allowed, type_seq, drop: DropoutSeeds = DETERMINISTIC):
        cfg = self.cfg
        b, h, H = cfg.n_behaviors, cfg.n_heads, cfg.hidden_size
        d, C = H // h, b * b + 1
        B, L, _ = x.shape
        pair = behavior_pair_matrix(type_seq, b)  # [B, L, L]
        sel = F.one_hot(pair, C).to(x.dtype)  # [B, L, L, C]
        if self.behavioral:
            one_hot_t = F.one_hot(type_seq.long(), b + 1).to(x.dtype)  # [B, L, b+1]
            q = torch.einsum("BLH,bHhd,BLb->BhLd", x, self.query, one_hot_t)
            k = torch.einsum("BLH,bHhd,BLb->BhLd", x, self.key, one_hot_t)
            v = torch.einsum("BLH,bHhd,BLb->BhLd", x, self.value, one_hot_t)
            W1_ = torch.einsum("bhmn,Cbh->Chmn", self.W1, torch.softmax(self.alpha1, dim=1))
            scores_all = torch.einsum("BhQm,Chmn,BhKn->BhQKC", q, W1_, k)
            scores = torch.einsum("BhQKC,BQKC->BhQK", scores_all, sel)
        else:
            heads = lambda y: y.reshape(B, L, h, d).transpose(1, 2)
            q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
            scores = torch.einsum("BhQd,BhKd->BhQK", q, k)
        scores = scores / math.sqrt(d)
        if cfg.behavior_position_bias:
            bucket = rel_pos_bucket(L, L, cfg.num_buckets, cfg.max_distance, x.device)
            bias_all = self.rel_bias[:, bucket.long()]  # [C, L, L, h]
            scores = scores + torch.einsum("CQKh,BQKC->BhQK", bias_all, sel)
        scores = scores + torch.where(allowed, 0.0, NEG_INF)
        probs = drop(torch.softmax(scores, dim=-1))
        if self.behavioral:
            W2_ = torch.einsum("bhmn,Cbh->Chmn", self.W2, torch.softmax(self.alpha2, dim=1))
            # context = probs * onehot(pair) * W2 * v (ref :227-242)
            kv = torch.einsum("Chnm,BhKn->CBhKm", W2_, v)
            ctx = torch.einsum("BhQK,BQKC,CBhKm->BhQm", probs, sel, kv)
        else:
            ctx = torch.einsum("BhQK,BhKd->BhQd", probs, v)
        ctx = ctx.transpose(1, 2).reshape(B, L, H)
        return self.ln(drop.add(x, ctx))


class MBSLayer(nn.Module):
    def __init__(self, cfg: DisModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        H, F_ = cfg.hidden_size, cfg.inner_size
        self.act = _act(cfg.hidden_act)
        self.attn = MBSAttention(cfg, generator)
        self.moe = cfg.behavior_moe and cfg.n_behaviors > 1
        if self.moe:
            for i in range(cfg.n_behaviors):
                self.add_module(f"ffn_{i}_1", dense(H, F_, generator))
                self.add_module(f"ffn_{i}_2", dense(F_, H, generator))
        else:
            self.ffn_1 = dense(H, F_, generator)
            self.ffn_2 = dense(F_, H, generator)
        self.ffn_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, x, allowed, type_seq, drop: DropoutSeeds = DETERMINISTIC):
        cfg = self.cfg
        x = self.attn(x, allowed, type_seq, drop)
        if self.moe:  # behavior-MoE FFN (ref :252-293): per-behavior expert + one-hot select
            outs = [torch.zeros_like(x)]
            for i in range(cfg.n_behaviors):
                f = drop(self.act(getattr(self, f"ffn_{i}_1")(x)))
                outs.append(getattr(self, f"ffn_{i}_2")(f))
            sel = F.one_hot(type_seq.long(), cfg.n_behaviors + 1).to(x.dtype)
            f = torch.einsum("bBLH,BLb->BLH", torch.stack(outs, 0), sel)
        else:
            f = self.ffn_2(drop(self.act(self.ffn_1(x))))
        return self.ffn_ln(drop.add(x, f))


class CGCHead(nn.Module):
    """CGC prediction head (ref mbs_transformer.py:331-409). states [N, H]."""

    def __init__(self, cfg: DisModelConfig, n_items: int, generator: torch.Generator):
        super().__init__()
        self.cfg, self.n_items = cfg, n_items
        H = cfg.hidden_size
        if not cfg.behavior_head:
            self.head_out = dense(H, H, generator)
            self.head_bias = nn.Parameter(torch.zeros(n_items + 1))
            return
        b = cfg.n_behaviors
        for i in range(cfg.n_shared_experts):
            self.add_module(f"shared_{i}", dense(H, H, generator))
        for i in range(b * cfg.n_specific_experts):
            self.add_module(f"spec_{i}", dense(H, H, generator))
        self.w_gates = normal_param((b, H, cfg.n_shared_experts + cfg.n_specific_experts),
                               cfg.initializer_range, generator)
        self.head_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, states, type_seq, table):
        cfg = self.cfg
        if not cfg.behavior_head:
            out = F.relu(self.head_out(states))
            return out @ table[: self.n_items + 1].T + self.head_bias[None]
        b, ns = cfg.n_behaviors, cfg.n_specific_experts
        shared = [getattr(self, f"shared_{i}")(states) for i in range(cfg.n_shared_experts)]
        specific = [getattr(self, f"spec_{i}")(states) for i in range(b * ns)]
        gates = torch.softmax(torch.einsum("NH,bHE->bNE", states, self.w_gates), dim=-1)
        per_beh = [torch.einsum("ENH,NE->NH", torch.stack(shared + specific[i * ns:(i + 1) * ns]),
                                gates[i]) for i in range(b)]
        outputs = torch.stack([torch.zeros_like(states)] + per_beh)  # [b+1, N, H]
        sel = F.one_hot(type_seq.long(), b + 1).to(states.dtype)
        mixed = torch.einsum("bNH,Nb->NH", outputs, sel)
        out = states + self.head_ln(mixed)
        return out @ table[: self.n_items + 1].T


@DIS_MODELS.register("MBSTR")
class MBSTR(nn.Module):
    def __init__(self, cfg: DisModelConfig, n_items: int, max_his_len: int,
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.n_items, self.max_his_len = cfg, n_items, max_his_len
        g = torch.Generator().manual_seed(seed)
        self.item_embedding = embedding(n_items + 2, cfg.hidden_size, g, cfg.initializer_range)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", MBSLayer(cfg, g))
        self.head = CGCHead(cfg, n_items, g)
        self.to(device)

    @property
    def mask_token(self) -> int:
        return self.n_items + 1

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward takes: the input's, then a
        layer's attention probabilities and residual, its FFN activation
        (one an expert of the behavior MoE) and its FFN residual."""
        cfg = self.cfg
        ffn = cfg.n_behaviors if cfg.behavior_moe and cfg.n_behaviors > 1 else 1
        return 1 + cfg.n_layers * (3 + ffn)

    def uniform_shapes(self, B: int, L: int) -> list:
        """Masked-LM draws of `calculate_loss`: the masked positions."""
        return [(B, L)]

    def hidden_states(self, item_seq, type_seq, generator: Optional[torch.Generator] = None):
        drop = DropoutSeeds(generator, self.cfg.dropout_prob)
        x = drop(self.item_embedding(item_seq.long()))
        allowed = attention_allowed(item_seq, bidirectional=True)
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, allowed, type_seq, drop)
        return x, self.item_embedding.weight

    def calculate_loss(self, item_seq, type_seq, generator: Optional[torch.Generator],
                       row_valid=None, uniforms: Optional[torch.Tensor] = None):
        """Masked-item CE; `uniforms` [B, L] in [0, 1) pick the masked
        positions, else drawn from `generator`."""
        B, L = item_seq.shape
        if uniforms is None:
            uniforms = uniform_draw((B, L), generator, item_seq.device)
        mask = (uniforms.to(item_seq.device) < self.cfg.mask_ratio) & (item_seq != 0)
        labels = item_seq * mask
        masked_seq = torch.where(mask, self.mask_token, item_seq)
        states, table = self.hidden_states(masked_seq, type_seq, generator)
        logits = self.head(states.reshape(B * L, -1), type_seq.reshape(B * L), table)
        flat_labels = labels.reshape(-1)
        valid = flat_labels != 0
        if row_valid is not None:
            valid = valid & torch.repeat_interleave(row_valid == 1, L)
        return sequence_ce_loss(logits, flat_labels, valid)

    def predict_scores(self, item_seq, type_seq, seq_len, item_range=None):
        """Score the appended mask slot (position seq_len-1)."""
        states, table = self.hidden_states(item_seq, type_seq)
        last = gather_last(states, seq_len)
        last_type = gather_last(type_seq[..., None], seq_len)[:, 0]
        return range_mask(self.head(last, last_type, table), item_range)

    def forward(self, item_seq, type_seq, generator=None):
        return self.hidden_states(item_seq, type_seq, generator)[0]
