"""MBHT: multi-behavior hypergraph-enhanced transformer (KDD'22).

PyTorch counterpart of `gamer_tpu/models/discriminative/mbht.py` (ref:
SeqRec/models/discriminative/MBHT/model.py + modules/layers/
{multi_scale_transformer.py, HGNN.py}): multi-scale attention (Linformer-style
linear attention over the full sequence + plain attention over mean-pooled
scales, fused by a length-wise linear layer), plus a hypergraph branch:
gated item embeddings, top-k item-similarity hyperedges and same-item
multi-behavior hyperedges -> 2-layer HGNN convolution, masked-position
sliding-window readout, attention-weighted fusion with the transformer
output. The incidence matrix has JAX's static shapes: position-indexed
hyperedges [L, 2L], the first L carrying top-k similarity weights +
self-loops, the second L the same-item connections, normalized as HGNN
(G = Dv^-1 H De^-1 H^T). The similarities are computed in JAX's order, so
the top-k threshold (`>=` against the sorted k-th largest; negative
similarities become exactly 0.01, so ties are common) selects the same
edges. The branch's dropout is a fixed 0.2, as in JAX (`mbht.py:142`).
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
    DETERMINISTIC, DropoutSeeds, MultiHeadAttention, TransformerEncoder, _act,
    attention_allowed, dense, embedding, normal_param)

SW_BEFORE, SW_FOLLOW = 10, 6  # sliding-window readout (ref model.py:224-226)
HG_DROPOUT = 0.2  # the hypergraph branch's fixed rate (JAX mbht.py:142)


class LinearAttention(nn.Module):
    """Linformer-style attention: E/F project the length dim (ref :10-77)."""

    def __init__(self, d_model: int, n_heads: int, linear_size: int, max_len: int,
                 eps: float, generator: torch.Generator):
        super().__init__()
        self.n_heads = n_heads
        for name in ("W_Q", "W_K", "W_V"):
            self.add_module(name, dense(d_model, d_model, generator))
        self.E = dense(max_len, linear_size, generator)
        self.F = dense(max_len, linear_size, generator)
        self.dense = dense(d_model, d_model, generator)
        self.ln = nn.LayerNorm(d_model, eps=eps)

    def forward(self, x, pad_ok, drop: DropoutSeeds = DETERMINISTIC):
        B, L, D = x.shape
        h = self.n_heads
        d = D // h
        heads = lambda y: y.reshape(B, L, h, d).transpose(1, 2)
        q, k, v = heads(self.W_Q(x)), heads(self.W_K(x)), heads(self.W_V(x))
        m = pad_ok[:, None, :, None]  # [B, 1, L, 1]
        k, v = k * m, v * m
        # project length: [B, h, L, d] -> [B, h, linear, d]
        v = self.E(v.transpose(2, 3)).transpose(2, 3)
        k = self.F(k.transpose(2, 3)).transpose(2, 3)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
        probs = drop(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2).reshape(B, L, -1)
        return self.ln(drop.add(x, self.dense(ctx)))


class MultiScaleLayer(nn.Module):
    def __init__(self, cfg: DisModelConfig, max_len: int, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        lin_size, s1, s2 = cfg.scales
        assert max_len % s1 == 0 and max_len % s2 == 0, "max_len must divide the scales"
        self.act = _act(cfg.hidden_act)
        self.attn1 = LinearAttention(H, cfg.n_heads, lin_size, max_len, cfg.layer_norm_eps,
                                     generator)
        self.attn2 = MultiHeadAttention(H, cfg.n_heads, generator)
        self.out_fc = dense(max_len + max_len // s1 + max_len // s2, max_len, generator)
        self.ff1 = dense(H, cfg.inner_size, generator)
        self.ff2 = dense(cfg.inner_size, H, generator)
        self.ff_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, x, pad_ok, drop: DropoutSeeds = DETERMINISTIC):
        B, L, H = x.shape
        _, s1, s2 = self.cfg.scales
        outs = [self.attn1(x, pad_ok, drop)]
        for s in (s1, s2):
            pooled = x.reshape(B, s, L // s, H).mean(dim=1)  # interleaved pooling (ref :115-119)
            allow = torch.ones((1, 1, L // s, L // s), dtype=torch.bool, device=x.device)
            outs.append(self.attn2(pooled, allow, drop))
        cat = torch.cat(outs, dim=1)  # [B, L + L/s1 + L/s2, H]
        fused = self.out_fc(cat.transpose(1, 2)).transpose(1, 2)
        # FeedForward with residual + LN (ref transformer.FeedForward)
        f = self.ff2(drop(self.act(self.ff1(fused))))
        return self.ff_ln(drop.add(fused, f))


class HypergraphBranch(nn.Module):
    """Static-shape hypergraph branch (see the module docstring)."""

    def __init__(self, cfg: DisModelConfig, mask_token: int, generator: torch.Generator):
        super().__init__()
        self.cfg, self.mask_token = cfg, mask_token
        H, std = cfg.hidden_size, cfg.initializer_range
        self.gating_weight = normal_param((H, H), std, generator)
        self.gating_bias = normal_param((1, H), std, generator)
        self.metric_w1 = normal_param((1, H), std, generator)
        self.metric_w2 = normal_param((1, H), std, generator)
        self.hgc1_w = normal_param((H, H), 0.02, generator)
        self.hgc1_b = normal_param((H,), 0.02, generator)
        self.hgc2_w = normal_param((H, H), 0.02, generator)
        self.hgc2_b = normal_param((H,), 0.02, generator)

    def incidence(self, item_seq: torch.Tensor, item_emb: torch.Tensor):
        """(gated embeddings x_raw [B, L, H], incidence matrix [B, L, 2L])."""
        B, L, H = item_emb.shape
        x_raw = item_emb * torch.sigmoid(item_emb @ self.gating_weight + self.gating_bias)
        x_m = (self.metric_w1 * x_raw + self.metric_w2 * x_raw) / 2
        norm = x_m / (torch.linalg.norm(x_m, dim=-1, keepdim=True) + 1e-12)
        sim = torch.einsum("bld,bmd->blm", norm, norm)
        sim = torch.where(sim < 0, 0.01, sim)
        real = item_seq != 0  # [B, L]
        pair_ok = real[:, :, None] & real[:, None, :]
        # top-k similarity hyperedges (position-indexed; ref build_Gs_unique)
        k = min(self.cfg.hyper_len, L)
        sim_masked = torch.where(pair_ok, sim, -torch.inf)
        thresh = torch.sort(sim_masked, dim=-1).values[:, :, -k][..., None]  # kth largest
        H1 = torch.where((sim_masked >= thresh) & pair_ok, sim, 0.0)
        eye = torch.eye(L, dtype=torch.bool, device=item_seq.device)[None]
        H1 = torch.where(eye, real[:, :, None].to(sim.dtype), H1)  # self-loop
        # same-item multi-behavior hyperedges
        same = (item_seq[:, :, None] == item_seq[:, None, :]) & pair_ok
        multi = same.sum(-1) > 1  # item occurs more than once
        H2 = (same & multi[:, None, :]).to(sim.dtype)
        return x_raw, torch.cat([H1, H2], dim=-1)

    def forward(self, item_seq, item_emb, mask_positions, drop: DropoutSeeds = DETERMINISTIC):
        L = item_emb.shape[1]
        x_raw, Hmat = self.incidence(item_seq, item_emb)
        DV, DE = Hmat.sum(-1), Hmat.sum(-2)
        invDV = torch.where(DV > 0, 1.0 / DV, 0.0)
        invDE = torch.where(DE > 0, 1.0 / DE, 0.0)
        G = torch.einsum("bl,ble,be,bme->blm", invDV, Hmat, invDE, Hmat)
        # HGNN: two convs, averaged (ref HGNN.py:27-39)
        x1 = drop(torch.einsum("blm,bmd->bld", G, x_raw @ self.hgc1_w + self.hgc1_b), HG_DROPOUT)
        x2 = drop(torch.einsum("blm,bmd->bld", G, x1 @ self.hgc2_w + self.hgc2_b), HG_DROPOUT)
        hg = (x1 + x2) / 2
        # masked-position sliding-window readout (ref model.py:303-326)
        pos = torch.arange(L, device=item_seq.device)
        win = ((pos[None, :] >= torch.clamp(pos[:, None] - SW_BEFORE, min=0))
               & (pos[None, :] < pos[:, None] + SW_FOLLOW) & (pos[None, :] != pos[:, None]))
        win_b = win[None] & (item_seq != 0)[:, None, :]  # [B, L, L] readout window per position
        w_sum = win_b.sum(-1, keepdim=True)
        readout = torch.einsum("blm,bmd->bld", win_b.to(hg.dtype) / torch.clamp(w_sum, min=1), hg)
        return torch.where(mask_positions[..., None], readout, hg)


@DIS_MODELS.register("MBHT")
class MBHT(nn.Module):
    """`max_his_len` includes the appended target/mask slot."""

    def __init__(self, cfg: DisModelConfig, n_items: int, max_his_len: int,
                 n_behaviors: int = 3, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.n_items, self.max_his_len = cfg, n_items, max_his_len
        self.n_behaviors = n_behaviors
        g = torch.Generator().manual_seed(seed)
        H, std, L = cfg.hidden_size, cfg.initializer_range, max_his_len
        self.item_embedding = embedding(n_items + 2, H, g, std)
        self.type_embedding = embedding(n_behaviors + 1, H, g, std)
        self.position_embedding = embedding(L, H, g, std)
        self.input_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        if cfg.enable_ms:
            for i in range(cfg.n_layers):
                self.add_module(f"layer_{i}", MultiScaleLayer(cfg, L, g))
        else:
            self.encoder = TransformerEncoder(cfg.n_layers, H, cfg.n_heads, cfg.inner_size,
                                              cfg.hidden_act, cfg.layer_norm_eps, g)
        if cfg.enable_hg:
            self.hypergraph = HypergraphBranch(cfg, self.mask_token, g)
            self.attn_weights = normal_param((H, H), std, g)
            self.attn = normal_param((1, H), std, g)
        self.to(device)

    @property
    def mask_token(self) -> int:
        return self.n_items + 1

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward takes: the input's; a
        multi-scale layer's six (linear attention's probabilities and
        residual, the two pooled attentions' probabilities, the FFN's
        activation and residual) or an encoder layer's four; the hypergraph
        branch's two convolutions."""
        cfg = self.cfg
        return (1 + cfg.n_layers * (6 if cfg.enable_ms else 4)
                + (2 if cfg.enable_hg else 0))

    def uniform_shapes(self, B: int, L: int) -> list:
        """Masked-LM draws of `calculate_loss`: the masked positions."""
        return [(B, L)]

    def hidden_states(self, item_seq, type_seq, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        L = self.max_his_len
        assert item_seq.shape[1] == L, f"MBHT expects fixed length {L}"
        drop = DropoutSeeds(generator, cfg.dropout_prob)
        item_emb = self.item_embedding(item_seq.long())
        x = (item_emb + self.type_embedding(type_seq.long())
             + self.position_embedding(torch.arange(L, device=item_seq.device))[None])
        x = drop(self.input_ln(x))
        pad_ok = (item_seq != 0).to(x.dtype)
        if cfg.enable_ms:
            for i in range(cfg.n_layers):
                x = getattr(self, f"layer_{i}")(x, pad_ok, drop)
        else:
            x = self.encoder(x, attention_allowed(item_seq, bidirectional=True), drop)
        if cfg.enable_hg:
            hg = self.hypergraph(item_seq, item_emb, item_seq == self.mask_token, drop)
            mixed = torch.stack([x, hg], dim=0)  # [2, B, L, H]
            weights = (torch.einsum("sbld,de->sble", mixed, self.attn_weights) * self.attn).sum(-1)
            x = (mixed * torch.softmax(weights, dim=0)[..., None]).sum(0)
        return x, self.item_embedding.weight

    def calculate_loss(self, item_seq, type_seq, target, target_behavior, seq_len,
                       generator: Optional[torch.Generator], row_valid=None,
                       uniforms: Optional[torch.Tensor] = None):
        """Append the target at position seq_len, mask random positions and
        the target slot (ref reconstruct_train_data, model.py:171-244);
        `uniforms` [B, L] in [0, 1) pick the random positions, else drawn
        from `generator`."""
        B, L = item_seq.shape
        dev = item_seq.device
        pos = torch.arange(L, device=dev)[None]
        at_target = pos == torch.clamp(seq_len.long(), 0, L - 1)[:, None]
        seq = torch.where(at_target, target[:, None].to(item_seq.dtype), item_seq)
        types = torch.where(at_target, target_behavior[:, None].to(type_seq.dtype), type_seq)
        if uniforms is None:
            uniforms = uniform_draw((B, L), generator, dev)
        mask = ((uniforms.to(dev) < self.cfg.mask_ratio) & (seq != 0)) | at_target
        labels = seq * mask
        masked_seq = torch.where(mask, self.mask_token, seq)
        masked_types = torch.where(mask, 0, types)
        states, table = self.hidden_states(masked_seq, masked_types, generator)
        logits = states.reshape(B * L, -1) @ table.T  # incl. the mask token's column (ref :399-402)
        flat_labels = labels.reshape(-1)
        valid = flat_labels != 0
        if row_valid is not None:
            valid = valid & torch.repeat_interleave(row_valid == 1, L)
        return sequence_ce_loss(logits, flat_labels, valid)

    def predict_scores(self, item_seq, type_seq, seq_len, item_range=None):
        """The mask slot is already appended by the eval builder; score it."""
        states, table = self.hidden_states(item_seq, type_seq)
        last = gather_last(states, seq_len)
        return range_mask(last @ table[: self.n_items + 1].T, item_range)

    def forward(self, item_seq, type_seq, generator=None):
        return self.hidden_states(item_seq, type_seq, generator)[0]
