"""PBAT: personalized behavior-aware transformer with Gaussian embeddings.

PyTorch counterpart of `gamer_tpu/models/discriminative/pbat.py` (ref:
SeqRec/models/discriminative/PBAT/model.py + modules/layers/pbat.py):
(mean, cov) Gaussian embeddings for items/behaviors/users/positions/behavior
relations; SAGP/TriSAGP Gaussian products (ref pbat.py:10-28); Wasserstein-
distance attention (ref :31-44,131-223); behavior-specific FFN (ref :226-252);
Wasserstein prediction head sharing the item Gaussian embeddings (ref
:293-334); personalized user-behavior relation weights (ref model.py:132-168).
Masked-item training; eval scores the appended mask slot.

Note: the reference head returns +W2 distance as the logit in both training
and eval, so the model consistently learns the flipped sign, as in JAX.

The head scores every row against every item: `w2_distance_matrix` forms
the [N, V] distances as |a|^2 + |b|^2 - 2 a.b^T over a = [mean, sqrt(cov)]
(two matmul operands), never the [N, V, H] differences the broadcast form
`w2_distance` makes (7.9 GB an fp32 intermediate at batch 256 x 20 rows
and 6001 items).
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
    DETERMINISTIC, DropoutSeeds, dense, embedding)
from gamer_tpu_torch.ops.masks import NEG_INF


# Covariance channels come from elu(x)+1, which UNDERFLOWS TO EXACTLY 0 in
# f32 for x <~ -17 (1 - (1 - exp(x)) rounds to 0). A 1e-24 floor keeps the
# FORWARD finite but the backward of m/c is -m/c^2 ~ 1e48 -> inf, and clip's
# zero cotangent then produces inf*0 = NaN — PBAT trained to gnorm=NaN on the
# very first step (round-3 mini quality run). The floor must keep 1/c^2
# representable in f32.
_COV_FLOOR = 1e-6


def sagp(m1, m2, c1, c2):
    c1 = torch.clamp(c1, min=_COV_FLOOR)
    c2 = torch.clamp(c2, min=_COV_FLOOR)
    mean = (c1 * m2 + c2 * m1) / (c1 + c2)
    cov = 2 * (c1 * c2) / (c1 + c2)
    return mean, cov


def tri_sagp(m1, m2, m3, c1, c2, c3):
    # reciprocal form: every intermediate (r <= 1/_COV_FLOOR, r^2 in backward)
    # stays representable; the 1/(1/c1+1/c2+1/c3) form squares reciprocals of
    # the raw covariances in its VJP and overflows
    r1 = 1.0 / torch.clamp(c1, min=_COV_FLOOR)
    r2 = 1.0 / torch.clamp(c2, min=_COV_FLOOR)
    r3 = 1.0 / torch.clamp(c3, min=_COV_FLOOR)
    denom = r1 + r2 + r3
    cov = 1.0 / denom
    mean = (m1 * r1 + m2 * r2 + m3 * r3) / denom
    return mean, cov


def w2_distance(m1, c1, m2, c2):
    """2-Wasserstein^2 between diagonal Gaussians over the last (feature) dim
    (ref pbat.py:31-45); broadcasts leading dims."""
    mean_part = torch.sum((m1 - m2) ** 2, dim=-1)
    cov_part = torch.sum(
        (torch.sqrt(torch.clamp(c1, min=_COV_FLOOR)) - torch.sqrt(torch.clamp(c2, min=_COV_FLOOR)))
        ** 2, dim=-1)
    return mean_part + cov_part


def w2_distance_matrix(m1, c1, m2, c2):
    """[N, H] x [V, H] -> [N, V]: `w2_distance` of every pair of rows, by
    the expansion |a|^2 + |b|^2 - 2 a.b^T with a = [m, sqrt(clip(c))]; no
    [N, V, H] tensor is formed, forward or backward."""
    a = torch.cat([m1, torch.sqrt(torch.clamp(c1, min=_COV_FLOOR))], dim=-1)
    b = torch.cat([m2, torch.sqrt(torch.clamp(c2, min=_COV_FLOOR))], dim=-1)
    return (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)


class SimpleEmbedding(nn.Module):
    """Embed -> LN -> dropout -> ELU (ref pbat.py:48-61)."""

    def __init__(self, vocab: int, dim: int, eps: float, generator: torch.Generator):
        super().__init__()
        self.emb = embedding(vocab, dim, generator)
        self.ln = nn.LayerNorm(dim, eps=eps)

    def forward(self, ids, drop: DropoutSeeds = DETERMINISTIC):
        return F.elu(drop(self.ln(self.emb(ids.long()))))

    @property
    def table(self):
        return self.emb.weight


class FBAttention(nn.Module):
    """Fused behavior-aware Wasserstein attention (ref pbat.py:64-223)."""

    def __init__(self, cfg: DisModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        d = H // cfg.n_heads
        for src in ("xm", "xc", "bm", "bc"):
            for p in ("q", "k", "v"):
                self.add_module(f"{src}_{p}", dense(H, H, generator))
        for name in ("Wq1", "Wq2", "Wk1", "Wk2"):
            self.add_module(name, dense(d, d, generator))
        self.mean_dense = dense(H, H, generator)
        self.out_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.cov_dense = dense(H, H, generator)

    def forward(self, xm, xc, allowed, type_seq, tm, tc, rel_m, rel_c, pos_m, pos_c,
                drop: DropoutSeeds = DETERMINISTIC):
        h = self.cfg.n_heads
        B, L, H = xm.shape
        d = H // h
        heads = lambda y: y.reshape(B, L, h, d).transpose(1, 2)
        qkv = lambda src, name: tuple(heads(getattr(self, f"{name}_{p}")(src)) for p in "qkv")
        qxm, kxm, vxm = qkv(xm, "xm")
        qxc, kxc, vxc = qkv(xc, "xc")
        qbm, kbm, vbm = qkv(tm, "bm")
        qbc, kbc, vbc = qkv(tc, "bc")
        q1, k1, v1 = qxm + qbm, kxm + kbm, vxm + vbm
        q2 = F.elu(qxc + qbc) + 1
        k2 = F.elu(kxc + kbc) + 1
        v2 = F.elu(vxc + vbc) + 1

        # per-(i, j) behavior relation Gaussians: rel_* [B, b+1, b+1, H]
        t = type_seq.long()
        rows = torch.arange(B, device=xm.device)[:, None, None]
        rel_sel_m = rel_m[rows, t[:, :, None], t[:, None, :]]  # [B, L, L, H]
        rel_sel_c = rel_c[rows, t[:, :, None], t[:, None, :]]
        rel_h_m = rel_sel_m.reshape(B, L, L, h, d).permute(0, 3, 1, 2, 4)  # [B, h, L, L, d]
        rel_h_c = rel_sel_c.reshape(B, L, L, h, d).permute(0, 3, 1, 2, 4)
        pos_h_m, pos_h_c = heads(pos_m), heads(pos_c)

        fQm, fQc = tri_sagp(q1[:, :, :, None], self.Wq1(rel_h_m), self.Wq2(pos_h_m)[:, :, :, None],
                            q2[:, :, :, None], rel_h_c, pos_h_c[:, :, :, None])
        fKm, fKc = tri_sagp(k1[:, :, :, None], self.Wk1(rel_h_m), self.Wk2(pos_h_m)[:, :, :, None],
                            k2[:, :, :, None], rel_h_c, pos_h_c[:, :, :, None])
        scores = -w2_distance(fQm, fQc, fKm, fKc) / math.sqrt(d)  # [B, h, L, L]
        scores = scores + torch.where(allowed, 0.0, NEG_INF)
        probs = drop(torch.softmax(scores, dim=-1))
        ctx_m = torch.einsum("BhQK,BhKd->BhQd", probs, v1).transpose(1, 2).reshape(B, L, H)
        ctx_c = torch.einsum("BhQK,BhKd->BhQd", probs, v2).transpose(1, 2).reshape(B, L, H)
        hm = self.out_ln(drop.add(xm, self.mean_dense(ctx_m)))
        hc = self.out_ln(drop.add(xc, self.cov_dense(ctx_c)))
        return hm, hc


class BehaviorFFN(nn.Module):
    """Behavior-specific FFN bank (ref pbat.py:226-252): per-behavior expert,
    one-hot selected; expert 0 (padding) contributes zeros. The reference runs
    the SAME bank on mean and cov streams: one module, called twice."""

    def __init__(self, cfg: DisModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        H, F_ = cfg.hidden_size, cfg.inner_size
        for i in range(cfg.n_behaviors):
            self.add_module(f"ffn_{i}_1", dense(H, F_, generator))
            self.add_module(f"ffn_{i}_2", dense(F_, H, generator))
            self.add_module(f"ffn_{i}_ln", nn.LayerNorm(H, eps=cfg.layer_norm_eps))

    def forward(self, x, type_seq, drop: DropoutSeeds = DETERMINISTIC):
        n = self.cfg.n_behaviors
        outs = [torch.zeros_like(x)]
        for i in range(n):
            f = drop(F.elu(getattr(self, f"ffn_{i}_1")(x)))
            f = drop.add(x, getattr(self, f"ffn_{i}_2")(f))
            outs.append(getattr(self, f"ffn_{i}_ln")(f))
        sel = F.one_hot(type_seq.long(), n + 1).to(x.dtype)
        return torch.einsum("bBLH,BLb->BLH", torch.stack(outs, 0), sel)


class PBATLayer(nn.Module):
    def __init__(self, cfg: DisModelConfig, generator: torch.Generator):
        super().__init__()
        self.attn = FBAttention(cfg, generator)
        self.ffn = BehaviorFFN(cfg, generator)

    def forward(self, xm, xc, allowed, type_seq, tm, tc, rel_m, rel_c, pos_m, pos_c,
                drop: DropoutSeeds = DETERMINISTIC):
        xm, xc = self.attn(xm, xc, allowed, type_seq, tm, tc, rel_m, rel_c, pos_m, pos_c, drop)
        xm = self.ffn(xm, type_seq, drop)
        xc = F.elu(self.ffn(xc, type_seq, drop)) + 1
        return xm, xc


@DIS_MODELS.register("PBAT")
class PBAT(nn.Module):
    def __init__(self, cfg: DisModelConfig, n_items: int, max_his_len: int, n_users: int = 1,
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.n_items, self.max_his_len = cfg, n_items, max_his_len
        g = torch.Generator().manual_seed(seed)
        H, b, eps = cfg.hidden_size, cfg.n_behaviors, cfg.layer_norm_eps
        for name, vocab in (("item", n_items + 2), ("type", b + 1), ("user", n_users + 1)):
            self.add_module(f"{name}_m", SimpleEmbedding(vocab, H, eps, g))
            self.add_module(f"{name}_c", SimpleEmbedding(vocab, H, eps, g))
        self.rel_m_emb = SimpleEmbedding(b * b + 1, H, eps, g)
        self.rel_c_emb = SimpleEmbedding(b * b + 1, H, eps, g)
        self.pos_m = embedding(max_his_len + 1, H, g)
        self.pos_c = embedding(max_his_len + 1, H, g)
        self.Wub = dense(H, H, g)
        self.WPub = dense(H, H, g)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", PBATLayer(cfg, g))
        self.head_out_m = dense(H, H, g)
        self.head_out_c = dense(H, H, g)
        self.to(device)

    @property
    def mask_token(self) -> int:
        return self.n_items + 1

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward takes: the ten embedding
        lookups' (item, type, user, the behavior table and the relation
        table, mean and covariance each), then a layer's attention
        probabilities and two residuals and, for each of its two FFN passes
        (mean and covariance), an activation and a residual per behavior."""
        cfg = self.cfg
        return 10 + cfg.n_layers * (3 + 4 * cfg.n_behaviors)

    def uniform_shapes(self, B: int, L: int) -> list:
        """Masked-LM draws of `calculate_loss`: the masked positions."""
        return [(B, L)]

    def hidden_states(self, item_seq, type_seq, user_ids,
                      generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        b = cfg.n_behaviors
        B, L = item_seq.shape
        dev = item_seq.device
        drop = DropoutSeeds(generator, cfg.dropout_prob)
        xm = self.item_m(item_seq, drop)
        xc = self.item_c(item_seq, drop) + 1
        tm = self.type_m(type_seq, drop)
        tc = self.type_c(type_seq, drop) + 1
        um = self.user_m(user_ids, drop)
        uc = self.user_c(user_ids, drop) + 1
        pos_ids = torch.arange(L, device=dev) % (self.max_his_len + 1)
        pm = self.pos_m(pos_ids)[None].expand(B, L, -1)
        pc = self.pos_c(pos_ids)[None].expand(B, L, -1) + 1

        all_beh = torch.arange(b + 1, device=dev)
        bm = self.type_m(all_beh, drop)[None].expand(B, b + 1, -1)
        bc = F.elu(self.type_c(all_beh, drop)[None].expand(B, b + 1, -1)) + 1

        P_ub_m, P_ub_c = sagp(um[:, None], self.Wub(bm), uc[:, None], bc)  # [B, b+1, H]
        weight_ub = -w2_distance(P_ub_m[:, :, None], P_ub_c[:, :, None],
                                 P_ub_m[:, None, :], P_ub_c[:, None, :])  # [B, b+1, b+1]

        # personalized relation tensors (ref model.py:146-168), built out of
        # place: zeros (means) / ones (covs) around the [B, b, b, H] inner block
        rel_ids = torch.arange(b * b + 1, device=dev)
        rel_base_m = self.rel_m_emb(rel_ids, drop)  # [b*b+1, H]
        rel_base_c = self.rel_c_emb(rel_ids, drop)
        pair_idx = (torch.arange(b, device=dev)[:, None] * b
                    + torch.arange(b, device=dev)[None, :]) + 1  # [b, b]
        w_inner = weight_ub[:, 1:, 1:, None]  # [B, b, b, 1]
        rel_m = F.pad(w_inner * rel_base_m[pair_idx][None], (0, 0, 1, 0, 1, 0), value=0.0)
        rel_c = F.pad(w_inner * rel_base_c[pair_idx][None], (0, 0, 1, 0, 1, 0), value=1.0)
        rel_c = F.elu(rel_c) + 1

        allowed = (item_seq != 0)[:, None, None, :].expand(B, 1, L, L)
        for i in range(cfg.n_layers):
            xm, xc = getattr(self, f"layer_{i}")(xm, xc, allowed, type_seq, tm, tc, rel_m, rel_c,
                                                 pm, pc, drop)

        # final personalized fusion (ref model.py:180-194)
        rows = torch.arange(B, device=dev)[:, None]
        sel_m = P_ub_m[rows, type_seq.long()]  # [B, L, H]
        sel_c = P_ub_c[rows, type_seq.long()]
        return sagp(xm, self.WPub(sel_m), xc, sel_c)

    def head_logits(self, hm, hc):
        """Wasserstein head over the item Gaussian tables (ref pbat.py:293-334)."""
        hm = F.elu(self.head_out_m(hm))
        hc = F.elu(self.head_out_c(hc))
        emb_m = self.item_m.table[: self.n_items + 1]
        emb_c = F.elu(self.item_c.table[: self.n_items + 1]) + 1
        return w2_distance_matrix(hm, hc, emb_m, emb_c)

    def calculate_loss(self, item_seq, type_seq, user_ids, generator: Optional[torch.Generator],
                       row_valid=None, uniforms: Optional[torch.Tensor] = None):
        """Masked-item CE; `uniforms` [B, L] in [0, 1) pick the masked
        positions, else drawn from `generator`."""
        B, L = item_seq.shape
        if uniforms is None:
            uniforms = uniform_draw((B, L), generator, item_seq.device)
        mask = (uniforms.to(item_seq.device) < self.cfg.mask_ratio) & (item_seq != 0)
        labels = item_seq * mask
        masked_seq = torch.where(mask, self.mask_token, item_seq)
        hm, hc = self.hidden_states(masked_seq, type_seq, user_ids, generator)
        logits = self.head_logits(hm.reshape(B * L, -1), hc.reshape(B * L, -1))
        flat_labels = labels.reshape(-1)
        valid = flat_labels != 0
        if row_valid is not None:
            valid = valid & torch.repeat_interleave(row_valid == 1, L)
        return sequence_ce_loss(logits, flat_labels, valid)

    def predict_scores(self, item_seq, type_seq, user_ids, seq_len, item_range=None):
        hm, hc = self.hidden_states(item_seq, type_seq, user_ids)
        scores = self.head_logits(gather_last(hm, seq_len), gather_last(hc, seq_len))
        return range_mask(scores, item_range)

    def forward(self, item_seq, type_seq, user_ids, generator=None):
        return self.hidden_states(item_seq, type_seq, user_ids, generator)[0]
