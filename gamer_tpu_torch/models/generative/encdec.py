"""Encoder-decoder generative family: TIGER (T5) and PBATransformer (Switch-MoE).

PyTorch counterpart of `gamer_tpu/models/generative/encdec.py`: one
parametric seq2seq architecture for both reference models.
 * TIGER — stock T5 over semantic IDs with temperature-scaled CE
   (ref: SeqRec/models/generative/TIGER/model.py, config/s2s-models/TIGER)
 * PBATransformer — the T5 skeleton with a position-routed sparse FFN,
   optional behavior injection and a shared half-output expert
   (ref: SeqRec/models/generative/PBATransformer/{model,FFN,router,block}.py)

T5 semantics, as in JAX: RMS layer norm, pre-norm residual blocks, unscaled
attention with a bucketed relative-position bias held by the first layer of
each stack (the decoder's causal, `bidirectional=False`) and reused by the
later layers, a tied embedding with d_model**-0.5 logit scaling, and the HF
T5 init (`reset_parameters`). The MLPs are `modules/moe.py`'s
`PositionRoutedMLP` with `mlp_type="t5"` on the one-hot route, as JAX runs
them; the routing indices come from `encdec_utils.prepare_encdec_inputs` or
the beam search. The JAX package runs no Pallas kernel here, so neither does
the port: every op is plain PyTorch, on the card or the CPU.

Dropout (`deterministic=False`) uses the stateless hash of
`modules/dropout.py` at every site (the embeddings, the attention
probabilities, the residual branches, the MLP activation and the final
norms), one int32 seed a site drawn in layer order from the caller's
`torch.Generator`, as `QwenFamilyModel` does; JAX draws these masks from its
rng stream, which torch cannot reproduce.

Parameters are stored in fp32 and cast to `cfg.dtype` at use. Module names
follow the flax tree (`shared`, `encoder_{i}.self_attn.q`, `decoder_{i}.ln3`,
`decoder_{i}.mlp.experts_wi`, ...), so `convert.py` carries weights both ways.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from gamer_tpu_torch.core.config import Config, config_field
from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.modules.dropout import attention_row_seed, hash_dropout, hash_dropout_add
from gamer_tpu_torch.modules.layers import RMSNorm, dense, embed
from gamer_tpu_torch.modules.moe import PositionRoutedMLP
from gamer_tpu_torch.ops.fused_attention import attention_keep_mask, keep_fraction
from gamer_tpu_torch.ops.masks import NEG_INF
from gamer_tpu_torch.ops.seeds import site_seeds


class EncDecConfig(Config):
    vocab_size: int = 32128
    d_model: int = 128
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 4
    num_decoder_layers: int = 4
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    dense_act_fn: str = "relu"
    temperature: float = 1.0
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    # PBATransformer switches (empty lists => plain T5 / TIGER)
    sparse_layers_encoder: list = config_field([])
    sparse_layers_decoder: list = config_field([])
    behavior_injection_encoder: list = config_field([])
    behavior_injection_decoder: list = config_field([])
    shared_expert: bool = False
    num_positions: int = 5
    num_experts: int = 6
    num_behavior: int = 0
    behavior_embedding_dim: int = 64
    behavior_base: int = 14
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


def rel_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
               max_distance: int) -> torch.Tensor:
    """T5 relative-position bucketing of `rel` = query_pos - memory_pos
    (int tensor), in fp32 as JAX computes it."""
    rel = rel.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scale = np.float32(np.log(max_distance / max_exact))
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact) / float(scale)
                         * (num_buckets - max_exact)).to(torch.int32)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


class T5Attention(nn.Module):
    """T5 multi-head attention without the 1/sqrt(d_kv) scale; the first
    layer of a stack holds the relative-position bias table."""

    def __init__(self, cfg: EncDecConfig, has_rel_bias: bool = False, bidirectional: bool = True):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.rel_bias = (nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
                         if has_rel_bias else None)

    def position_bias(self, q_positions: torch.Tensor, k_positions: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
        """[1, H, Sq, Sk] bias of the bucketed query - key offsets."""
        cfg = self.cfg
        buckets = rel_bucket(q_positions[:, None] - k_positions[None, :], self.bidirectional,
                             cfg.relative_attention_num_buckets,
                             cfg.relative_attention_max_distance)
        return embed(self.rel_bias, buckets, dtype).permute(2, 0, 1)[None]

    def forward(
        self,
        x: torch.Tensor,  # [B, Sq, D] queries
        kv: Optional[torch.Tensor] = None,  # [B, Sk, D] keys/values (cross); None = self
        allowed: Optional[torch.Tensor] = None,  # [B or 1, 1, Sq, Sk] bool
        pos_bias: Optional[torch.Tensor] = None,  # [1, H, Sq, Sk] precomputed
        q_positions: Optional[torch.Tensor] = None,  # [Sq] absolute positions
        k_positions: Optional[torch.Tensor] = None,
        kv_cache: Optional[dict] = None,
        cache_index: Optional[int] = None,
        shared_kv: Optional[dict] = None,  # beam-shared projected k/v [B, Sk, H, dk]
        emit_kv: bool = False,  # also return the projected k/v (to build shared_kv)
        dropout_seed: Optional[int] = None,  # None = no attention-prob dropout
    ) -> tuple[torch.Tensor, Optional[torch.Tensor], Optional[dict]]:
        """(output [B, Sq, D], the position bias for the next layer, the new
        cache or the emitted k/v)."""
        cfg = self.cfg
        H, dk = cfg.num_heads, cfg.d_kv
        b, sq, _ = x.shape
        q = dense(self.q, x).reshape(b, sq, H, dk)

        if shared_kv is not None:
            # beam-decode cross-attention: the encoder k/v were projected once
            # at prefill and stay [B, Sk]; the beam axis folds into the query
            B = shared_kv["k"].shape[0]
            qb = q.reshape(B, b // B, H, dk)  # sq == 1
            scores = torch.einsum("bkhd,bshd->bkhs", qb.float(), shared_kv["k"].float())
            if allowed is not None:  # [B, 1, 1, Sk] beam-invariant
                scores = scores + torch.where(allowed[:, 0], 0.0, NEG_INF)[:, None]
            probs = torch.softmax(scores, dim=-1).to(shared_kv["v"].dtype)
            out = torch.einsum("bkhs,bshd->bkhd", probs, shared_kv["v"])
            return dense(self.o, out.reshape(b, sq, H * dk).to(x.dtype)), pos_bias, None

        src = x if kv is None else kv
        k = dense(self.k, src).reshape(b, src.shape[1], H, dk)
        v = dense(self.v, src).reshape(b, src.shape[1], H, dk)
        new_cache = None
        if kv_cache is not None:
            k_all, v_all = kv_cache["k"].clone(), kv_cache["v"].clone()
            k_all[:, cache_index:cache_index + sq] = k.to(k_all.dtype)
            v_all[:, cache_index:cache_index + sq] = v.to(v_all.dtype)
            new_cache = {"k": k_all, "v": v_all}
            k, v = k_all, v_all

        sk = k.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())  # T5: no 1/sqrt(d)
        if self.rel_bias is not None and pos_bias is None:
            qp = q_positions if q_positions is not None else torch.arange(sq, device=x.device)
            kp = k_positions if k_positions is not None else torch.arange(sk, device=x.device)
            pos_bias = self.position_bias(qp, kp, x.dtype)
        if pos_bias is not None:
            scores = scores + pos_bias.float()
        if allowed is not None:
            scores = scores + torch.where(allowed, 0.0, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        if dropout_seed is not None and cfg.dropout_rate > 0.0:
            # dropout on the attention probs (HF T5Attention does the same)
            keep = attention_keep_mask(dropout_seed, b, H, sq, sk, cfg.dropout_rate, x.device)
            probs = torch.where(keep, probs / keep_fraction(cfg.dropout_rate), 0.0)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        out = dense(self.o, out.reshape(b, sq, H * dk).to(x.dtype))
        if emit_kv:
            new_cache = {"k": k, "v": v}
        return out, pos_bias, new_cache


class EncDecBlock(nn.Module):
    """One encoder layer (self-attention `ln1`, MLP `ln2`) or decoder layer
    (self-attention `ln1`, cross-attention `ln2`, MLP `ln3`), pre-normed
    and residual."""

    def __init__(self, cfg: EncDecConfig, i: int, decoder: bool):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln1 = RMSNorm(cfg.d_model, eps)
        self.self_attn = T5Attention(cfg, has_rel_bias=i == 0, bidirectional=not decoder)
        self.ln2 = RMSNorm(cfg.d_model, eps)
        if decoder:
            self.cross_attn = T5Attention(cfg)
            self.ln3 = RMSNorm(cfg.d_model, eps)
        self.mlp = PositionRoutedMLP(
            cfg.d_model, cfg.d_ff, cfg.num_experts,
            is_sparse=i in (cfg.sparse_layers_decoder if decoder else cfg.sparse_layers_encoder),
            mlp_type="t5", hidden_act=cfg.dense_act_fn,
            behavior_injection=i in (cfg.behavior_injection_decoder if decoder
                                     else cfg.behavior_injection_encoder),
            num_behavior=cfg.num_behavior, behavior_dim=cfg.behavior_embedding_dim,
            shared_expert=cfg.shared_expert, use_kernel=False, dropout_rate=cfg.dropout_rate)
        self.num_positions = cfg.num_positions
        # dropout sites, in seed order: self-attention probs and residual,
        # (cross-attention probs and residual,) MLP activation and residual
        self.dropout_sites = 6 if decoder else 4

    def mlp_block(self, h, norm, position_index, behavior_index, seeds, drop_add, row0=0):
        m = self.mlp(norm(h), position_index, behavior_index, route_mode="onehot",
                     num_positions=self.num_positions, deterministic=seeds is None,
                     dropout_seed=0 if seeds is None else seeds[-2], row0=row0)
        return drop_add(h, m, None if seeds is None else seeds[-1])


class EncDecModel(nn.Module):
    """The enc-dec family's forward.

    `device=None` means CUDA and raises without it; the tests pass
    `device="cpu"`. Weights are drawn from a CPU `torch.Generator` seeded
    with `seed` and stored in fp32; the forward computes in `cfg.dtype`.
    """

    def __init__(self, cfg: EncDecConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
            for i in range(cfg.num_layers):
                self.add_module(f"encoder_{i}", EncDecBlock(cfg, i, decoder=False))
            for i in range(cfg.num_decoder_layers):
                self.add_module(f"decoder_{i}", EncDecBlock(cfg, i, decoder=True))
            self.encoder_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
            self.decoder_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
            if not cfg.tie_word_embeddings:
                self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        self.to_empty(device=device)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    @property
    def encoder_layers(self) -> list[EncDecBlock]:
        return [getattr(self, f"encoder_{i}") for i in range(self.cfg.num_layers)]

    @property
    def decoder_layers(self) -> list[EncDecBlock]:
        return [getattr(self, f"decoder_{i}") for i in range(self.cfg.num_decoder_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The HF T5 init (`docs/parity.md` #13): shared embedding N(0, 1),
        q N(0, (d_model d_kv)^-1/2), k and v N(0, d_model^-1/2), o N(0,
        (H d_kv)^-1/2), relative bias N(0, d_model^-1/2); untied lm_head
        N(0, d_model^-1/2); experts lecun-normal (std 1/sqrt(fan_in)),
        behavior embeddings std 1/sqrt(width), unit norms."""
        cfg = self.cfg

        def fill(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        fill(self.shared.weight, 1.0)
        for mod in self.modules():
            if isinstance(mod, T5Attention):
                fill(mod.q.weight, (cfg.d_model * cfg.d_kv) ** -0.5)
                fill(mod.k.weight, cfg.d_model ** -0.5)
                fill(mod.v.weight, cfg.d_model ** -0.5)
                fill(mod.o.weight, (cfg.num_heads * cfg.d_kv) ** -0.5)
                if mod.rel_bias is not None:
                    fill(mod.rel_bias.weight, cfg.d_model ** -0.5)
            elif isinstance(mod, PositionRoutedMLP):
                for w in mod.parameters(recurse=False):  # [(E,) d_in, d_out]
                    fill(w, 1.0 / math.sqrt(w.shape[-2]))
                if mod.behavior_injection:
                    emb = mod.behavior_embedding.weight
                    fill(emb, 1.0 / math.sqrt(emb.shape[1]))
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        if not cfg.tie_word_embeddings:
            fill(self.lm_head.weight, cfg.d_model ** -0.5)

    @property
    def dropout_sites(self) -> int:
        """Seeds a training forward draws: the encoder's embedding, layers
        and final norm, then the decoder's."""
        return (2 + sum(layer.dropout_sites for layer in self.encoder_layers)
                + 2 + sum(layer.dropout_sites for layer in self.decoder_layers))

    def forward(
        self,
        encoder_input_ids: Optional[torch.Tensor] = None,  # [B, Se]
        encoder_attention_mask: Optional[torch.Tensor] = None,
        decoder_input_ids: Optional[torch.Tensor] = None,  # [B, Sd]
        decoder_attention_mask: Optional[torch.Tensor] = None,
        enc_position_index: Optional[torch.Tensor] = None,
        enc_behavior_index: Optional[torch.Tensor] = None,
        dec_position_index: Optional[torch.Tensor] = None,
        dec_behavior_index: Optional[torch.Tensor] = None,
        encoder_hidden: Optional[torch.Tensor] = None,  # precomputed (decode)
        deterministic: bool = True,
        caches: Optional[list] = None,  # decoder self-attention caches per layer
        cache_index: Optional[int] = None,
        dec_positions: Optional[torch.Tensor] = None,  # [Sd] absolute positions (decode)
        logits_last_only: bool = False,
        cross_kv: Optional[list] = None,  # per-layer beam-shared cross k/v (decode)
        emit_cross_kv: bool = False,  # prefill: return the projected cross k/v per layer
        generator=None,  # dropout seeds (training): a torch.Generator or the seed table
        row0: int = 0,  # first global batch row of this process's rows
    ) -> dict:
        """`deterministic=False` (training) draws one int32 dropout seed a
        site from `generator` (a CPU generator), in layer order, or reads
        them from `generator` given as the step's [dropout_sites] int32 seed
        table on the model's device (`ops/seeds.site_seeds`; the same
        masks). Under a process group `row0` makes every dropout mask that
        of the global batch (`modules/dropout.row_seed`)."""
        cfg = self.cfg
        dtype = cfg.torch_dtype
        seeds = None
        if not deterministic:
            seeds = iter(site_seeds(generator, self.dropout_sites, self.device))
        take = lambda n: None if seeds is None else [next(seeds) for _ in range(n)]
        one = lambda: None if seeds is None else next(seeds)
        drop = lambda y, seed: y if seed is None else hash_dropout(y, seed, cfg.dropout_rate, row0)
        drop_add = (lambda r, y, seed: r + y if seed is None
                    else hash_dropout_add(r, y, seed, cfg.dropout_rate, row0))
        attn_seed = lambda s, i: None if s is None else attention_row_seed(s[i], row0,
                                                                            cfg.num_heads)

        # ---------------- encoder ----------------
        if encoder_hidden is None and cross_kv is None:
            h = drop(embed(self.shared, encoder_input_ids, dtype), one())
            enc_allowed = None
            if encoder_attention_mask is not None:
                enc_allowed = (encoder_attention_mask[:, None, None, :] == 1)
            bias = None
            for layer in self.encoder_layers:
                s = take(layer.dropout_sites)
                a, bias, _ = layer.self_attn(layer.ln1(h), allowed=enc_allowed, pos_bias=bias,
                                             dropout_seed=attn_seed(s, 0))
                h = drop_add(h, a, None if s is None else s[1])
                h = layer.mlp_block(h, layer.ln2, enc_position_index, enc_behavior_index, s,
                                    drop_add, row0)
            encoder_hidden = drop(self.encoder_norm(h), one())
        elif seeds is not None:  # the encoder's seeds, unused
            take(2 + sum(layer.dropout_sites for layer in self.encoder_layers))

        # ---------------- decoder ----------------
        b, sd = decoder_input_ids.shape
        dev = decoder_input_ids.device
        h = drop(embed(self.shared, decoder_input_ids, dtype), one())
        # self mask: causal (+ padding); with caches the queries are the
        # current slice and the keys the whole cache
        if caches is not None:
            k_len = caches[0]["self"]["k"].shape[1]
            qpos = (dec_positions if dec_positions is not None
                    else cache_index + torch.arange(sd, device=dev))
            kpos = torch.arange(k_len, device=dev)
        else:
            qpos = kpos = torch.arange(sd, device=dev)
        self_allowed = (kpos[None, :] <= qpos[:, None])[None, None]
        if decoder_attention_mask is not None and caches is None:
            self_allowed = self_allowed & (decoder_attention_mask[:, None, None, :] == 1)
        cross_allowed = None
        if encoder_attention_mask is not None:
            cross_allowed = (encoder_attention_mask[:, None, None, :] == 1)

        bias = None
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.decoder_layers):
            s = take(layer.dropout_sites)
            a, bias, self_cache = layer.self_attn(
                layer.ln1(h), allowed=self_allowed, pos_bias=bias, q_positions=qpos,
                k_positions=kpos, kv_cache=None if caches is None else caches[i]["self"],
                cache_index=cache_index, dropout_seed=attn_seed(s, 0))
            h = drop_add(h, a, None if s is None else s[1])
            a, _, ckv = layer.cross_attn(
                layer.ln2(h), kv=encoder_hidden, allowed=cross_allowed,
                shared_kv=None if cross_kv is None else cross_kv[i], emit_kv=emit_cross_kv,
                dropout_seed=attn_seed(s, 2))
            h = drop_add(h, a, None if s is None else s[3])
            h = layer.mlp_block(h, layer.ln3, dec_position_index, dec_behavior_index, s,
                                drop_add, row0)
            if new_caches is not None:
                entry = {"self": self_cache}
                if emit_cross_kv:
                    entry["cross"] = ckv
                new_caches.append(entry)
        h = drop(self.decoder_norm(h), one())
        if logits_last_only:
            h = h[:, -1:, :]
        if cfg.tie_word_embeddings:
            logits = (h * (cfg.d_model ** -0.5)) @ self.shared.weight.to(h.dtype).T
        else:
            logits = dense(self.lm_head, h)
        return {"logits": logits, "encoder_hidden": encoder_hidden, "caches": new_caches}


def shift_right(labels: torch.Tensor, start_token: int, pad_id: int = 0,
                ignore_label: int = -100) -> torch.Tensor:
    """T5 decoder-input construction: [start, labels[:-1]] with -100 -> pad."""
    start = torch.full((labels.shape[0], 1), start_token, dtype=labels.dtype,
                       device=labels.device)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == ignore_label, torch.full_like(shifted, pad_id), shifted)


PBA_PRESET = dict(
    d_model=256, d_ff=512, num_layers=4, num_decoder_layers=4, num_heads=6,
    shared_expert=False,
)


def build_encdec_config(backbone: str, **overrides: Any) -> EncDecConfig:
    base: dict[str, Any] = {}
    if backbone == "PBATransformer":
        base.update(PBA_PRESET)
        n_layers = overrides.get("num_layers", base["num_layers"])
        base.setdefault("sparse_layers_encoder", list(range(n_layers)))
        base.setdefault("sparse_layers_decoder", list(range(n_layers)))
    elif backbone != "TIGER":
        raise ValueError(f"unknown enc-dec backbone {backbone!r}")
    base.update(overrides)
    cfg = EncDecConfig.from_dict(base)
    cfg.extra["backbone"] = backbone
    return cfg
