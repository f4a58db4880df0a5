"""Core neural building blocks: RMSNorm, RoPE, GQA attention.

PyTorch counterpart of `gamer_tpu/modules/layers.py`. Attention takes a
boolean *allowed* mask (built by `ops/masks.py`) on the plain path, or the
integer mask streams on the kernel path (`ops/fused_attention.py`), and
threads KV caches explicitly: a cache is a dict of tensors passed in and
returned, so the decode driver owns all state.

Parameters stay in fp32 (as the JAX package's); each module casts its weights
to the dtype of its input at use, as flax's `dtype=` modules do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gamer_tpu_torch.ops import fused_attention as fa
from gamer_tpu_torch.ops.masks import NEG_INF
from gamer_tpu_torch.ops.qk_norm_rope import qk_norm_rope


class RMSNorm(nn.Module):
    """Root-mean-square layer norm (as Qwen3RMSNorm): variance in fp32,
    multiply in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return y * self.weight.to(x.dtype)


def dense(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`mod` applied in x's dtype (flax `nn.Dense(dtype=...)` on fp32 params)."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), bias)


ONE_HOT_ELEMENTS = 1 << 25  # one-hot block of `_Lookup`'s backward (128 MiB in fp32)


class _Lookup(torch.autograd.Function):
    """Rows of a table whose backward is a fixed-order sum: the one-hot of
    the ids (in blocks of rows) times the incoming grads, so two runs give
    the same bits on the card (see `lookup`)."""

    @staticmethod
    def forward(ctx, ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        V = ctx.rows
        ids, grad = ids.reshape(-1), grad.reshape(-1, grad.shape[-1])
        dw = torch.zeros((V, grad.shape[-1]), dtype=grad.dtype, device=grad.device)
        block = max(ONE_HOT_ELEMENTS // V, 1)
        for lo in range(0, ids.numel(), block):
            part = ids[lo:lo + block, None]
            onehot = torch.zeros((part.shape[0], V), dtype=grad.dtype, device=grad.device)
            dw.addmm_(onehot.scatter_(1, part, 1.0).T, grad[lo:lo + block])
        return None, dw


def lookup(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """`F.embedding(ids, weight)` whose grad is bit-reproducible: with a
    grad to take, the table's backward is `_Lookup`'s one-hot product.
    PyTorch's own CUDA embedding backward gave two passes that differed in
    the last bits of the 4-row behavior tables (`scripts/probe_determinism.py`);
    the one-hot product costs no device time at the flagship step."""
    if weight.requires_grad and torch.is_grad_enabled():
        return _Lookup.apply(ids.long(), weight)
    return F.embedding(ids.long(), weight)


class Embedding(nn.Embedding):
    """`nn.Embedding` whose lookup is `lookup` (a bit-reproducible grad)."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return lookup(ids, self.weight)


def embed(mod: nn.Embedding, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of `mod`'s fp32 table, cast to `dtype` (flax `nn.Embed(dtype=...)`)."""
    return lookup(ids, mod.weight).to(dtype)


def attend(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    allowed: torch.Tensor,  # [B or 1, 1, Sq, Sk] bool
    scale: float,
    keep: Optional[torch.Tensor] = None,  # [B, H, Sq, Sk] bool dropout keep mask
    keep_prob: float = 1.0,
) -> torch.Tensor:
    """Masked GQA attention core with an fp32 softmax. Rows with no allowed
    key output zero, not the softmax's uniform average over every key.
    `keep` (training) drops attention probabilities, rescaling the kept ones
    by 1/keep_prob; query head h of the mask is kv head h // G, group h % G."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    allowed5 = allowed[:, :, None]  # [B, 1, 1, Sq, Sk]
    scores = scores + torch.where(allowed5, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(allowed5.any(dim=-1, keepdim=True), probs, 0.0)
    if keep is not None:
        keep5 = keep.reshape(keep.shape[0], hkv, h // hkv, sq, keep.shape[-1])
        probs = torch.where(keep5, probs / keep_prob, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def attend_shared_prompt(
    q: torch.Tensor,  # [B*K, 1, H, D] one decode token per beam
    kp: torch.Tensor,  # [B, S, Hkv, D] prompt keys, shared across beams
    vp: torch.Tensor,  # [B, S, Hkv, D]
    kg: Optional[torch.Tensor],  # [B*K, T, Hkv, D] generated keys, or None
    vg: Optional[torch.Tensor],
    prompt_allowed: torch.Tensor,  # [B, S] bool (beam-invariant decode row)
    scale: float,
) -> torch.Tensor:
    """Decode-step attention with a beam-shared prompt KV cache.

    Decode mask rows are beam-invariant over the prompt (self rows = padding
    mask, cross rows = frozen last-prompt row), so scores against the prompt
    KV are computed once per example with the beam axis folded into the
    query. Generated keys stay per-beam and are all allowed (the caller
    passes only the positions written so far).
    """
    BK, _, H, D = q.shape
    B, S, Hkv, _ = kp.shape
    K = BK // B
    G = H // Hkv
    qb = q.reshape(B, K, Hkv, G, D).float()
    sp = torch.einsum("bkhgd,bshd->bkhgs", qb, kp.float()) * scale
    sp = sp + torch.where(prompt_allowed[:, None, None, None, :], 0.0, NEG_INF)
    if kg is not None and kg.shape[1] > 0:
        sp = sp.reshape(BK, Hkv, G, S)
        qg = q[:, 0].reshape(BK, Hkv, G, D).float()
        sg = torch.einsum("nhgd,nthd->nhgt", qg, kg.float()) * scale
        probs = torch.softmax(torch.cat([sp, sg], dim=-1), dim=-1)
        pp, pg = probs[..., :S], probs[..., S:]
        out = torch.einsum("bkhgs,bshd->bkhgd", pp.reshape(B, K, Hkv, G, S), vp.float())
        out = out.reshape(BK, Hkv, G, D) + torch.einsum("nhgt,nthd->nhgd", pg, vg.float())
    else:
        pp = torch.softmax(sp, dim=-1)
        # cross stream with a fully-masked frozen row (min-action target
        # behavior): zero, the same contract as the train path
        has_key = prompt_allowed.any(dim=-1).reshape(B, 1, 1, 1, 1)
        pp = torch.where(has_key, pp, 0.0)
        out = torch.einsum("bkhgs,bshd->bkhgd", pp, vp.float()).reshape(BK, Hkv, G, D)
    return out.reshape(BK, 1, H, D).to(q.dtype)


class GQAAttention(nn.Module):
    """Qwen3-style grouped-query attention with per-head q/k RMS norm.

    With `is_cross=True` this is the GAMER behavior cross-attention:
    per-action behavior embeddings of width head_dim are added to q/k/v
    before norm/rope, and the output is gated by silu(gating(x)).

    `use_kernel` selects the fused attention (CUDA kernel on the card, its
    plain version on the CPU) on the train/scoring path (no KV cache): the
    mask is then evaluated from the integer streams instead of `allowed`.
    With `deterministic=False`, attention probabilities are dropped at
    `dropout_rate` by the stateless hash keyed on the call's `dropout_seed`,
    on the kernel and the plain path alike.

    `forward` is `output(x, core(qkv(x)))`: the remat policy "attn" of
    `models/generative/qwen_family.py` recomputes `qkv` and `output` in the
    backward and keeps what the attention core saves.
    """

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int, head_dim: int,
                 rope_theta: float = 1e6, rms_eps: float = 1e-6,
                 attention_bias: bool = False, is_cross: bool = False,
                 num_behavior: int = 0, use_kernel: bool = True, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.is_cross = is_cross
        self.use_kernel = use_kernel
        hd, kvd = num_heads * head_dim, num_kv_heads * head_dim
        self.q_proj = nn.Linear(hidden_size, hd, bias=attention_bias)
        self.k_proj = nn.Linear(hidden_size, kvd, bias=attention_bias)
        self.v_proj = nn.Linear(hidden_size, kvd, bias=attention_bias)
        self.o_proj = nn.Linear(hd, hidden_size, bias=attention_bias)
        self.q_norm = RMSNorm(head_dim, rms_eps)
        self.k_norm = RMSNorm(head_dim, rms_eps)
        if is_cross:
            self.q_behavior_embedding = nn.Embedding(num_behavior + 1, hd)
            self.k_behavior_embedding = nn.Embedding(num_behavior + 1, kvd)
            self.v_behavior_embedding = nn.Embedding(num_behavior + 1, kvd)
            self.gating = nn.Linear(hidden_size, hidden_size, bias=attention_bias)

    def output(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The output projection of the attention core's `out` [B, S, H, D];
        `x` (the module's input) feeds the cross-attention gate only."""
        b, s = out.shape[:2]
        out = dense(self.o_proj, out.reshape(b, s, self.num_heads * self.head_dim))
        if self.is_cross:
            out = out * F.silu(dense(self.gating, x))
        return out

    def qkv(self, x: torch.Tensor, positions: torch.Tensor,
            action_index: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Projected, normed and rotated q [B, S, H, D], k and v [B, S, Hkv, D]."""
        b, s, _ = x.shape
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        q = dense(self.q_proj, x)
        k = dense(self.k_proj, x)
        v = dense(self.v_proj, x)
        if self.is_cross:
            if action_index is None:
                raise ValueError("cross attention needs action_index")
            q = q + embed(self.q_behavior_embedding, action_index, q.dtype)
            k = k + embed(self.k_behavior_embedding, action_index, k.dtype)
            v = v + embed(self.v_behavior_embedding, action_index, v.dtype)
        # q_norm, k_norm and RoPE: N1/N2 on the card, their plain version on the CPU
        q, k = qk_norm_rope(q.reshape(b, s, H, D), k.reshape(b, s, Hkv, D), self.q_norm.weight,
                            self.k_norm.weight, positions, self.rope_theta, self.q_norm.eps)
        return q, k, v.reshape(b, s, Hkv, D)

    def core(
        self,
        q: torch.Tensor,  # [B, S, H, D]
        k: torch.Tensor,  # [B, S, Hkv, D]
        v: torch.Tensor,
        allowed: Optional[torch.Tensor],  # [B or 1, 1, S, Sk] bool (plain path)
        kv_cache: Optional[dict] = None,
        cache_index: Optional[int] = None,
        mask_kind: Optional[str] = None,
        streams: Optional[dict] = None,
        deterministic: bool = True,
        dropout_seed: int = 0,
    ) -> tuple[torch.Tensor, Optional[dict]]:
        """Attention of q over k and v (and the KV cache): (out [B, S, H, D],
        the new cache)."""
        b, s = q.shape[:2]
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        if kv_cache is not None and "k_prompt" in kv_cache:
            # Beam-decode path: prompt KV shared [B, S], generated KV per beam.
            # `allowed` is the beam-invariant prompt row [B, 1, 1, S] or [B, S].
            prompt_allowed = allowed if allowed.dim() == 2 else allowed[:, 0, 0, :]
            if "k" in kv_cache:  # self stream: write this step, read [0, idx]
                k_all = kv_cache["k"].clone()
                v_all = kv_cache["v"].clone()
                k_all[:, cache_index:cache_index + s] = k.to(k_all.dtype)
                v_all[:, cache_index:cache_index + s] = v.to(v_all.dtype)
                new_cache = {**kv_cache, "k": k_all, "v": v_all}
                kg, vg = k_all[:, :cache_index + 1], v_all[:, :cache_index + 1]
            else:  # cross stream: generated keys are never attended
                new_cache = kv_cache
                kg = vg = None
            out = attend_shared_prompt(q, kv_cache["k_prompt"], kv_cache["v_prompt"],
                                       kg, vg, prompt_allowed, D ** -0.5)
            return out, new_cache

        new_cache = None
        if kv_cache is not None:
            if cache_index is None:
                raise ValueError("a KV cache needs cache_index")
            k_all = kv_cache["k"].clone()
            v_all = kv_cache["v"].clone()
            k_all[:, cache_index:cache_index + s] = k.to(k_all.dtype)
            v_all[:, cache_index:cache_index + s] = v.to(v_all.dtype)
            new_cache = {"k": k_all, "v": v_all}
            k, v = k_all, v_all

        rate = 0.0 if deterministic else self.dropout_rate
        if (self.use_kernel and kv_cache is None and mask_kind is not None
                and streams is not None):
            out = fa.fused_mask_attention(
                q.reshape(b, s, H * D), k.reshape(b, s, Hkv * D), v.reshape(b, s, Hkv * D),
                streams["attention_mask"], streams["session_ids"], streams["actions"],
                streams["block_ids"], dropout_seed, H, mask_kind, rate).reshape(b, s, H, D)
        else:
            keep = None
            if rate > 0.0:
                keep = fa.attention_keep_mask(dropout_seed, b, H, s, k.shape[1], rate, q.device)
            out = attend(q, k, v, allowed, D ** -0.5, keep=keep,
                         keep_prob=fa.keep_fraction(rate))
        return out, new_cache

    def forward(
        self,
        x: torch.Tensor,  # [B, S, D]
        positions: torch.Tensor,  # [B, S] rope positions
        allowed: Optional[torch.Tensor],  # [B or 1, 1, S, Sk] bool (plain path)
        action_index: Optional[torch.Tensor] = None,  # [B, S] (cross only)
        kv_cache: Optional[dict] = None,
        cache_index: Optional[int] = None,
        mask_kind: Optional[str] = None,
        streams: Optional[dict] = None,
        deterministic: bool = True,
        dropout_seed: int = 0,
    ) -> tuple[torch.Tensor, Optional[dict]]:
        q, k, v = self.qkv(x, positions, action_index)
        out, new_cache = self.core(q, k, v, allowed, kv_cache, cache_index, mask_kind,
                                   streams, deterministic, dropout_seed)
        return self.output(x, out), new_cache
