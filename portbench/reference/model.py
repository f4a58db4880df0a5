"""Plain PyTorch reference of the GAMER Qwen3 decoder family.

Written from the architecture's equations for the benchmark's `correct`: it
imports nothing of the program under test. A model is a dict of fp32 tensors
named as the port names its parameters (the benchmark makes the weights from
the seed and hands the same values to both sides) and a config dict (a file
of `portbench/configs/`).

One decoder layer, pre-normed, each branch added to the residual through the
hash dropout in training:

  x += drop(o_proj(attn_self(rope(q_norm(q)), rope(k_norm(k)), v)))
  x += drop(o_proj(attn_cross(...)) * silu(gating(h)))   (cross layers; h = norm(x),
        q/k/v plus per-action behavior embeddings)
  x += drop(down_e(act_drop(silu(gate_e(u)) * up_e(u))))  u = norm(x) [, behavior
        embedding of the token's block], e the token's routed expert

Routing is a function of the token's place in its item block of
`num_positions` tokens (expert 1 + position; 0 for padding and eos);
`moe_action` routes by (position, action level) to one of
(num_experts - 1) * num_behavior + 1 experts. Attention is GQA with an fp32
softmax; a query row with no allowed key gives 0. Masks: self "causal" j <= i;
cross "multi" j <= i and action[j] < action[i]; keys must be real tokens.

Dropout masks are the stateless hash the configuration states: fmix32 of a
linear form of the element's coordinates plus the site's seed, dropped below
round(rate * 2^32), kept values scaled by 1 / keep probability. The seeds of a
training micro-step are drawn from a CPU `torch.Generator` seeded with
(loop seed * 1000003 + micro-step) mod 2^63, one int in [0, 2^31 - 1) per
site, sites in layer order: self-attention probabilities, its residual,
(cross-attention probabilities, its residual,) MLP activation, MLP residual.

`quant` rounds both operands of every product (fp8 e4m3 with a per-tensor
scale, `fp8`) for the control; the gradient passes straight through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

M1, M2, M3 = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1
U32 = 0xFFFFFFFF
PAD_ID, EOS_ID = 0, 1
NEG = -1e9


# ----------------------------------------------------------------- hash masks

def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32)."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & U32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, M1)
    return x ^ (x >> 15)


def threshold(rate: float) -> int:
    return min(int(round(rate * 4294967296.0)), 4294967295)


def keep_prob(rate: float) -> float:
    return (4294967296 - threshold(rate)) / 4294967296.0


def hash_keep(seed: int, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              rate: float) -> torch.Tensor:
    """fmix32(b * M3 + c * M1 + a * M2 + seed) >= threshold, broadcast."""
    x = (mul32(b, M3) + mul32(c, M1) + mul32(a, M2) + (int(seed) & U32)) & U32
    return fmix32(x) >= threshold(rate)


def flat_keep(seed: int, shape, first: int, rate: float, device) -> torch.Tensor:
    """Keep mask of a tensor of `shape` whose flat indices start at `first`."""
    n = math.prod(shape)
    idx = torch.arange(first, first + n, dtype=torch.int64, device=device)
    return (fmix32((mul32(idx, M3) + (int(seed) & U32)) & U32) >= threshold(rate)).view(shape)


def site_seeds(loop_seed: int, step: int, n: int) -> list[int]:
    gen = torch.Generator().manual_seed((loop_seed * 1_000_003 + step) % (2 ** 63))
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=gen).tolist()


# --------------------------------------------------------------------- config

def layer_kinds(cfg: dict) -> list[dict]:
    """Per layer: cross attention, behavior injection."""
    return [dict(cross=i in cfg["cross_attention_layers"],
                 inject=i in cfg["behavior_injection_layers"])
            for i in range(cfg["num_hidden_layers"])]


def total_experts(cfg: dict) -> int:
    if cfg["moe_action"]:
        return (cfg["num_experts"] - 1) * cfg["num_behavior"] + 1
    return cfg["num_experts"]


def dropout_sites(cfg: dict) -> int:
    return sum(6 if k["cross"] else 4 for k in layer_kinds(cfg))


def param_spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every parameter: kind "normal" (std
    1/sqrt(fan in) for products and experts, 1/sqrt(width) for tables) or
    "ones" (norms)."""
    D, H, Hkv, Dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["head_dim"])
    F_, NB, BD = cfg["intermediate_size"], cfg["num_behavior"], cfg["behavior_embedding_dim"]
    E = total_experts(cfg)
    out = [("embed_tokens.weight", (cfg["vocab_size"], D), "normal", D ** -0.5)]

    def attn(p, cross):
        spec = [(f"{p}.q_proj.weight", (H * Dh, D), "normal", D ** -0.5),
                (f"{p}.k_proj.weight", (Hkv * Dh, D), "normal", D ** -0.5),
                (f"{p}.v_proj.weight", (Hkv * Dh, D), "normal", D ** -0.5),
                (f"{p}.o_proj.weight", (D, H * Dh), "normal", (H * Dh) ** -0.5),
                (f"{p}.q_norm.weight", (Dh,), "ones", 0.0),
                (f"{p}.k_norm.weight", (Dh,), "ones", 0.0)]
        if cross:
            spec += [(f"{p}.q_behavior_embedding.weight", (NB + 1, H * Dh), "normal",
                      (H * Dh) ** -0.5),
                     (f"{p}.k_behavior_embedding.weight", (NB + 1, Hkv * Dh), "normal",
                      (Hkv * Dh) ** -0.5),
                     (f"{p}.v_behavior_embedding.weight", (NB + 1, Hkv * Dh), "normal",
                      (Hkv * Dh) ** -0.5),
                     (f"{p}.gating.weight", (D, D), "normal", D ** -0.5)]
        return spec

    for i, kind in enumerate(layer_kinds(cfg)):
        p = f"layers.{i}"
        din = D + (BD if kind["inject"] else 0)
        out.append((f"{p}.input_layernorm.weight", (D,), "ones", 0.0))
        out += attn(f"{p}.self_attn", False)
        if kind["cross"]:
            out.append((f"{p}.post_self_attention_layernorm.weight", (D,), "ones", 0.0))
            out += attn(f"{p}.cross_attn", True)
        out.append((f"{p}.post_cross_attention_layernorm.weight", (D,), "ones", 0.0))
        out += [(f"{p}.mlp.experts_gate", (E, din, F_), "normal", din ** -0.5),
                (f"{p}.mlp.experts_up", (E, din, F_), "normal", din ** -0.5),
                (f"{p}.mlp.experts_down", (E, F_, D), "normal", F_ ** -0.5)]
        if kind["inject"]:
            out.append((f"{p}.mlp.behavior_embedding.weight", (NB + 1, BD), "normal", BD ** -0.5))
    out.append(("norm.weight", (D,), "ones", 0.0))
    return out


# ---------------------------------------------------------------- quantizing

def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


QUANT = {None: lambda x: x, "fp8": fp8}


# --------------------------------------------------------------------- layers

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX half rotation; x [B, S, H, D], positions [B, S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, :, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, :, None]
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


class Forward:
    """The decoder's forward over one batch of rows; `row0` is the first row's
    index in its micro-batch (the masks hash global rows)."""

    def __init__(self, params: dict, cfg: dict, quant: str | None = None):
        self.p, self.cfg, self.q = params, cfg, QUANT[quant]

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w.T for a [out, in] weight."""
        return self.q(x) @ self.q(w).T

    def attention(self, pre: str, x, h_in, positions, allowed, action_index, cross, seed,
                  rate, row0):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        q = self.mm(h_in, self.p[f"{pre}.q_proj.weight"])
        k = self.mm(h_in, self.p[f"{pre}.k_proj.weight"])
        v = self.mm(h_in, self.p[f"{pre}.v_proj.weight"])
        if cross:
            q = q + self.p[f"{pre}.q_behavior_embedding.weight"][action_index.long()]
            k = k + self.p[f"{pre}.k_behavior_embedding.weight"][action_index.long()]
            v = v + self.p[f"{pre}.v_behavior_embedding.weight"][action_index.long()]
        eps = cfg["rms_norm_eps"]
        q = rope(rms_norm(q.view(B, S, H, Dh), self.p[f"{pre}.q_norm.weight"], eps), positions,
                 cfg["rope_theta"])
        k = rope(rms_norm(k.view(B, S, Hkv, Dh), self.p[f"{pre}.k_norm.weight"], eps),
                 positions, cfg["rope_theta"])
        v = v.view(B, S, Hkv, Dh)
        kv = torch.arange(H, device=x.device) // (H // Hkv)
        k, v = k[:, :, kv], v[:, :, kv]  # [B, S, H, Dh]
        scores = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k)) * Dh ** -0.5
        scores = scores.masked_fill(~allowed[:, None], NEG)
        probs = torch.softmax(scores, -1) * allowed.any(-1)[:, None, :, None]
        if seed is not None and rate > 0:
            bh = ((row0 + torch.arange(B, device=x.device))[:, None] * H
                  + torch.arange(H, device=x.device)[None]).view(B, H, 1, 1)
            rows = torch.arange(S, device=x.device).view(1, 1, S, 1)
            cols = torch.arange(S, device=x.device).view(1, 1, 1, S)
            keep = hash_keep(seed, bh, rows, cols, rate)
            probs = torch.where(keep, probs / keep_prob(rate), 0.0)
        out = torch.einsum("bhqk,bkhd->bqhd", self.q(probs), self.q(v)).reshape(B, S, H * Dh)
        out = self.mm(out, self.p[f"{pre}.o_proj.weight"])
        if cross:
            out = out * F.silu(self.mm(h_in, self.p[f"{pre}.gating.weight"]))
        return out

    def moe(self, pre: str, u, routes, behavior_index, inject, seed, rate, row0):
        cfg = self.cfg
        B, S, _ = u.shape
        P, F_ = cfg["num_positions"], cfg["intermediate_size"]
        if inject:
            u = torch.cat([u, self.p[f"{pre}.behavior_embedding.weight"][behavior_index.long()]],
                          -1)
        flat = u.reshape(B * S, -1)
        out = torch.zeros(B * S, cfg["hidden_size"], dtype=u.dtype, device=u.device)
        col = torch.arange(F_, device=u.device)[None]
        for e in range(total_experts(cfg)):
            idx = (routes.reshape(-1) == e).nonzero(as_tuple=True)[0]
            if idx.numel() == 0:
                continue
            ue = self.q(flat[idx])
            h = (F.silu(ue @ self.q(self.p[f"{pre}.experts_gate"][e]))
                 * (ue @ self.q(self.p[f"{pre}.experts_up"][e])))
            if seed is not None and rate > 0:
                b, t = idx // S, idx % S
                keep = hash_keep(seed, (t % P)[:, None], ((row0 + b) * (S // P) + t // P)[:, None],
                                 col, rate)
                h = torch.where(keep, h / keep_prob(rate), 0.0)
            out = out.index_add(0, idx, self.q(h) @ self.q(self.p[f"{pre}.experts_down"][e]))
        return out.view(B, S, -1)

    def residual(self, x, y, seed, rate, row0):
        if seed is None or rate <= 0:
            return x + y
        B, S, D = y.shape
        keep = flat_keep(seed, (B, S, D), row0 * S * D, rate, y.device)
        return x + torch.where(keep, y / keep_prob(rate), 0.0)

    def __call__(self, ids, positions, self_allowed, cross_allowed, routes, behavior_index,
                 action_index, seeds=None, row0: int = 0) -> torch.Tensor:
        """Final-normed hidden states [B, S, D]. `self_allowed` and
        `cross_allowed` [B, S, S] bool; `routes` [B, S] expert ids; `seeds`
        the micro-step's site seeds (None: no dropout)."""
        cfg = self.cfg
        eps = cfg["rms_norm_eps"]
        rate = cfg["dropout_rate"]
        arate = cfg["attention_dropout"] if cfg["attention_dropout"] >= 0 else rate
        x = self.p["embed_tokens.weight"][ids.long()]
        it = iter(seeds) if seeds is not None else None
        nxt = (lambda: next(it)) if it is not None else (lambda: None)
        for i, kind in enumerate(layer_kinds(cfg)):
            p = f"layers.{i}"
            s_attn, s_res = nxt(), nxt()
            h = rms_norm(x, self.p[f"{p}.input_layernorm.weight"], eps)
            y = self.attention(f"{p}.self_attn", x, h, positions, self_allowed, None, False,
                               s_attn, arate, row0)
            x = self.residual(x, y, s_res, rate, row0)
            if kind["cross"]:
                s_attn, s_res = nxt(), nxt()
                h = rms_norm(x, self.p[f"{p}.post_self_attention_layernorm.weight"], eps)
                y = self.attention(f"{p}.cross_attn", x, h, positions, cross_allowed,
                                   action_index, True, s_attn, arate, row0)
                x = self.residual(x, y, s_res, rate, row0)
            s_act, s_res = nxt(), nxt()
            u = rms_norm(x, self.p[f"{p}.post_cross_attention_layernorm.weight"], eps)
            y = self.moe(f"{p}.mlp", u, routes, behavior_index, kind["inject"], s_act, rate, row0)
            x = self.residual(x, y, s_res, rate, row0)
        return rms_norm(x, self.p["norm.weight"], eps)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.mm(hidden, self.p["embed_tokens.weight"])


# -------------------------------------------------------------------- inputs

def rel_positions(attn: torch.Tensor) -> torch.Tensor:
    rel = torch.cumsum(attn, -1) - 1
    return torch.where(attn == 1, rel, -1)


def route(cfg: dict, ids: torch.Tensor, attn: torch.Tensor):
    """(position_index, behavior_index, action_index, expert ids) [B, S] of a
    left- or right-padded batch: a token's place in its item block counts
    from its row's first real token."""
    P, base, NB = cfg["num_positions"], cfg["behavior_base"], cfg["num_behavior"]
    B, S = ids.shape
    rel = rel_positions(attn)
    special = (ids == PAD_ID) | (ids == EOS_ID) | (rel < 0)
    rmod = torch.remainder(rel, P)
    position = torch.where(special, 0, rmod + 1)
    t = torch.arange(S, device=ids.device)[None].expand(B, S)
    start = torch.gather(ids, 1, (t - rmod).clamp(0, S - 1).long())
    beh = start - base + 1
    beh = torch.where((beh >= 1) & (beh <= NB), beh, 0)
    action = torch.where(special, 0, beh)
    behavior = torch.where(special | (rmod == 0), 0, beh)
    return position, behavior, action, experts(cfg, position, action)


def experts(cfg: dict, position: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    if cfg["moe_action"]:
        return ((cfg["num_experts"] - 1) * (action - 1) + position).clamp(min=0)
    return position


def train_masks(cfg: dict, attn: torch.Tensor, actions: torch.Tensor):
    """(self, cross) allowed [B, S, S] of a training batch."""
    S = attn.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=attn.device).tril()[None]
    key = (attn == 1)[:, None, :]
    self_allowed = causal & key
    cross_allowed = None
    if cfg["cross_attention_layers"]:
        cross_allowed = causal & (actions[:, None, :] < actions[:, :, None]) & key
    return self_allowed, cross_allowed
