"""The work of the model's layers, counted from the configuration and the
inputs, and the card's published peaks: the yardstick of `mfu.*` and
`roofline.*`.

Peaks: NVIDIA H100 SXM data sheet, dense rates (989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM3), at the full 700 W power limit.

Model FLOPs count the products of the model's definition, 2 a
multiply-add: per real token the projections, one routed expert (whatever a
kernel runs besides), the tied head at each position whose logits are used;
attention 4 * head_dim a head per pair (query, key) that the masks allow,
counted over real queries only. Training is the forward times 3 (no
recompute). A kernel group's bound is max(bytes / HBM, FLOPs / peak), each
input read once and each output written once, in bf16.
"""

from __future__ import annotations

import numpy as np

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take for the work."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def causal_pairs(lengths: np.ndarray) -> int:
    """Allowed (query, key) pairs of causal self-attention over rows of
    `lengths` real tokens."""
    n = np.asarray(lengths, np.int64)
    return int((n * (n + 1) // 2).sum())


def multi_pairs(attn: np.ndarray, actions: np.ndarray) -> int:
    """Pairs of the "multi" cross mask (key j <= query i, action[j] <
    action[i], both real) over real queries."""
    attn = np.asarray(attn).astype(bool)
    acts = np.where(attn, np.asarray(actions), -1)
    below = np.zeros(acts.shape, np.int64)  # real keys j <= i with a smaller action
    for v in np.unique(acts[attn]):
        below += np.where(acts > v, np.cumsum(acts == v, axis=1), 0)
    return int(below[attn].sum())


def _per_token(cfg: dict) -> dict:
    """Forward FLOPs a real token of the dense parts, a layer at a time."""
    D, H, Hkv, Dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["head_dim"])
    F = cfg["intermediate_size"]
    proj = 2 * D * (H * Dh + 2 * Hkv * Dh) + 2 * H * Dh * D
    out = {"attn": 0, "moe": 0}
    for i in range(cfg["num_hidden_layers"]):
        out["attn"] += proj
        if i in cfg["cross_attention_layers"]:
            out["attn"] += proj + 2 * D * D
        din = D + (cfg["behavior_embedding_dim"] if i in cfg["behavior_injection_layers"] else 0)
        out["moe"] += 2 * din * 2 * F + 2 * F * D
    out["head"] = 2 * D * cfg["vocab_size"]
    return out


def attention_pairs(cfg: dict, attn: np.ndarray, actions: np.ndarray) -> int:
    """Allowed pairs summed over the model's attention layers (self, then
    the cross layers')."""
    lengths = np.asarray(attn).sum(1)
    n_cross = len(cfg["cross_attention_layers"])
    pairs = cfg["num_hidden_layers"] * causal_pairs(lengths)
    if n_cross:
        pairs += n_cross * multi_pairs(attn, actions)
    return pairs


def train_flops(cfg: dict, batch: dict) -> float:
    """Model FLOPs of one training micro-step (forward x 3)."""
    attn = np.asarray(batch["attention_mask"]) * np.asarray(batch["row_valid"])[:, None]
    tokens = int(attn.sum())
    t = _per_token(cfg)
    pairs = attention_pairs(cfg, attn, batch["actions"])
    fwd = tokens * (t["attn"] + t["moe"] + t["head"]) + pairs * 4 * cfg["head_dim"] * \
        cfg["num_attention_heads"]
    return 3.0 * fwd


def search_flops(cfg: dict, prompts: dict, beams: int, levels: int) -> float:
    """Model FLOPs of one search call: the prompt's forward (logits at its
    last position), then levels - 1 steps of `beams` tokens a request, each
    attending to its real prompt tokens and the tokens appended before it."""
    attn = np.asarray(prompts["attention_mask"])
    t = _per_token(cfg)
    B = attn.shape[0]
    prompt_tokens = int(attn.sum())
    dense = t["attn"] + t["moe"]
    flops = prompt_tokens * dense + B * t["head"]
    flops += attention_pairs(cfg, attn, prompts["actions"]) * 4 * cfg["head_dim"] * \
        cfg["num_attention_heads"]
    lengths = attn.sum(1).astype(np.int64)
    n_layers, n_cross = cfg["num_hidden_layers"], len(cfg["cross_attention_layers"])
    # the cross row of an appended token is the last prompt token's
    acts = np.where(attn.astype(bool), np.asarray(prompts["actions"]), -1)
    cross_row = ((acts < acts[:, -1:]) & attn.astype(bool)).sum(1).astype(np.int64)
    for step in range(1, levels):
        keys_self = lengths + step  # prompt tokens and the appended ones, itself included
        pairs = n_layers * keys_self.sum() + n_cross * cross_row.sum()
        flops += beams * (B * (dense + t["head"]) + pairs * 4 * cfg["head_dim"]
                          * cfg["num_attention_heads"])
    return float(flops)


def attention_work(cfg: dict, batch: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of the attention cores' forward and backward in one
    training micro-step: forward 4 * head_dim a head a pair, backward twice
    that; bytes q, k, v and the output read or written once forward, and
    q, k, v, out, d_out read and dq, dk, dv written backward, over every
    row of the batch."""
    attn = np.asarray(batch["attention_mask"]) * np.asarray(batch["row_valid"])[:, None]
    H, Hkv, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    pairs = attention_pairs(cfg, attn, batch["actions"])
    flops = pairs * 12 * Dh * H
    B, S = attn.shape
    n_attn = cfg["num_hidden_layers"] + len(cfg["cross_attention_layers"])
    q, kv = B * S * H * Dh, B * S * Hkv * Dh
    per = (q + 2 * kv + q) + (2 * q + 2 * kv + q) + (q + 2 * kv)
    return float(flops), float(n_attn * per * BF16)


def moe_work(cfg: dict, batch: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of the routed SwiGLU forward and backward in one
    training micro-step, one expert a real token: forward 2 * d_in * 2F +
    2 * F * D, backward twice that; bytes the input, the output and each
    expert's weights once forward, and the input, d_out, the weights read
    and d_in, the weights' grads written backward, over every row of the
    batch."""
    attn = np.asarray(batch["attention_mask"]) * np.asarray(batch["row_valid"])[:, None]
    tokens, rows = int(attn.sum()), attn.size
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    E = (cfg["num_experts"] - 1) * cfg["num_behavior"] + 1 if cfg["moe_action"] else \
        cfg["num_experts"]
    flops = n_bytes = 0.0
    for i in range(cfg["num_hidden_layers"]):
        din = D + (cfg["behavior_embedding_dim"] if i in cfg["behavior_injection_layers"] else 0)
        f = 2 * din * 2 * F + 2 * F * D
        flops += 3 * tokens * f
        w = E * (din * 2 * F + F * D)
        n_bytes += (rows * (din + D) + w) + (rows * (din + D + din) + 2 * w)
    return flops, n_bytes * BF16
