"""Geometry-based device-memory estimate and the automatic remat choice.

PyTorch counterpart of `gamer_tpu/train/memory.py`: remat off is the
fastest step whenever it fits, and policy "attn" is the choice when it does
not, so a long-context CLI run without flags picks a config that fits instead
of running out of memory (ref gradient-checkpointing plumbing:
SeqRec/tasks/train_SMB_decoder.py:412).

The estimate keeps JAX's structure (parameters and optimizer state, saved
activations per token and layer, CE buffers) but counts what the port's
remat-off step keeps, which the JAX formula (written for XLA's saved
activations) under-counts: the fp32 copies that the RMSNorms save, the
act-dtype copies of q, k and v around the attention core and the q/k norm
and RoPE (N1 keeps the pre-norm q and k and an fp32 rstd a head), and in
the backward the residual hash dropout's output (`modules/dropout.py`). The counts
below come from a census of the tensors a flagship step saves for its
backward (`scripts/probe_remat_memory.py`) on the kernel path;
the plain paths' extra terms (`attention_impl`, `moe_impl`, `ce_impl` =
"jnp") are structural and were not measured.
"""

from __future__ import annotations

import math

import torch

from gamer_tpu_torch.core.logging import get_logger

logger = get_logger("train.memory")

# enable remat above this fraction of device memory: conservative in the cheap
# direction (remat costs time, running out of memory costs the run)
BUDGET_FRACTION = 0.7

# Saved tensors of a remat-off training step, per token, counted by
# scripts/probe_remat_memory.py's census on one NVIDIA H100 80GB HBM3 at
# 700.00 W (flagship Qwen3Multi, bf16, dropout 0.2, B 64 x S 505 and B 16 x S
# 8190); chip_smoke.py phase 9 holds the estimate within [1, 1.3] x the
# measured remat-off peak at both geometries.
HIDDEN_SAVES = 8  # [token, H] act-dtype tensors of a layer: norm in/outputs, residual, MoE in/out
HIDDEN_SAVES_F32 = 2  # fp32 copies the layer's two RMSNorms save
CROSS_HIDDEN_SAVES, CROSS_HIDDEN_SAVES_F32 = 2, 1  # a cross-attention layer's third norm
# act-dtype copies of q (projection, RoPE output, core output), and of the k/v
# width (k's projection and RoPE output, v)
QKV_SAVES = 3
# [token, H] act-dtype tensors the hash dropout keeps live in the backward: K2's
# output (ops/hash_dropout.py; the kernels draw the mask in registers)
DROPOUT_TEMP_SAVES = 1
PARAM_BYTES = 4 + 8 + 4 + 2  # fp32 master, AdamW m and v, fp32 grad, the act-dtype cast at use
ACT_MARGIN = 1.1  # the estimate stays above the measured peak, within 1.3x of it


def count_params(cfg) -> int:
    """Analytic parameter count for a QwenFamilyConfig (no init needed —
    remat must be decided before the model is built)."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    nh, nkv, dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    V = cfg.padded_vocab_size or cfg.vocab_size
    n = V * H  # tied embedding/lm-head table
    n += cfg.num_behavior * cfg.behavior_embedding_dim
    mlp_in = H + cfg.behavior_embedding_dim  # injection layers widen the FFN
    for layer in range(L):
        n += H * nh * dh + 2 * H * nkv * dh + nh * dh * H  # q,k,v,o
        n += 2 * H + 2 * dh  # rms norms (pre-attn/pre-mlp, q/k norms)
        width = mlp_in if layer in cfg.behavior_injection_layers else H
        if layer in cfg.sparse_layers:
            n += cfg.total_experts * (2 * width * I + I * H)
        else:
            n += 2 * width * I + I * H
        if layer in cfg.cross_attention_layers:
            n += H * nh * dh + 2 * H * nkv * dh + nh * dh * H + H  # + gate
    return int(n)


def estimate_train_hbm_bytes(cfg, micro: int, seq_len: int) -> dict:
    """Estimate of a remat-off training step's peak device memory, in bytes.

    Components:
      params — fp32 master, AdamW m and v, fp32 grads, act-dtype casts
      acts   — the tensors the backward needs per token and layer (see the
               constants) plus the backward's dropout temporaries, times
               ACT_MARGIN; the fused attention never stores S^2 scores
      logits — CE buffers: the fused tied-head CE keeps row statistics only,
               the plain one the [tokens, V] logits and their fp32 softmax
    """
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    V = cfg.padded_vocab_size or cfg.vocab_size
    ab = 2 if cfg.dtype == "bfloat16" else 4
    wq, wk = nh * dh, nkv * dh

    params = count_params(cfg)
    params_bytes = params * PARAM_BYTES

    # and N1's fp32 rstd a head and int32 position (ops/qk_norm_rope.py)
    attention = ab * QKV_SAVES * (wq + wk) + 4 * (nh + nkv) + 4
    if cfg.attention_impl == "jnp":  # scores, probs and mask [H, S] a query row
        attention += 3 * 4 * nh * seq_len
    layer = ab * HIDDEN_SAVES * H + 4 * HIDDEN_SAVES_F32 * H + attention
    if cfg.moe_impl == "jnp":  # gate|up and h (one expert a token), as JAX counts
        layer += ab * 3 * I
    cross = attention + ab * CROSS_HIDDEN_SAVES * H + 4 * CROSS_HIDDEN_SAVES_F32 * H
    per_token = (L * layer + len(cfg.cross_attention_layers) * cross
                 + ab * 3 * H + 4 * H  # final norm, CE input
                 + ab * DROPOUT_TEMP_SAVES * H * (cfg.dropout_rate > 0))
    tokens = micro * seq_len
    acts_bytes = ACT_MARGIN * tokens * per_token

    fused_ce = cfg.tie_word_embeddings and cfg.ce_impl != "jnp"
    logits_bytes = tokens * (8 if fused_ce else V * (ab + 8) + 8)
    total = params_bytes + acts_bytes + logits_bytes
    return {"params": params_bytes, "acts": acts_bytes,
            "logits": logits_bytes, "total": total, "n_params": params}


def device_hbm_bytes(device=None) -> float:
    """Total memory of the card `device` (default: the current CUDA device);
    inf for the CPU, so tests never auto-remat."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return math.inf
    return float(torch.cuda.get_device_properties(device).total_memory)


def select_remat(cfg, micro: int, seq_len: int, hbm_bytes: float | None = None,
                 device=None) -> tuple[bool, str, dict]:
    """(remat, policy, estimate) for a geometry. Off when the remat-off step
    fits under BUDGET_FRACTION of the device's memory, else "attn"."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    est = estimate_train_hbm_bytes(cfg, micro, seq_len)
    over = est["total"] > BUDGET_FRACTION * hbm_bytes
    return over, "attn", est


def auto_remat_overrides(cfg, micro: int, seq_len: int, device=None) -> dict:
    """Config overrides for a geometry the user didn't pin flags for."""
    remat, policy, est = select_remat(cfg, micro, seq_len, device=device)
    if remat:
        logger.warning(
            "auto remat: estimated %.1f GB (acts %.1f + params %.1f + "
            "logits %.1f) exceeds %d%% of the device's memory — enabling "
            "remat_policy=%s (pass --no-gradient_checkpointing to force off)",
            est["total"] / 1e9, est["acts"] / 1e9, est["params"] / 1e9,
            est["logits"] / 1e9, int(BUDGET_FRACTION * 100), policy)
        return {"remat": True, "remat_policy": policy}
    logger.info("auto remat: off (estimated %.1f GB fits; remat off is the "
                "fastest step when it fits)", est["total"] / 1e9)
    return {}
