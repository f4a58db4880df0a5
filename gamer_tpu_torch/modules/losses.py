"""Losses of the generative and the discriminative models.

PyTorch counterpart of `gamer_tpu/modules/losses.py`. The causal-LM losses:
temperature-scaled next-token cross-entropy, shift by one, `IGNORE_LABEL`
targets and batch-padding rows (`row_valid`) excluded, and the valid-target
count returned as the denominator so callers can form a global token mean.
The discriminative zoo's: full-softmax CE over candidates, BPR with one
negative and in-batch InfoNCE (ref: SeqRec/modules/loss/BPR.py:5,
SeqRec/modules/model_base/seq_model.py:64-82).
"""

from __future__ import annotations

import torch

IGNORE_LABEL = -100


def _shift_targets(labels: torch.Tensor, row_valid: torch.Tensor | None):
    targets = labels[:, 1:]
    valid = targets != IGNORE_LABEL
    if row_valid is not None:
        valid = valid & (row_valid[:, None] == 1)
    return torch.where(valid, targets, 0), valid


def causal_lm_loss_with_denom(
    logits: torch.Tensor,  # [B, S, V]
    labels: torch.Tensor,  # [B, S] with IGNORE_LABEL masked
    temperature: float = 1.0,
    row_valid: torch.Tensor | None = None,  # [B] 0/1 (batch-padding rows)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE (mean over valid targets) and the count it averaged
    over, max(valid count, 1)."""
    logits = logits[:, :-1, :]
    safe_targets, valid = _shift_targets(labels, row_valid)
    inv_t = 1.0 / temperature
    m = logits.amax(dim=-1).float() * inv_t  # [B, S]
    tgt = torch.gather(logits, -1, safe_targets[..., None].long())[..., 0].float() * inv_t
    s = torch.exp(logits.float() * inv_t - m[..., None]).sum(dim=-1)
    nll = torch.where(valid, m + torch.log(s) - tgt, 0.0)
    denom = valid.sum().clamp(min=1)
    return nll.sum() / denom, denom


def fused_causal_lm_loss_with_denom(
    hidden: torch.Tensor,  # [B, S, D] post-final-norm hidden states
    table: torch.Tensor,  # [V, D] tied lm-head table (compute dtype)
    labels: torch.Tensor,  # [B, S] with IGNORE_LABEL masked
    temperature: float = 1.0,
    row_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`causal_lm_loss_with_denom` through the fused tied-head CE
    (`ops/fused_ce.py`): the [B, S, V] logits are never stored."""
    from gamer_tpu_torch.ops.fused_ce import fused_ce_rows

    x = hidden[:, :-1, :]
    safe, valid = _shift_targets(labels, row_valid)
    D = x.shape[-1]
    nll, _ = fused_ce_rows(x.reshape(-1, D), table, safe.reshape(-1).to(torch.int32),
                           valid.reshape(-1).to(torch.int32), 1.0 / temperature)
    denom = valid.sum().clamp(min=1)
    return nll.sum() / denom, denom


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, temperature: float = 1.0,
                   row_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token CE: logits[t] predicts labels[t+1]; mean over valid targets."""
    return causal_lm_loss_with_denom(logits, labels, temperature, row_valid)[0]


def sequence_ce_loss(
    logits: torch.Tensor,  # [B, V] scores over candidates/items
    targets: torch.Tensor,  # [B] int
    valid: torch.Tensor | None = None,  # [B] bool
) -> torch.Tensor:
    """CE of each row's target under a log-softmax in fp32; the mean over
    the valid rows (divided by max(valid count, 1))."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[:, None].long())[:, 0]
    if valid is not None:
        nll = torch.where(valid, nll, 0.0)
        return nll.sum() / valid.sum().clamp(min=1)
    return nll.mean()


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
             valid: torch.Tensor | None = None, gamma: float = 1e-10) -> torch.Tensor:
    """-log(gamma + sigmoid(pos - neg)) (ref BPR.py:5-16), averaged as
    `sequence_ce_loss` does."""
    loss = -torch.log(gamma + torch.sigmoid(pos_scores - neg_scores))
    if valid is not None:
        loss = torch.where(valid, loss, 0.0)
        return loss.sum() / valid.sum().clamp(min=1)
    return loss.mean()


def info_nce(
    anchors: torch.Tensor,  # [B, D]
    positives: torch.Tensor,  # [B, D]
    temperature: float = 1.0,
    normalize: bool = True,
) -> torch.Tensor:
    """In-batch InfoNCE: anchor i's positive is positives[i], negatives are
    the rest of the batch."""
    if normalize:
        anchors = anchors / (torch.linalg.norm(anchors, dim=-1, keepdim=True) + 1e-8)
        positives = positives / (torch.linalg.norm(positives, dim=-1, keepdim=True) + 1e-8)
    sims = anchors @ positives.T / temperature
    labels = torch.arange(anchors.shape[0], device=anchors.device)
    return sequence_ce_loss(sims, labels)
