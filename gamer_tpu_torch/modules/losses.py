"""Losses of the generative and the discriminative models.

PyTorch counterpart of `gamer_tpu/modules/losses.py`. The causal-LM losses:
temperature-scaled next-token cross-entropy, shift by one, `IGNORE_LABEL`
targets and batch-padding rows (`row_valid`) excluded, and the valid-target
count returned as the denominator so callers can form a global token mean.
The discriminative zoo's: full-softmax CE over candidates, BPR with one
negative and in-batch InfoNCE (ref: SeqRec/modules/loss/BPR.py:5,
SeqRec/modules/model_base/seq_model.py:64-82).

Under a model axis the tied table is split by rows (`core/mesh.py`), and
`vocab_parallel_ce_rows` is the fused CE over the ranks' rows: kernel j runs
over this rank's real rows with the targets shifted by its first row (a
target outside them matches nothing), the ranks' lse combine into the global
one and their target logits (lse - nll) sum; the backward runs kernel k with
the global lse and sums the ranks' partial dh.
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
    vocab_shard: tuple | None = None,  # (first row, ModelAxis) of a row-split table
) -> tuple[torch.Tensor, torch.Tensor]:
    """`causal_lm_loss_with_denom` through the fused tied-head CE
    (`ops/fused_ce.py`): the [B, S, V] logits are never stored. With
    `vocab_shard`, `table` is this rank's rows of the table
    (`vocab_parallel_ce_rows`)."""
    from gamer_tpu_torch.ops.fused_ce import fused_ce_rows

    x = hidden[:, :-1, :]
    safe, valid = _shift_targets(labels, row_valid)
    D = x.shape[-1]
    args = (x.reshape(-1, D), table, safe.reshape(-1).to(torch.int32),
            valid.reshape(-1).to(torch.int32), 1.0 / temperature)
    if vocab_shard is not None:
        nll = vocab_parallel_ce_rows(*args, *vocab_shard)
    else:
        nll, _ = fused_ce_rows(*args)
    denom = valid.sum().clamp(min=1)
    return nll.sum() / denom, denom


def vocab_shard_ce(h, table, targets, valid, inv_t: float, v0: int):
    """A rank's part of the vocab-parallel CE: (lse, target logit) [N] of its
    rows `table` (global rows v0..), the target logit 0 where the target is
    not among them. Kernel j (CUDA) or its plain version (CPU)."""
    if table.shape[0] == 0:  # a rank of padded rows only
        lse = torch.full((h.shape[0],), -torch.inf, dtype=torch.float32, device=h.device)
        return lse, torch.zeros_like(lse)
    from gamer_tpu_torch.ops.fused_ce import ce_rows_fwd

    nll, lse = ce_rows_fwd(h, table, (targets.long() - v0).to(torch.int32), valid, inv_t)
    return lse, torch.where(valid == 1, lse - nll, 0.0)


def combine_vocab_shards(parts: torch.Tensor, valid: torch.Tensor):
    """(nll, lse) [N] from the ranks' [n, 2, N] stacks of (lse, target logit)."""
    lse = torch.logsumexp(parts[:, 0], dim=0)
    return torch.where(valid == 1, lse - parts[:, 1].sum(dim=0), 0.0), lse


def vocab_shard_ce_grads(h, table, targets, valid, inv_t: float, v0: int, lse, g):
    """A rank's (partial dh, dtable) of the vocab-parallel CE for the global
    lse. Kernel k (CUDA) or its plain version (CPU)."""
    if table.shape[0] == 0:
        return torch.zeros_like(h), torch.zeros_like(table)
    from gamer_tpu_torch.ops.fused_ce import ce_rows_bwd

    return ce_rows_bwd(h, table, (targets.long() - v0).to(torch.int32), valid, lse, g, inv_t)


class _VocabParallelCE(torch.autograd.Function):
    """The fused CE over a model axis's row blocks of the tied table (see
    the module docstring): one collective forward, one backward."""

    @staticmethod
    def forward(ctx, h, table, targets, valid, inv_t, v0, axis):
        lse, tgt = vocab_shard_ce(h, table, targets, valid, inv_t, v0)
        parts = axis.all_gather(torch.stack([lse, tgt])[None], 0)
        nll, lse = combine_vocab_shards(parts, valid)
        ctx.save_for_backward(h, table, targets, valid, lse)
        ctx.args = (inv_t, v0, axis)
        return nll

    @staticmethod
    def backward(ctx, g):
        h, table, targets, valid, lse = ctx.saved_tensors
        inv_t, v0, axis = ctx.args
        dh, dtable = vocab_shard_ce_grads(h, table, targets, valid, inv_t, v0, lse, g)
        return axis.all_reduce(dh.contiguous()), dtable, None, None, None, None, None


def vocab_parallel_ce_rows(h, table, targets, valid, inv_t: float, v0: int, axis):
    """nll [N] of h [N, D] against the whole tied table, from this rank's
    rows `table` (global rows v0..) and the other ranks' over `axis`."""
    return _VocabParallelCE.apply(h, table, targets, valid, inv_t, v0, axis)


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
