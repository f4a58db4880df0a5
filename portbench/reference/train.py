"""Plain reference of the training path: collation, the micro-steps' loss and
gradients, gradient accumulation, the clipped AdamW update and its schedule.

Collation (a decoder batch of examples at one sequence length): each row is
the example's prompt then its target blocks, right-padded with 0 to `seq_len`;
`attention_mask` 1 on real tokens; `labels` the row with -100 at padding, at
behavior tokens and, for valid examples, over the prompt; the per-token
streams right-padded (`actions` with 100, `time` with -1); `row_valid` 0 on
the rows that fill a short last batch (which repeat the batch's first
example). Micro-batches come in the order of a shuffle of the examples by
`numpy.random.default_rng(loop seed + epoch)`, epochs cycling.

The loss of a micro-batch is the mean over valid targets of the next-token
cross-entropy of logits / temperature. Its gradient is taken in blocks of
rows (each block's summed loss over the micro-batch's valid count), so the
step fits beside nothing. `accumulation` micro-steps make one update: the
mean of their gradients, clipped to global norm `max_grad_norm`, then
AdamW (decoupled weight decay on every tensor but the norms) at the learning
rate of a linear warm-up over `warmup_ratio` of `total_updates`, then a
cosine decay to 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import model as M

IGNORE = -100
PADS = {"session_ids": 0, "extended_session_ids": 0, "actions": 100, "time": -1.0}


def collate(examples: list[dict], indices, seq_len: int, behavior_tokens) -> dict:
    """The decoder batch of `examples[i]` for i in `indices` (numpy)."""
    B = len(indices)
    batch = {"input_ids": np.zeros((B, seq_len), np.int32),
             "attention_mask": np.zeros((B, seq_len), np.int32),
             "labels": np.full((B, seq_len), IGNORE, np.int32),
             "row_valid": np.ones(B, np.int32)}
    for f, pad in PADS.items():
        batch[f] = np.full((B, seq_len), pad, np.float32 if f == "time" else np.int32)
    beh = set(int(t) for t in behavior_tokens)
    for r, i in enumerate(indices):
        ex = examples[i]
        row = np.concatenate([ex["prompt"], ex["targets"].reshape(-1)])[:seq_len]
        n = len(row)
        batch["input_ids"][r, :n] = row
        batch["attention_mask"][r, :n] = 1
        lab = row.astype(np.int64).copy()
        lab[[int(t) in beh for t in row]] = IGNORE
        if ex["split"] == "valid":
            lab[:len(ex["prompt"])] = IGNORE
        batch["labels"][r, :n] = lab
        for f in PADS:
            v = np.asarray(ex[f])[:seq_len]
            batch[f][r, :len(v)] = v
    return batch


def micro_batches(examples: list[dict], micro: int, seq_len: int, behavior_tokens,
                  loop_seed: int, count: int):
    """The first `count` micro-batches of the shuffled epochs."""
    out, epoch = [], 0
    while len(out) < count:
        order = np.arange(len(examples))
        np.random.default_rng(loop_seed + epoch).shuffle(order)
        for s in range(0, len(order), micro):
            idx = order[s:s + micro]
            n = len(idx)
            if n < micro:
                idx = np.concatenate([idx, np.full(micro - n, idx[0])])
            b = collate(examples, idx, seq_len, behavior_tokens)
            b["row_valid"] = (np.arange(micro) < n).astype(np.int32)
            out.append(b)
            if len(out) == count:
                break
        epoch += 1
    return out


def loss_and_grads(params: dict, cfg: dict, batch: dict, seeds, rows: int, device,
                   quant=None) -> tuple[float, dict]:
    """(loss, grads) of one micro-batch, in blocks of `rows` rows."""
    t = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
    labels = t["labels"].long()
    valid = (labels[:, 1:] != IGNORE) & (t["row_valid"][:, None] == 1)
    denom = max(int(valid.sum()), 1)
    leaves = {n: p.detach().clone().requires_grad_(True) for n, p in params.items()}
    fwd = M.Forward(leaves, cfg, quant)
    total = 0.0
    inv_t = 1.0 / cfg["temperature"]
    for r0 in range(0, labels.shape[0], rows):
        sl = slice(r0, r0 + rows)
        ids, attn = t["input_ids"][sl], t["attention_mask"][sl]
        position, behavior, action, routes = M.route(cfg, ids, attn)
        self_allowed, cross_allowed = M.train_masks(cfg, attn, t["actions"][sl])
        S = ids.shape[1]
        positions = torch.arange(S, device=device)[None].expand(ids.shape[0], S)
        hidden = fwd(ids, positions, self_allowed, cross_allowed, routes, behavior, action,
                     seeds, r0)
        logits = fwd.logits(hidden[:, :-1]) * inv_t
        v = valid[sl]
        tgt = torch.where(v, labels[sl, 1:], 0)
        nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, tgt[..., None])[..., 0]
        part = torch.where(v, nll, 0.0).sum() / denom
        part.backward()
        total += float(part.detach())
    return total, {n: p.grad for n, p in leaves.items()}


def lr_at(job: dict, total_updates: int, count: int) -> float:
    """The learning rate of update `count` (0-based)."""
    peak = job["learning_rate"]
    warm = int(job["warmup_ratio"] * total_updates)
    if count < warm:
        return peak * count / warm
    decay = max(total_updates - warm, 1)
    t = min(count - warm, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def decayed(name: str) -> bool:
    """AdamW decays every tensor but the norms' scales."""
    return not (name.endswith("norm.weight") or name.endswith("layernorm.weight"))


class AdamW:
    def __init__(self, params: dict, job: dict, total_updates: int):
        self.p = {n: p.detach().clone() for n, p in params.items()}
        self.m = {n: torch.zeros_like(p) for n, p in self.p.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.p.items()}
        self.job, self.total, self.count = job, total_updates, 0

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        """Clip, then one AdamW step; returns the clipped gradients."""
        job = self.job
        b1, b2, eps, wd = job["adam_b1"], job["adam_b2"], job["adam_eps"], job["weight_decay"]
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        scale = job["max_grad_norm"] / norm if norm >= job["max_grad_norm"] else 1.0
        lr = lr_at(job, self.total, self.count)
        self.count += 1
        clipped = {}
        for n, g in grads.items():
            g = g * scale
            clipped[n] = g
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (self.m[n] / (1 - b1 ** self.count)) / ((self.v[n] / (1 - b2 ** self.count)).sqrt()
                                                         + eps)
            if decayed(n):
                u = u + wd * self.p[n]
            self.p[n].sub_(lr * u)
        return clipped


def follow(params: dict, cfg: dict, job: dict, batches: list[dict], loop_seed: int,
           total_updates: int, device, rows: int, quant=None) -> dict:
    """The reference's first updates over `batches` (accumulation micro-batches
    an update): every micro-step's loss, the first update's clipped gradient
    and the parameters after the last update."""
    k = job["accumulation"]
    opt = AdamW(params, job, total_updates)
    n_sites = M.dropout_sites(cfg)
    losses, first_grad, acc = [], None, None
    for step, batch in enumerate(batches):
        seeds = M.site_seeds(loop_seed, step, n_sites)
        loss, grads = loss_and_grads(opt.p, cfg, batch, seeds, rows, device, quant)
        losses.append(loss)
        acc = grads if acc is None else {n: acc[n] + grads[n] for n in acc}
        if step % k == k - 1:
            clipped = opt.update({n: g / k for n, g in acc.items()})
            if first_grad is None:
                first_grad = clipped
            acc = None
    return {"losses": losses, "grad": first_grad, "params": opt.p}


def compare(prog: dict, ref: dict, start: dict) -> dict:
    """The numbers `correct` compares: the largest relative gap of a
    micro-step's loss; by the worst leaf, the gap between the program's and
    the reference's norm of the first gradient and of the parameters' change,
    over the larger of the reference leaf's norm and the median leaf's.
    Leaves whose reference gradient norm is under a thousandth of the median
    leaf's (nought to rounding) are left out of both."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    gnorm = {n: float(g.double().norm()) for n, g in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    leaves = [n for n, v in gnorm.items() if v >= 1e-3 * med]

    def worst(p_norms, r_norms):
        m = float(np.median([r_norms[n] for n in leaves]))
        return max(abs(p_norms[n] - r_norms[n]) / max(r_norms[n], m, 1e-30) for n in leaves)

    pg = {n: float(prog["grad"][n].double().norm()) for n in leaves}
    dp = {n: float((prog["params"][n].double() - start[n].double()).norm()) for n in leaves}
    dr = {n: float((ref["params"][n].double() - start[n].double()).norm()) for n in leaves}
    return {"loss_gap": loss_gap, "grad_gap": worst(pg, gnorm), "change_gap": worst(dp, dr)}
