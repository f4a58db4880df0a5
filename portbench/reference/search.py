"""Plain reference of the trie-constrained beam search over semantic IDs.

A user's prompt is a left-padded row of whole item blocks and a behavior
token; an answer is `num_beams` items of `L` code levels, each with its
score. Level l's log-probabilities are the model's logits over level l's
token range, renormalized by a log-softmax over the codes that the trie
allows after the beam's prefix; a beam's score is the sum over its levels.
The level-0 logits are the last prompt position's; the code chosen at level
l is then appended as the next token (rope position S + l, block position
(prompt length + l) mod P + 1, behavior and action ids the request's target
behavior). Appended tokens attend to the real prompt tokens and to each other
causally; their cross-attention row is the last prompt token's, which never
reaches an appended token.

The reference recomputes the whole sequence at every level (no cache);
`search` keeps the `num_beams` best partial beams at every level (the
control's search, and the best beam that a served one is held against).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as M


class Trie:
    """Allowed next codes after each prefix of the item code rows."""

    def __init__(self, codes: np.ndarray):
        self.levels = codes.shape[1]
        self.next: dict[tuple, list[int]] = {}
        for row in {tuple(int(c) for c in r) for r in codes}:
            for lvl in range(self.levels):
                self.next.setdefault(row[:lvl], set()).add(row[lvl])
        self.next = {k: sorted(v) for k, v in self.next.items()}
        self.items = {tuple(int(c) for c in r) for r in codes}

    def allowed(self, prefix: tuple, size: int, device) -> torch.Tensor:
        mask = torch.zeros(size, dtype=torch.bool, device=device)
        mask[self.next.get(prefix, [])] = True
        return mask


def _inputs(cfg: dict, prompt: dict, beh: int, codes: torch.Tensor, bases):
    """Model inputs of R rows: the prompt then `codes` [R, g] as tokens."""
    dev = codes.device
    R, g = codes.shape
    ids0 = torch.as_tensor(prompt["input_ids"], device=dev)[None].expand(R, -1).long()
    attn0 = torch.as_tensor(prompt["attention_mask"], device=dev)[None].expand(R, -1).long()
    act0 = torch.as_tensor(prompt["actions"], device=dev)[None].expand(R, -1).long()
    S = ids0.shape[1]
    toks = codes + torch.as_tensor(bases[:g], device=dev)[None]
    ids = torch.cat([ids0, toks], 1)
    position, behavior, action, _ = M.route(cfg, ids0, attn0)
    steps = torch.arange(g, device=dev)
    gpos = ((int(prompt["prompt_len"]) + steps) % cfg["num_positions"] + 1)[None].expand(R, g)
    gbeh = torch.full((R, g), beh, device=dev)
    position = torch.cat([position, gpos], 1)
    behavior = torch.cat([behavior, gbeh], 1)
    action = torch.cat([action, gbeh], 1)
    routes = M.experts(cfg, position, action)
    T = S + g
    real = torch.cat([attn0 == 1, torch.ones(R, g, dtype=torch.bool, device=dev)], 1)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None]
    self_allowed = causal & real[:, None, :]
    cross_allowed = None
    if cfg["cross_attention_layers"]:
        acts = torch.cat([act0, gbeh], 1)
        cross = causal & (acts[:, None, :] < acts[:, :, None]) & real[:, None, :]
        cross[:, :, S:] = False
        cross[:, S:, :S] = cross[:, S - 1:S, :S]
        cross_allowed = cross
    positions = torch.arange(T, device=dev)[None].expand(R, T)
    return ids, positions, self_allowed, cross_allowed, routes, behavior, action


def level_logits(fwd: M.Forward, cfg: dict, prompt: dict, beh: int, codes: torch.Tensor,
                 bases) -> torch.Tensor:
    """[R, g + 1, V] logits at the last prompt position and each appended token."""
    S = len(prompt["input_ids"])
    hidden = fwd(*_inputs(cfg, prompt, beh, codes, bases))
    return fwd.logits(hidden[:, S - 1:])


def _logp(logits: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    masked = torch.where(allowed, logits.float(), -torch.inf)
    return torch.where(allowed, torch.log_softmax(masked, -1), -torch.inf)


@torch.no_grad()
def score(fwd: M.Forward, cfg: dict, prompt: dict, beh: int, codes: torch.Tensor, trie: Trie,
          bases, sizes) -> torch.Tensor:
    """[R] scores of the given beams `codes` [R, L] (teacher-forced)."""
    R, L = codes.shape
    logits = level_logits(fwd, cfg, prompt, beh, codes[:, :L - 1], bases)
    total = torch.zeros(R, dtype=torch.float64, device=codes.device)
    for r in range(R):
        row = tuple(int(c) for c in codes[r])
        for lvl in range(L):
            allowed = trie.allowed(row[:lvl], sizes[lvl], codes.device)
            lp = _logp(logits[r, lvl, bases[lvl]:bases[lvl] + sizes[lvl]], allowed)
            total[r] += float(lp[row[lvl]])
    return total


@torch.no_grad()
def search(fwd: M.Forward, cfg: dict, prompt: dict, beh: int, trie: Trie, bases, sizes,
           beams: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes [beams, L], scores [beams]) of the reference's beam search."""
    dev = fwd.p["embed_tokens.weight"].device
    L = trie.levels
    codes = torch.zeros(1, 0, dtype=torch.long, device=dev)
    scores = torch.zeros(1, dtype=torch.float64, device=dev)
    for lvl in range(L):
        logits = level_logits(fwd, cfg, prompt, beh, codes, bases)[:, -1]
        cand = []
        for r in range(codes.shape[0]):
            prefix = tuple(int(c) for c in codes[r])
            allowed = trie.allowed(prefix, sizes[lvl], dev)
            lp = _logp(logits[r, bases[lvl]:bases[lvl] + sizes[lvl]], allowed).double()
            cand.append(scores[r] + lp)
        total = torch.stack(cand).reshape(-1)
        top = torch.topk(total, min(beams, int(torch.isfinite(total).sum())))
        parent, code = top.indices // sizes[lvl], top.indices % sizes[lvl]
        codes = torch.cat([codes[parent], code[:, None]], 1)
        scores = top.values
    return codes, scores


def check_user(fwd: M.Forward, cfg: dict, prompt: dict, beh: int, trie: Trie, bases, sizes,
               codes: np.ndarray, scores: np.ndarray) -> dict:
    """One request's numbers: beams that are no item, repeat one another or
    come unsorted (`invalid`); the largest gap between a served score and
    the reference's score of the same beam (`score_gap`, nats); and how far
    the best served beam, scored by the reference, falls below the best beam
    of the reference's own search (`best_gap`, nats, 0 where it is as good):
    it catches a search that serves valid beams, honestly scored, that are
    not the best it could find."""
    dev = fwd.p["embed_tokens.weight"].device
    rows = [tuple(int(c) for c in r) for r in codes]
    invalid = sum(r not in trie.items for r in rows) + (len(rows) - len(set(rows)))
    invalid += int(not np.all(np.diff(scores) <= 0)) + int(not np.isfinite(scores).all())
    ref = score(fwd, cfg, prompt, beh, torch.as_tensor(codes, device=dev).long(), trie, bases,
                sizes).cpu().numpy()
    if not np.isfinite(ref).all():
        return {"invalid": invalid, "score_gap": float("inf"), "best_gap": float("inf")}
    _, best = search(fwd, cfg, prompt, beh, trie, bases, sizes, len(rows))
    return {"invalid": invalid, "score_gap": float(np.max(np.abs(scores - ref))),
            "best_gap": max(0.0, float(best[0]) - float(ref.max()))}
