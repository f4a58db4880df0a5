"""Search traffic: an item catalog of semantic IDs and a pool of prompts.

Frozen from `chip_smoke.make_trie_and_prompts` (the port's phase 4
geometry): `n_items` distinct code rows over `levels` levels of `level_size`
codes (token base behavior_base + num_behavior + level_size * level), and
left-padded prompts of whole item blocks [<behavior>, codes] plus the target
behavior token, S = max_blocks * (levels + 1) + 1. Prompt i of the pool has
`max_blocks` blocks when i is even, else a uniform draw in [1, max_blocks);
sessions are sorted draws in [0, 5) a block, actions the block's behavior + 1.
Every request also carries a target behavior id in [1, num_behavior].
"""

from __future__ import annotations

import numpy as np


def catalog(cfg: dict, traffic: dict, seed: int) -> tuple[np.ndarray, list[int], list[int]]:
    """(codes [N, L] 0-based, level sizes, level token bases)."""
    rng = np.random.default_rng([seed, 1])
    L, size = traffic["levels"], traffic["level_size"]
    codes = np.unique(rng.integers(0, size, (traffic["n_items"], L)), axis=0)
    base = cfg["behavior_base"] + cfg["num_behavior"]
    return codes, [size] * L, [base + size * lvl for lvl in range(L)]


def prompt_pool(cfg: dict, traffic: dict, codes: np.ndarray, bases, seed: int) -> dict:
    """The pool's prompts as arrays of `pool` rows."""
    rng = np.random.default_rng([seed, 2])
    n, blocks, L = traffic["pool"], traffic["max_blocks"], traffic["levels"]
    nb, bbase = cfg["num_behavior"], cfg["behavior_base"]
    S = blocks * (L + 1) + 1
    out = {k: np.zeros((n, S), np.int32)
           for k in ("input_ids", "attention_mask", "session_ids", "actions")}
    out["prompt_len"] = np.zeros(n, np.int32)
    for b in range(n):
        k = blocks if b % 2 == 0 else int(rng.integers(1, blocks))
        items = codes[rng.integers(0, len(codes), k)] + np.asarray(bases)
        behs = rng.integers(0, nb, k + 1)
        toks = np.concatenate([np.concatenate([[bbase + behs[i]], items[i]]) for i in range(k)]
                              + [[bbase + behs[-1]]])
        m = len(toks)
        out["input_ids"][b, S - m:] = toks
        out["attention_mask"][b, S - m:] = 1
        out["session_ids"][b, S - m:] = np.repeat(np.sort(rng.integers(0, 5, k + 1)), L + 1)[:m]
        out["actions"][b, S - m:] = np.repeat(behs + 1, L + 1)[:m]
        out["prompt_len"][b] = m
    out["extended_session_ids"] = np.maximum(np.cumsum(out["attention_mask"], 1) - 1,
                                             0).astype(np.int32)
    out["behavior"] = (rng.integers(0, nb, n) + 1).astype(np.int32)
    return out


def rows(pool: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in pool.items()}
