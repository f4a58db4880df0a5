"""The work counts behind `mfu.*` and `*_roofline.*` against hand counts at
a tiny configuration."""

from __future__ import annotations

import itertools

import numpy as np

from portbench.harness import counts

CFG = dict(hidden_size=8, num_attention_heads=2, num_key_value_heads=1, head_dim=4,
           intermediate_size=6, num_hidden_layers=1, cross_attention_layers=[],
           behavior_injection_layers=[], behavior_embedding_dim=2, vocab_size=10,
           num_experts=3, num_behavior=2, moe_action=False)


def test_dense_layer_flops():
    """One layer: q 8x8, k and v 8x4, o 8x8, one expert 8x6 twice and 6x8,
    the head 8x10, 2 a multiply-add."""
    t = counts._per_token(CFG)
    assert t["attn"] == 2 * (64 + 32 + 32 + 64)
    assert t["moe"] == 2 * (8 * 6 * 2 + 6 * 8)
    assert t["head"] == 2 * 80


def test_causal_pairs_by_hand():
    assert counts.causal_pairs([1, 3, 4]) == 1 + 6 + 10


def test_multi_pairs_brute_force():
    rng = np.random.default_rng(0)
    attn = (np.arange(9)[None] < rng.integers(1, 10, (5, 1))).astype(np.int32)
    acts = rng.integers(1, 4, (5, 9))
    want = sum(1 for b, i, j in itertools.product(range(5), range(9), range(9))
               if attn[b, i] and attn[b, j] and j <= i and acts[b, j] < acts[b, i])
    assert counts.multi_pairs(attn, acts) == want


def test_train_flops_one_expert_a_token():
    """MoeAction counts one expert a token like the plain MoE: its extra
    passes are waste, not work."""
    batch = {"attention_mask": np.array([[1, 1, 1, 0]]), "row_valid": np.array([1]),
             "actions": np.ones((1, 4))}
    t = counts._per_token(CFG)
    want = 3 * (3 * (t["attn"] + t["moe"] + t["head"]) + 6 * 4 * 4 * 2)
    assert counts.train_flops(CFG, batch) == want
    assert counts.train_flops({**CFG, "moe_action": True}, batch) == want


def test_bound_takes_the_larger():
    assert counts.bound_s(3.35e12, 0) == 1.0
    assert counts.bound_s(0, 989e12) == 1.0
