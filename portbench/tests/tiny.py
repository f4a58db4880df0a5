"""Tiny cells for the CPU tests: the benchmark's configurations and traffic
mixes cut to a size the CPU runs in seconds, through the same drivers."""

from __future__ import annotations

import copy

from portbench.harness import manifest

TINY_MODEL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, intermediate_size=96,
                  behavior_embedding_dim=16, vocab_size=81)
TINY_CORPUS = dict(n_users=24, n_items=400, n_clusters=16, level_sizes=[16] * 4, min_len=14,
                   max_len=22, emb_dim=8)


def cell(name: str) -> dict:
    """The cell `name` of BENCHMARK.json at tiny size."""
    c = copy.deepcopy(manifest.cell(name))
    cfg = c["config_values"]
    cfg.update(TINY_MODEL)
    n = cfg["num_hidden_layers"]
    cfg["sparse_layers"] = list(range(n))
    cfg["behavior_injection_layers"] = [0] if cfg["cross_attention_layers"] else list(range(n))
    cfg["cross_attention_layers"] = [1] if cfg["cross_attention_layers"] else []
    mix = c["mix"]
    if mix["driver"] == "train":
        mix["corpus"] = {**mix["corpus"], **TINY_CORPUS}
        mix["max_his_len"] = min(mix["max_his_len"], 6)
        mix["job"] = {**mix["job"], "micro_batch": 8, "epochs": 2}
        c["reference_rows"] = 3
        c["trace_steps"] = 2
    else:
        mix.update(n_items=200, level_size=16, max_blocks=6, pool=4 * mix["batch"], num_beams=4)
        c["check_requests"] = 3
    return c
