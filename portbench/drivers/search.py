"""Driver of the search cells: the port's compiled trie-constrained beam
search, one client in a closed loop.

Set-up: the item catalog and a pool of prompts from the seed
(`traffic/prompts.py`), the port's trie of the catalog, the port's model
with the benchmark's weights from the seed, and the search object of
`decode/beam.make_beam_search_fn`, captured by two warm-up calls. The
window sends batch after batch of the pool, each with its requests' target
behavior ids, and times each call from the call to its codes and scores on
the host. Every answer of the window is checked against the catalog
(items, no repeats, sorted finite scores); then, with the program freed, the
plain reference re-scores the served beams of a sample of the window's
requests drawn from the seed, the longest prompt among them, and searches
them itself.
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from portbench.drivers.train import device_info, port_config
from portbench.harness import counts, trace, weights
from portbench.reference import model as RM
from portbench.reference import search as RS
from portbench.traffic import prompts as TP


def run(ctx) -> dict:
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.decode.trie import LeveledTrie
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    cuda = dev != "cpu"
    B, K = mix["batch"], mix["num_beams"]
    codes, sizes, bases = TP.catalog(cfg, mix, ctx.seed)
    pool = TP.prompt_pool(cfg, mix, codes, bases, ctx.seed)
    n_pool = len(pool["prompt_len"]) // B
    trie = LeveledTrie.build(codes, sizes, bases)
    pcfg = port_config(cfg, dev)
    model = QwenFamilyModel(pcfg, device=dev, seed=0)
    weights.load(model, weights.make(RM.param_spec(cfg), ctx.seed, dev))
    model.eval()
    call = make_beam_search_fn(model, trie, BeamSearchConfig(num_beams=K))
    ctx.mark("catalog, prompts and model")

    def batch(i: int) -> tuple[dict, np.ndarray]:
        b = TP.rows(pool, (i % n_pool) * B, (i % n_pool + 1) * B)
        return b, b["behavior"]

    for i in range(2):  # capture, then a replay
        b, beh = batch(i)
        c, s = call(b, beh)
        c.cpu(), s.cpu()
    setup_s = ctx.setup_done()

    spans, served, lat = ctx.spans, [], []
    t_start = time.perf_counter()
    i = 0
    while True:
        b, beh = batch(i)
        t = time.perf_counter()
        with spans("search"):
            c, s = call(b, beh)
            c, s = c.cpu().numpy(), s.float().cpu().numpy()
        lat.append(time.perf_counter() - t)
        served.append((i % n_pool, c, s))
        i += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx.mark("window")
    ctx.timings["call ms (min, 50, 95, 99, max)"] = [
        round(float(x), 3) for x in np.percentile(np.asarray(lat) * 1e3, [0, 50, 95, 99, 100])]

    run_view = types.SimpleNamespace(kind="search", step_span="search", cfg=cfg,
                                     window_s=window_s, steps=len(lat), spans=spans.times,
                                     trace=None)
    if ctx.traced:
        run_view.flops = sum(counts.search_flops(cfg, batch(j)[0], K, len(sizes))
                             for j, _, _ in served)
        n = ctx.cell["trace_steps"]

        def segment():
            for j in range(n):
                b, beh = batch(j)
                with spans("search"):
                    c, s = call(b, beh)
                    c.cpu(), s.cpu()

        if cuda:
            run_view.trace = trace.profiled(spans, segment, n)
        ctx.mark("traced segment")

    del call, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = reference_check(ctx, cfg, codes, sizes, bases, pool, served, B)
    ctx.mark("reference")
    return {"e2e": {"search_users_per_s": len(served) * B / window_s,
                    "search_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)),
                    "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
            "checks": checks, "attempted": len(served) * B, "failed": 0,
            "device": device_info(dev, peak), "run": run_view}


def served_invalid(trie: RS.Trie, served, K: int) -> int:
    """Answers of the window that are no item, repeat, or come unsorted or
    not finite, and answers of the wrong shape."""
    bad = 0
    for _, c, s in served:
        if c.shape[1:] != (K, trie.levels) or s.shape != c.shape[:2]:
            bad += c.shape[0]
            continue
        for r in range(c.shape[0]):
            rows = {tuple(x) for x in c[r].tolist()}
            bad += int(len(rows) != K or not rows <= trie.items
                       or not np.all(np.diff(s[r]) <= 0) or not np.isfinite(s[r]).all())
    return bad


def sample(served, pool: dict, B: int, n: int, seed: int) -> list[tuple[int, int]]:
    """(call, row) of `n` requests of the window drawn from the seed, the
    first with the longest prompt."""
    rng = np.random.default_rng([seed, 3])
    picks = {(int(c), int(r)) for c, r in zip(rng.integers(0, len(served), n - 1),
                                               rng.integers(0, B, n - 1))}
    lens = [(pool["prompt_len"][served[c][0] * B + r], c, r)
            for c in range(len(served)) for r in range(B)]
    _, c0, r0 = max(lens)
    return [(c0, r0)] + sorted(picks - {(c0, r0)})


def reference_check(ctx, cfg, codes, sizes, bases, pool, served, B, answers=None) -> dict:
    """The numbers `correct` compares (see `reference/search.py`): answers of
    the window with a beam that is no item or repeats, over every answer;
    the largest score gap and best-beam gap over the sample. `answers` (the
    control) stands in for the program's served codes and scores of the
    sample."""
    dev = ctx.device
    trie = RS.Trie(codes)
    K = ctx.mix["num_beams"]
    invalid = served_invalid(trie, served, K) if answers is None else 0
    params = weights.make(RM.param_spec(cfg), ctx.seed, dev)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    fwd = RM.Forward(params, cfg)
    score_gap = best_gap = 0.0
    try:
        for c, r in sample(served, pool, B, ctx.cell["check_requests"], ctx.seed):
            row = served[c][0] * B + r
            prompt = {k: v[row] for k, v in pool.items()}
            got = (answers(prompt, trie, sizes, bases, K) if answers is not None
                   else (served[c][1][r], served[c][2][r]))
            res = RS.check_user(fwd, cfg, prompt, int(prompt["behavior"]), trie, bases, sizes,
                                np.asarray(got[0]), np.asarray(got[1], np.float64))
            if answers is not None:
                invalid += res["invalid"]
            score_gap = max(score_gap, res["score_gap"])
            best_gap = max(best_gap, res["best_gap"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"invalid_answers": invalid, "score_gap": score_gap, "best_gap": best_gap}
