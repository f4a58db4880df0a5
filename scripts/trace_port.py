#!/usr/bin/env python3
"""The port's own trace (`gamer_tpu_torch/core/trace.py`) of a benchmark
cell, on one CUDA card.

    python3 scripts/trace_port.py <cell> [--seed N] [--seconds S] [--out DIR]
    python3 scripts/trace_port.py sleep [--out DIR]
    python3 scripts/trace_port.py <cell> --tiny --seconds 1   # rehearsal on the CPU

`<cell>` is a cell of `BENCHMARK.json` (`qwen3multi.train.h100`,
`qwen3moeaction.train.h20`, `qwen3multi.search.b128`), set up as its
portbench driver sets it up (the same corpus or prompts, weights and
trainer or search object from the seed; every shape warmed up and
captured). Then, in one process:

1. four closed-loop windows of `--seconds` each, untraced and traced in
   turn (tracing on, marks off: the window replays the graphs an untraced
   run captures): tokens or users a second and the calls' p95 of each, the
   cost of tracing; the traced windows' snapshots: host spans
   (`data.collate`, `train.step` less its `stage.wait`), the steps' gaps,
   their share and the span each is attributed to;
2. a profiled segment (`torch.profiler`, tracing off): the device time a
   step, the `attn` and `moe` kernel groups' time (portbench's patterns);
3. a marked segment (`trace.set_marking(True)`): one accumulation cycle (a
   search call) captures the marked graphs, then `max(k, trace_steps)`
   replayed micro-steps (`trace_steps` calls) are read by section.

`sleep` replays a small graph with a 10 ms host sleep after each synchronized
step and reads the sleep back as the gap share. The result is one JSON line
(and `<out>/<cell>.json`, default `runs/trace/`). `--tiny` runs the
cell at portbench's CPU test size on the CPU, without the profiled segment.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gamer_tpu_torch.core import trace  # noqa: E402

DEV = torch.device("cuda")


def sync() -> None:
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def _window(call, seconds: float, traced: bool) -> dict:
    """`call()` (returns the units it served) in a closed loop for
    `seconds`, traced or not; rate, p95 of the calls, the snapshot."""
    if traced:
        trace.enable()
        trace.reset()
    units, lat = 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        units += call()
        lat.append(time.perf_counter() - t)
    sync()
    wall = time.perf_counter() - t0
    out = {"traced": traced, "rate": units / wall, "calls": len(lat),
           "p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))}
    if traced:
        out["snapshot"] = trace.snapshot()
        trace.disable()
    return out


def _profiled(segment, steps: int, label: str) -> dict:
    """The device time a step of `segment` under torch.profiler: the
    operations' summed time, each step's span from its first operation to
    its last, and the `attn` and `moe` groups' time."""
    from portbench.harness import manifest
    from portbench.harness import trace as PT

    spans = PT.Spans(True)
    tr = PT.profiled(spans, lambda: segment(spans), steps)
    starts = sorted(a for n, a, _ in tr.spans if n == label)
    per = [[] for _ in starts]
    for _, a, b in tr.ops:
        i = int(np.searchsorted(starts, a, side="right")) - 1
        if i >= 0:
            per[i].append((a, b))
    span_ms = [(max(b for _, b in p) - min(a for a, _ in p)) / 1e3 for p in per if p]
    return {"ops_ms": sum(b - a for _, a, b in tr.ops) / 1e3 / steps,
            "span_ms": sum(span_ms) / len(span_ms),
            "attn_ms": 1e3 * tr.group_s(manifest.patterns("attn")) / steps,
            "moe_ms": 1e3 * tr.group_s(manifest.patterns("moe")) / steps}


def _marked(warm, read) -> dict:
    """Marks on: `warm()` captures the marked graphs, `read()` replays them;
    the snapshot of `read` alone."""
    trace.enable()
    trace.set_marking(True)
    warm()
    sync()
    trace.reset()
    read()
    snap = trace.snapshot()
    trace.set_marking(False)
    trace.disable()
    return snap


def train_cell(cell: dict, seed: int, seconds: float) -> dict:
    from gamer_tpu_torch import native
    from gamer_tpu_torch.data.batching import DecoderBatcher
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig
    from portbench.drivers.train import TASK_PAD, _feed, examples, port_config
    from portbench.harness import weights
    from portbench.reference import model as RM

    cfg, mix = cell["config_values"], cell["mix"]
    job = mix["job"]
    with tempfile.TemporaryDirectory(prefix="trace_port_") as root:
        train, valid, vocab = examples(mix, root, seed)
    P = cfg["num_positions"]
    seq_len = DecoderBatcher.for_examples(
        train + valid, pad_multiple=P * TASK_PAD // math.gcd(P, TASK_PAD)).seq_len
    micro, k = job["micro_batch"], job["accumulation"]
    pcfg = port_config(cfg, DEV.type)
    model = QwenFamilyModel(pcfg, device=DEV, seed=0)
    weights.load(model, weights.make(RM.param_spec(cfg), seed, DEV))
    trainer = Trainer(make_loss_fn(model, pcfg, deterministic=False), model,
                      OptimizerConfig(learning_rate=job["learning_rate"],
                                      weight_decay=job["weight_decay"],
                                      warmup_ratio=job["warmup_ratio"], lr_scheduler_type="cosine",
                                      max_grad_norm=job["max_grad_norm"], adam_b1=job["adam_b1"],
                                      adam_b2=job["adam_b2"], adam_eps=job["adam_eps"],
                                      total_steps=max(len(train) // (micro * k), 1)
                                      * job["epochs"]),
                      TrainLoopConfig(seed=seed, gradient_accumulation_steps=k))
    store = native.ExampleStore(train, vocab.behavior_token_ids)
    feed = _feed(store, micro, seq_len, seed)
    for _ in range(cell["check_updates"] * k):
        trainer.train_step(next(feed))
    sync()
    graphs = trainer.graphs

    def call():
        batch = next(feed)
        trainer.train_step(batch)
        return int((batch["attention_mask"] * batch["row_valid"][:, None]).sum())

    windows = [_window(call, seconds, traced) for traced in (False, True, False, True)]
    n = max(k, cell["trace_steps"])
    batches = [next(feed) for _ in range(n)]

    def segment(spans):
        for b in batches:
            with spans("train_step"):
                trainer.train_step(b)

    prof = _profiled(segment, n, "train_step") if DEV.type == "cuda" else None
    marked = _marked(lambda: [trainer.train_step(next(feed)) for _ in range(k)],
                     lambda: [trainer.train_step(b) for b in batches])
    return {"windows": windows, "profiled": prof, "marked": marked, "micro_steps": n,
            "graphs": [graphs, trainer.graphs], "graph_counts": trace.graph_counts()}


def search_cell(cell: dict, seed: int, seconds: float) -> dict:
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.decode.trie import LeveledTrie
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from portbench.drivers.train import port_config
    from portbench.harness import weights
    from portbench.reference import model as RM
    from portbench.traffic import prompts as TP

    cfg, mix = cell["config_values"], cell["mix"]
    B, K = mix["batch"], mix["num_beams"]
    codes, sizes, bases = TP.catalog(cfg, mix, seed)
    pool = TP.prompt_pool(cfg, mix, codes, bases, seed)
    n_pool = len(pool["prompt_len"]) // B
    model = QwenFamilyModel(port_config(cfg, DEV.type), device=DEV, seed=0)
    weights.load(model, weights.make(RM.param_spec(cfg), seed, DEV))
    model.eval()
    search = make_beam_search_fn(model, LeveledTrie.build(codes, sizes, bases),
                                 BeamSearchConfig(num_beams=K))
    turn = [0]

    def call():
        i = turn[0] % n_pool
        turn[0] += 1
        b = TP.rows(pool, i * B, (i + 1) * B)
        c, s = search(b, b["behavior"])
        c.cpu(), s.cpu()
        return B

    for _ in range(2):
        call()
    windows = [_window(call, seconds, traced) for traced in (False, True, False, True)]
    n = cell["trace_steps"]

    def segment(spans):
        for _ in range(n):
            with spans("search"):
                call()

    prof = _profiled(segment, n, "search") if DEV.type == "cuda" else None
    marked = _marked(call, lambda: [call() for _ in range(n)])
    return {"windows": windows, "profiled": prof, "marked": marked, "calls": n,
            "graphs": search.graphs, "graph_counts": trace.graph_counts()}


def sleep_probe() -> dict:
    """20 replays of a ~5 ms graph, each step synchronized, then a 10 ms
    host sleep: the gaps read the sleeps."""
    from gamer_tpu_torch.core.graphs import GraphCache

    dev = torch.device("cuda")
    x = torch.randn(4096, 4096, device=dev)
    cache = GraphCache(dev, "sleep probe")

    def fn():
        y = x
        for _ in range(2):
            y = y @ x
        return y.sum()

    cache.run("k", fn)
    torch.cuda.synchronize()
    trace.enable()
    trace.reset()
    for _ in range(20):
        with trace.step("probe", dev):
            cache.run("k", fn)
        torch.cuda.synchronize()
        with trace.span("sleep"):
            time.sleep(0.01)
    snap = trace.snapshot()
    trace.disable()
    st, sp = snap["steps"]["probe"], snap["spans"]["sleep"]
    # 19 sleeps between 20 steps, over the span from the first start to the last end
    return {"steps": st, "sleep": sp, "expected_gap_ms": 19 * sp["mean_ms"],
            "expected_share": 19 * sp["mean_ms"] / (19 * sp["mean_ms"] + 20 * st["device_mean_ms"])}


def span_cost() -> dict:
    """Host ns of one `with trace.span(...)` off and on."""
    out = {}
    for on in (False, True):
        trace.enable() if on else trace.disable()
        trace.reset()
        n = 100_000
        t = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("x"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t) / n
    trace.disable()
    trace.reset()
    return out


def summary(name: str, res: dict) -> dict:
    """The readings the per-layer metrics of this cell would report."""
    if name == "sleep":
        return {"gap_share": 100 * res["steps"]["gaps"]["share"],
                "expected_share": 100 * res["expected_share"],
                "gap_ms": res["steps"]["gaps"]["ms"], "expected_gap_ms": res["expected_gap_ms"],
                "by_span": res["steps"]["gaps"]["by_span"]}
    win = res["windows"]
    off = [w for w in win if not w["traced"]]
    on = [w for w in win if w["traced"]]
    owner = "search.call" if "calls" in res else "train.step"
    snaps = [w["snapshot"] for w in on]
    out = {"rate_off": [w["rate"] for w in off], "rate_on": [w["rate"] for w in on],
           "p95_off": [w["p95_ms"] for w in off], "p95_on": [w["p95_ms"] for w in on],
           "gap_share": [100 * s["steps"][owner]["gaps"]["share"] for s in snaps],
           "gaps_by_span": [s["steps"][owner]["gaps"]["by_span"] for s in snaps],
           "device_step_ms": [s["steps"][owner]["device_mean_ms"] for s in snaps],
           "profiled": res["profiled"]}
    if owner == "train.step":
        out["host_collate_ms"] = [s["spans"]["data.collate"]["mean_ms"] for s in snaps]
        out["step_host_ms"] = [s["spans"]["train.step"]["mean_ms"] for s in snaps]
        out["host_busy_ms"] = [s["spans"]["train.step"]["own_mean_ms"] for s in snaps]
        out["stage_wait_ms"] = [s["spans"].get("stage.wait", {}).get("mean_ms", 0.0)
                                for s in snaps]
    sec = res["marked"]["sections"].get(owner)
    if sec:
        ms = sec["ms"]
        both = lambda n: ms.get(n, 0.0) + ms.get(n + ".bwd", 0.0)  # noqa: E731
        out["sections"] = ms
        out["marked_steps"] = sec["steps"]
        out["marked_sum_ms"] = sum(ms.values())
        if owner == "train.step":
            out.update(self_attn_ms=both("self_attn"), cross_attn_ms=both("cross_attn"),
                       mlp_ms=both("mlp"), head_ms=both("inputs") + both("embed") + both("head"),
                       update_ms=ms.get("update", 0.0), unmarked_ms=ms.get(trace.UNMARKED, 0.0))
        else:
            out.update(prefill_ms=ms.get("prefill", 0.0), decode_ms=ms.get("decode", 0.0),
                       unmarked_ms=ms.get(trace.UNMARKED, 0.0))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cell")
    p.add_argument("--seed", type=int, default=3000000017)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=os.path.join(ROOT, "runs", "trace"))
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    global DEV
    if args.tiny:
        DEV = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("trace_port: needs a CUDA card (or --tiny)", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    if args.cell == "sleep":
        res = sleep_probe()
        res["span_ns"] = span_cost()
    else:
        from portbench.harness import manifest
        from portbench.tests import tiny

        cell = tiny.cell(args.cell) if args.tiny else manifest.cell(args.cell)
        run = search_cell if cell["mix"]["driver"] == "search" else train_cell
        res = run(cell, args.seed, args.seconds)
    res["summary"] = summary(args.cell, res)
    res["card"] = torch.cuda.get_device_name(0) if DEV.type == "cuda" else "cpu"
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.cell}.json"), "w") as f:
        json.dump(res, f, indent=1)
    s = res["summary"]
    if "rate_off" in s:
        s["cost_pct"] = 100 * (1 - statistics.mean(s["rate_on"]) / statistics.mean(s["rate_off"]))
    print(json.dumps({"cell": args.cell, **s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
