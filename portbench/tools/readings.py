#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, for one cell.

    python3 portbench/tools/readings.py <cell> <program seeds> <control seeds> [--seconds s]

Seeds are comma-separated. For each program seed, one run of the cell (a
short window) gives the numbers the program reads when it is sound. For each
control seed: the plain reference put in the program's place in fp8 (the
precision below the configuration's bf16), compared with the fp32 reference
by the same numbers; for a training cell also the faults of half the batch
left out (the mean over the other half) and of a state left unchanged,
planted in the reference; for a search cell also the program itself with
the fault of suboptimal beams planted (`tools/faults.py`).
Prints one JSON line a reading, and a summary last. On the CPU (no card) it
runs the tiny cells of the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.drivers import search as DS  # noqa: E402
from portbench.drivers import train as DT  # noqa: E402
from portbench.harness import manifest, weights  # noqa: E402
from portbench.reference import model as RM  # noqa: E402
from portbench.reference import search as RS  # noqa: E402
from portbench.reference import train as RT  # noqa: E402
from portbench.tools import faults  # noqa: E402


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def train_controls(cell: dict, seed: int, device: str) -> dict:
    """{control or fault: the cell's numbers} for one seed."""
    import math
    import shutil
    import tempfile

    ctx = run.Context(cell, seed, 0.0, False, device)
    mix, job, cfg = ctx.mix, ctx.mix["job"], ctx.cfg
    root = tempfile.mkdtemp(prefix="portbench_")
    try:
        train, valid, vocab = DT.examples(mix, root, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    from gamer_tpu_torch.data.batching import DecoderBatcher

    P = cfg["num_positions"]
    seq_len = DecoderBatcher.for_examples(
        train + valid, pad_multiple=P * DT.TASK_PAD // math.gcd(P, DT.TASK_PAD)).seq_len
    micro, k = job["micro_batch"], job["accumulation"]
    total = max(len(train) // (micro * k), 1) * job["epochs"]
    mb = RT.micro_batches(DT.plain_examples(train), micro, seq_len, vocab.behavior_token_ids,
                          seed, cell["check_updates"] * k)
    start = weights.make(RM.param_spec(cfg), seed, device)
    _no_tf32()
    follow = lambda batches, quant=None: RT.follow(start, cfg, job, batches, seed, total,
                                                   device, cell["reference_rows"], quant)
    ref = follow(mb)
    half = [{f: v[:micro // 2] for f, v in b.items()} for b in mb]
    out = {"control fp8": RT.compare(follow(mb, "fp8"), ref, start),
           "half the batch": RT.compare(follow(half), ref, start),
           "state unchanged": RT.compare({**ref, "params": start}, ref, start)}
    return out


def search_control(cell: dict, seed: int, device: str) -> dict:
    """The cell's numbers of the fp8 reference search in the program's place,
    on a sample of the pool's requests drawn as a run draws it."""
    from portbench.traffic import prompts as TP

    ctx = run.Context(cell, seed, 0.0, False, device)
    codes, sizes, bases = TP.catalog(ctx.cfg, ctx.mix, seed)
    pool = TP.prompt_pool(ctx.cfg, ctx.mix, codes, bases, seed)
    fwd8 = RM.Forward(weights.make(RM.param_spec(ctx.cfg), seed, device), ctx.cfg, "fp8")

    def answers(prompt, trie, sz, bs, K):
        c, s = RS.search(fwd8, ctx.cfg, prompt, int(prompt["behavior"]), trie, bs, sz, K)
        return c.cpu().numpy(), s.cpu().numpy()

    B = ctx.mix["batch"]
    served = [(j, None, None) for j in range(len(pool["prompt_len"]) // B)]
    _no_tf32()
    return DS.reference_check(ctx, ctx.cfg, codes, sizes, bases, pool, served, B, answers=answers)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("cell")
    p.add_argument("seeds")
    p.add_argument("control_seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cpu":
        from portbench.tests import tiny

        cell = tiny.cell(args.cell)
    else:
        cell = manifest.cell(args.cell)
    bench = manifest.benchmark()
    prog, ctrl = [], []
    for s in [int(x) for x in args.seeds.split(",") if x]:
        res = run.execute(cell, s, args.seconds, False, device, bench, start=time.perf_counter())
        line = {"seed": s, "program": {n: c["value"] for n, c in res["checks"].items()}}
        prog.append(line["program"])
        print(json.dumps(line), flush=True)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        if cell["mix"]["driver"] == "train":
            line = {"seed": s, **train_controls(cell, s, device)}
        else:
            line = {"seed": s, "control fp8": search_control(cell, s, device)}
            with faults.patched("search", "suboptimal beams"):
                res = run.execute(cell, s, args.seconds, False, device, bench,
                                  start=time.perf_counter())
            line["suboptimal beams"] = {n: c["value"] for n, c in res["checks"].items()}
        ctrl.append(line)
        print(json.dumps(line), flush=True)
    summary = {"cell": args.cell, "device": torch.cuda.get_device_name(0) if device == "cuda"
               else "cpu", "lower": {n: max(p[n] for p in prog) for n in prog[0]} if prog else {},
               "controls": {k: {n: min(c[k][n] for c in ctrl) for n in ctrl[0][k]}
                            for k in (ctrl[0] if ctrl else {}) if k != "seed"}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
