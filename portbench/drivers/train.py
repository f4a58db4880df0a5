"""Driver of the training cells: the port's training job, closed loop.

Set-up: the synthetic corpus of the traffic mix from the seed (under
TMPDIR), the task's examples by the port's data plane, the port's model
with the benchmark's weights from the seed, and `Trainer` (AdamW and its
schedule as the task sets them; the step captured as CUDA graphs). The
first `check_updates` updates run through the window's own feed and call
(`native.ExampleStore` micro-batches, shuffled epochs from the seed, then
`Trainer.train_step`); they warm up and capture every shape, and the
driver keeps their micro-batches, losses, the optimizer's first moments
after the first update and the parameters after the last. The window goes
on with the same trainer and feed for `--seconds`; its throughput counts
the real input tokens of every micro-step, over the window closed by a
synchronize. Then, with the program freed, the plain reference collates the
same micro-batches from the examples and follows the same updates.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
import types

import numpy as np
import torch

from portbench.harness import counts, trace, weights
from portbench.reference import model as RM
from portbench.reference import train as RT

TASK_PAD = 8  # the decoder tasks pad S to a multiple of lcm(tokens a block, 8)


def port_config(cfg: dict, device: str):
    """The port's config of a benchmark configuration: the file's values,
    bf16 on the card (fp32 on the CPU), the kernels' path."""
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig, build_config

    fields = QwenFamilyConfig.field_names()
    values = {k: v for k, v in cfg.items() if k in fields}
    values["dtype"] = cfg["dtype"] if device != "cpu" else "float32"
    return build_config(cfg["backbone"], **values)


def examples(mix: dict, root: str, seed: int):
    """(train examples, valid examples, vocab) of the mix's task, by the port."""
    from portbench.traffic.synthetic import SyntheticSpec, write_synthetic_dataset

    spec = dict(mix["corpus"])
    spec["level_sizes"] = tuple(spec["level_sizes"])
    write_synthetic_dataset(root, "Synth", SyntheticSpec(**spec, seed=seed))
    task = mix["task"]
    if task.startswith("smb"):
        from gamer_tpu_torch.data.loading_smb import load_smb_train

        data = load_smb_train("Synth", root, mix["max_his_len"], ".index.json", task)
        return data.train, data.valid, data.corpus.vocab
    from gamer_tpu_torch.tasks.train_mb_decoder import load_mb_train

    corpus, _, train, valid = load_mb_train("Synth", root, mix["max_his_len"], ".index.json",
                                            task, False)
    return train, valid, corpus.vocab


def plain_examples(exs) -> list[dict]:
    return [{"prompt": np.asarray(e.prompt), "targets": np.asarray(e.targets),
             "session_ids": e.session_ids, "extended_session_ids": e.extended_session_ids,
             "actions": e.actions, "time": e.time, "split": e.split} for e in exs]


def _feed(store, micro: int, seq_len: int, seed: int):
    epoch = 0
    while True:
        yield from store.iterate(micro, seq_len, shuffle=True, seed=seed + epoch)
        epoch += 1


def device_info(device: str, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}


def run(ctx) -> dict:
    from gamer_tpu_torch import native
    from gamer_tpu_torch.data.batching import DecoderBatcher
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg, mix, job, dev = ctx.cfg, ctx.mix, ctx.mix["job"], ctx.device
    cuda = dev != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root = tempfile.mkdtemp(prefix="portbench_")
    try:
        train, valid, vocab = examples(mix, root, ctx.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ctx.mark("corpus and examples")
    if vocab.vocab_size != cfg["vocab_size"]:
        raise ValueError(f"the corpus gives a vocabulary of {vocab.vocab_size}, the "
                         f"configuration {cfg['vocab_size']}")
    P = cfg["num_positions"]
    seq_len = DecoderBatcher.for_examples(
        train + valid, pad_multiple=P * TASK_PAD // math.gcd(P, TASK_PAD)).seq_len
    micro, k = job["micro_batch"], job["accumulation"]
    total_updates = max(len(train) // (micro * k), 1) * job["epochs"]
    pcfg = port_config(cfg, dev)
    model = QwenFamilyModel(pcfg, device=dev, seed=0)
    spec = RM.param_spec(cfg)
    weights.load(model, weights.make(spec, ctx.seed, dev))
    trainer = Trainer(make_loss_fn(model, pcfg, deterministic=False), model,
                      OptimizerConfig(learning_rate=job["learning_rate"],
                                      weight_decay=job["weight_decay"],
                                      warmup_ratio=job["warmup_ratio"],
                                      lr_scheduler_type="cosine", max_grad_norm=job["max_grad_norm"],
                                      adam_b1=job["adam_b1"], adam_b2=job["adam_b2"],
                                      adam_eps=job["adam_eps"], total_steps=total_updates),
                      TrainLoopConfig(seed=ctx.seed, gradient_accumulation_steps=k))
    store = native.ExampleStore(train, vocab.behavior_token_ids)
    feed = _feed(store, micro, seq_len, ctx.seed)
    ctx.mark("model and trainer")

    # the checked updates: the warm-up and capture of every shape
    n_check = ctx.cell["check_updates"] * k
    first, losses, grad = [], [], None
    for step in range(n_check):
        batch = next(feed)
        first.append(batch)
        losses.append(trainer.train_step(batch))
        if step == k - 1:
            b1 = job["adam_b1"]
            grad = {n: (m / (1 - b1)).detach().clone() for n, m in trainer.optimizer.mu.items()}
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    sync()
    setup_s = ctx.setup_done()

    # the window
    spans, window_losses, tokens, kept = ctx.spans, [], 0, []
    t_start = time.perf_counter()
    while True:
        with spans("collate"):
            batch = next(feed)
        with spans("train_step"):
            window_losses.append(trainer.train_step(batch))
        tokens += int((batch["attention_mask"] * batch["row_valid"][:, None]).sum())
        if ctx.traced:
            kept.append({f: batch[f] for f in ("attention_mask", "actions", "row_valid")})
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    sync()
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    ctx.mark("window")

    run_view = types.SimpleNamespace(kind="train", step_span="train_step", cfg=cfg,
                                     window_s=window_s, steps=len(window_losses),
                                     spans=spans.times, trace=None)
    if ctx.traced:
        run_view.flops = sum(counts.train_flops(cfg, b) for b in kept)
        traced = [next(feed) for _ in range(max(k, ctx.cell["trace_steps"]))]

        def segment():
            for b in traced:
                with spans("train_step"):
                    trainer.train_step(b)

        if cuda:
            run_view.trace = trace.profiled(spans, segment, len(traced))
        run_view.trace_batches = traced

        ctx.mark("traced segment")
    prog = {"losses": [float(x) for x in losses], "grad": grad, "params": after}
    del trainer, model, store, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference
    checks = reference_check(ctx, cfg, job, train, vocab, seq_len, first, prog, total_updates)
    ctx.mark("reference")
    return {"e2e": {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s,
                    "peak_mem_gib": peak / 2 ** 30},
            "checks": checks, "attempted": len(window_losses), "failed": failed,
            "device": device_info(dev, peak), "run": run_view}


def reference_check(ctx, cfg, job, train, vocab, seq_len, first, prog, total_updates) -> dict:
    """The numbers `correct` compares (see `reference/train.py`)."""
    dev = ctx.device
    mb = RT.micro_batches(plain_examples(train), job["micro_batch"], seq_len,
                          vocab.behavior_token_ids, ctx.seed, len(first))
    mismatch = sum(int(not np.array_equal(np.asarray(a[f]), np.asarray(b[f])))
                   for a, b in zip(first, mb) for f in b)
    start = weights.make(RM.param_spec(cfg), ctx.seed, dev)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = RT.follow(start, cfg, job, mb, ctx.seed, total_updates, dev,
                        ctx.cell["reference_rows"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    gaps = RT.compare(prog, ref, start)
    return {"batch_mismatch": mismatch, "loss_gap": gaps["loss_gap"],
            "grad_gap": gaps["grad_gap"], "change_gap": gaps["change_gap"]}
