"""Device-time breakdown of the PyTorch/CUDA port's main paths on one GPU.

    python3 scripts/profile_torch_port.py        # the flagship paths
    python3 scripts/profile_torch_port.py rec    # the discriminative zoo
    python3 scripts/profile_torch_port.py rqvae  # the RQ-VAE tokenizer

Traces, with torch.profiler (CPU + CUDA activities), three steady-state
iterations of the flagship Qwen3Multi scoring forward (bf16, batch 64 x
S = 505, through the hand-written kernels) as `Trainer.evaluate` of one
batch (the eval step of `chip_smoke.py` phase 3), three training steps of
the same model through `Trainer` (bf16, dropout 0.2, AdamW; the step of
`chip_smoke.py` phase 5), and the 20-beam constrained search (batch 128,
per-example behavior ids, the shapes of `chip_smoke.py` phase 4), each
compiled (CUDA graph replays, the default) and eager (`graphed=False`),
then the search's prefill (the prompt forward filling the caches) alone.
For each it prints the wall time per iteration
(timed without the profiler), the device busy share (summed kernel time over
that wall time, one stream), the device kernels by total time and the sums
of the attention, MoE, CE and hash-dropout kernels (a: `attn_fwd*`; b:
`attn_dkv*`, `attn_dq*`, `attn_delta*`; h: `moe_fwd*`; i: `moe_bwd*`,
`moe_gemm*`; j: `ce_fwd*`; k: `ce_dh*`, `ce_de*`; K1 and K2:
`hash_dropout_kernel`; L1 and L2: `norm_partials*`, `norm_total*`,
`update_kernel*`), and the kernels that compute on int64 (`long` in
their name) with `arange`'s, where a hash computed in plain PyTorch would
show. The split reduce that b (at small batch), i and k end with is one
kernel by name for all three and is counted in no group. Needs CUDA;
builds the kernels first.

With `rec` it traces instead three training steps (forward, backward, AdamW
update; `tasks/train_smb_rec.RecTrainStep`, its host part staging a host
batch and the step's draws) of each discriminative backbone at its shipped
config and `chip_smoke.py` phase 13's geometry (batch 256 x 20, 6000
items, 700 users, a random batch, dropout on), fp32, no kernel of a-k (the
dropout runs on K1 and K2, the update on kernel L), each compiled (a CUDA
graph replayed) and eager (`graphed=False`). With `rqvae` it traces three
RQ-VAE training steps (`tasks/rqvae.RQVAEStep`: `chip_smoke.py` phase 12's
shipped widths, batch 1024 of 6000 random 768-d items, CF and diversity
losses on), three emits over the 6000 items (`RQVAEEmit`), two of the
task's epochs (the reclustering of every codebook, `RQVAERecluster`, then 6
steps) and the reclustering alone, each compiled (its graphs replayed) and
eager.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile(fn, iters: int, label: str, top: int = 14, width: int = 80) -> None:
    """Wall time per iteration without the profiler, then the device kernels
    of the same iterations under it (kernel durations; launches overlap
    nothing on one stream, so their sum is the busy time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy_ms = sum(dev(e) for e in kernels) / 1e3 / iters
    print(f"{label}: {wall_ms:.3f} ms wall/iteration (no profiler), device kernels "
          f"{busy_ms:.3f} ms/iteration = {100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle; {sum(e.count for e in kernels) // iters} launches")
    for e in sorted(kernels, key=dev, reverse=True)[:top]:
        ms = dev(e) / 1e3 / iters
        name = e.key.replace("(anonymous namespace)::", "").replace("at::native::", "")
        name = name.split("(")[0][:width]
        print(f"  {ms:9.4f} ms {100 * ms / busy_ms:5.1f}%  {e.count // iters:5d} calls  {name}")
    groups = {"optimizer L1+L2": ("norm_partials", "norm_total", "update_kernel"),
              "attention a": ("attn_fwd",),
              "attention b": ("attn_dkv", "attn_dq", "attn_delta"),
              "MoE h": ("moe_fwd",), "MoE i": ("moe_bwd", "moe_gemm"),
              "CE j": ("ce_fwd",), "CE k": ("ce_dh", "ce_de"),
              "hash dropout K1+K2": ("hash_dropout_kernel",),
              "int64 elementwise and arange": ("<long", "long>", "arange")}
    for label, keys in groups.items():
        group = [e for e in kernels if any(k in e.key for k in keys)]
        ms = sum(dev(e) for e in group) / 1e3 / iters
        print(f"  {label}: {ms:.4f} ms/iteration ({100 * ms / busy_ms:.1f}% of device time), "
              f"{sum(e.count for e in group) // iters} launches")
        if label.startswith("int64"):  # name them: the plain hash would show here
            for e in sorted(group, key=dev, reverse=True)[:6]:
                print(f"    {dev(e) / 1e3 / iters:9.4f} ms {e.count // iters:5d} calls  "
                      f"{e.key.replace('(anonymous namespace)::', '')[:150]}")


def profile_rec(n_items: int = 6000, n_users: int = 700, batch_size: int = 256,
                his: int = 20) -> None:
    """Three training steps of each zoo backbone, compiled and eager (see
    the module docstring)."""
    import chip_smoke as cs
    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR

    for backbone in cs.PHASE13_BACKBONES:
        cfg = DisModelConfig.from_file(os.path.join(REPO, "config", "dis-models", backbone))
        L = his + 1 if backbone == "MBHT" else his
        if backbone == "MBHT":
            cfg = cfg.replace(scales=[5, 3, 7])  # train_SMB_rec's adjustment at length 21
        batch = cs.random_rec_batch(batch_size, L, his, n_items, n_users, 0)
        for graphed in (True, False):
            model = TR.build_dis_model(backbone, cfg, n_items, L, 3, n_users, "cuda")
            step = TR.RecTrainStep(backbone, model, cfg, _adamw(model), graphed)
            gens = iter(range(1 << 30))
            _profile(lambda: step(batch, TR.step_generator(0, next(gens))), 3,
                     f"train step {backbone} fp32 B={batch_size} L={L} items={n_items}, "
                     f"{'compiled' if graphed else 'eager'}", top=8)
            del model, step


def profile_rqvae(n_items: int = 6000, batch_size: int = 1024) -> None:
    """The RQ-VAE's training step and emit at the shipped widths, compiled
    and eager, and an epoch's reclustering (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig, training_draws
    from gamer_tpu_torch.tasks import rqvae as TR

    args = dict(zip(cs.PHASE12_RQ[::2], cs.PHASE12_RQ[1::2]))
    levels, size = int(args["--num_levels"]), int(args["--num_emb"])
    cfg = RQVAEConfig(in_dim=768, num_emb_list=[size] * levels, e_dim=int(args["--e_dim"]),
                      layers=[int(v) for v in args["--layers"].split(",")],
                      sk_epsilons=[float(v) for v in args["--sk_epsilons"].split(",")],
                      alpha=float(args["--alpha"]), beta=float(args["--beta"]))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((n_items, 768)), dtype=torch.float32, device="cuda")
    cf = torch.as_tensor(rng.standard_normal((n_items, cfg.e_dim)), dtype=torch.float32,
                         device="cuda")
    labels = rng.integers(0, cfg.n_clusters, (levels, size))
    rows = rng.permutation(n_items)[:batch_size]
    pad_n = -(-n_items // batch_size) * batch_size
    order = rng.permutation(n_items)
    order = np.concatenate([order, order[:pad_n - n_items]])
    model = RQVAE(cfg, device="cuda", seed=0)
    times = []
    for i in range(5):  # the host part's draws alone (the step's generator, as the task's)
        t = time.perf_counter()
        training_draws(model, batch_size, TR.step_generator(0, 0, i))
        times.append(time.perf_counter() - t)
    print(f"RQ-VAE host draws of a step B={batch_size} (Gumbel noise of {levels} levels): "
          f"{1e3 * float(np.median(times)):.3f} ms median of 5 (host time)")
    for graphed in (True, False):
        form = "compiled" if graphed else "eager"
        model = RQVAE(cfg, device="cuda", seed=0)
        step = TR.RQVAEStep(model, _adamw(model), x, cf, graphed)
        step.set_labels(labels)
        gens = iter(range(1 << 30))
        _profile(lambda: step(rows, TR.step_generator(0, 0, next(gens))), 3,
                 f"RQ-VAE train step B={batch_size} {cfg.in_dim}->{cfg.layers}->{cfg.e_dim}, "
                 f"{levels}x{size} codes, {form}", top=8)
        emit = TR.RQVAEEmit(model, x, batch_size, graphed)
        _profile(emit, 3, f"RQ-VAE emit of {n_items} items in chunks of {batch_size}, {form}",
                 top=6)

        recluster = TR.RQVAERecluster(model, step.labels, graphed)

        def epoch():  # the task's epoch: recluster every codebook, then the steps
            e = next(gens)
            recluster(0, e)
            TR.train_epoch(step, order, batch_size, 0, e)

        _profile(epoch, 2, f"RQ-VAE epoch ({levels} reclusterings, {pad_n // batch_size} "
                 f"steps), {form}", top=6)
        _profile(lambda: recluster(0, next(gens)), 2,
                 f"an epoch's reclustering alone ({levels} levels of {size} codes), {form}",
                 top=6)
        del model, step, emit, recluster


def _adamw(model):
    from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

    return make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-3, weight_decay=0.0,
                                          lr_scheduler_type="constant", warmup_ratio=0.0,
                                          max_grad_norm=0.0), model)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    if sys.argv[1:] in (["rec"], ["rqvae"]):
        torch.backends.cuda.matmul.allow_tf32 = False
        profile_rec() if sys.argv[1] == "rec" else profile_rqvae()
        return 0
    _build.build()
    cfg = cs.flagship_config()
    batch = cs.make_batch(cfg, 64, 101)
    model, loss_fn = cs.run_forward(cfg, "cuda")

    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    for graphed in (True, False):
        evaluator = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                            OptimizerConfig(), TrainLoopConfig(), eval_loss_fn=loss_fn,
                            graphed=graphed)
        _profile(lambda: evaluator.evaluate([batch]), 3,
                 f"scoring forward Qwen3Multi bf16 B=64 S=505 (Trainer.evaluate of one batch), "
                 f"{'compiled (CUDA graph replays)' if graphed else 'eager'}")
        del evaluator

    train_cfg = cs.flagship_config(dropout_rate=cs.DROP_RATE)
    for graphed in (True, False):
        train_model = QwenFamilyModel(train_cfg, device="cuda")
        trainer = Trainer(make_loss_fn(train_model, train_cfg, deterministic=False), train_model,
                          OptimizerConfig(learning_rate=5e-4, lr_scheduler_type="constant"),
                          TrainLoopConfig(seed=0), graphed=graphed)
        _profile(lambda: trainer.train_step(batch), 3,
                 f"train step Qwen3Multi bf16 B=64 S=505 dropout {cs.DROP_RATE}, "
                 f"{'compiled (CUDA graph replays)' if graphed else 'eager'}", top=24)
        del trainer, train_model
    trie, prompts, behaviors = cs.make_trie_and_prompts(
        cfg, cs.BEAM_BATCH, cs.N_ITEMS, cs.LEVELS, cs.LEVEL_SIZE, cs.PROMPT_BLOCKS)
    for graphed in (True, False):
        search = make_beam_search_fn(model, trie, BeamSearchConfig(num_beams=cs.NUM_BEAMS),
                                     graphed=graphed)
        _profile(lambda: search(prompts, behaviors), 3,
                 f"beam search B={cs.BEAM_BATCH} beams={cs.NUM_BEAMS} "
                 f"S={prompts['input_ids'].shape[1]}, "
                 f"{'compiled (CUDA graph replays)' if graphed else 'eager'}", top=24, width=160)
        del search
    # the search's prefill alone (eager): the prompt forward that fills the caches
    from gamer_tpu_torch.decode.beam import init_caches, prepare_prefill

    dbatch = {k: torch.as_tensor(v, device="cuda") for k, v in prompts.items()}
    B, S = dbatch["input_ids"].shape
    with torch.no_grad():
        inputs, _ = prepare_prefill(cfg, dbatch)
        _profile(lambda: model(**inputs, caches=init_caches(cfg, B, S, torch.bfloat16, "cuda"),
                               cache_index=0, logits_last_only=True, route_mode="onehot"), 3,
                 f"the search's prefill alone B={B} S={S}, eager", top=12, width=160)
    return 0


if __name__ == "__main__":
    sys.exit(main())
