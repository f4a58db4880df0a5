"""Census of a training step's device memory, for `train/memory.py`'s estimate.

    python3 scripts/probe_remat_memory.py [--out results/remat_memory.json]

On one CUDA card, flagship Qwen3Multi (bf16, dropout 0.2) through `Trainer`
(eager steps): for each geometry (B x S) and remat policy it prints a timed
step's time, its peak memory over what was allocated before the model
(`torch.cuda.max_memory_allocated` after a warm-up step) and the launches
of the port's kernels (a-k, the hash dropout's K1/K2, the q/k norm and
RoPE's N1/N2); at the remat-off geometries it also sums the tensors the
step saves for its backward
(`torch.autograd.graph.saved_tensors_hooks`, each storage once) by dtype
and shape, the census from which `train/memory.py` counts its per-token
terms, and prints `estimate_train_hbm_bytes` beside the peak. The same for
Qwen3MoeAction at the flagship widths (h and i once a layer, grouped) at
phase 8's batch of 256 x 21 blocks and at B 16 x S 8190, remat off: the
estimate away from the geometry it was fitted at. Prints the card's name
and power limit; writes every record as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GEOMETRIES = [(64, 101, None), (32, 202, None), (16, 410, None), (8, 1000, None),
              (64, 101, "full"), (64, 101, "attn"), (64, 101, "dots"),
              (16, 1638, None), (16, 1638, "full"), (16, 1638, "attn"), (16, 1638, "dots"),
              (64, 1638, "attn")]
MOE_ACTION_GEOMETRIES = [(256, 21), (16, 1638)]  # remat off


def config(backbone: str, policy):
    """The flagship widths (bf16, dropout 0.2, up to S 8190) of `backbone`."""
    from gamer_tpu_torch.entry import flagship_config
    from gamer_tpu_torch.models.generative.qwen_family import build_config

    cfg = flagship_config(dtype="bfloat16", dropout_rate=0.2, model_max_length=8192,
                          remat=policy is not None, remat_policy=policy or "attn")
    if backbone == "Qwen3Multi":
        return cfg
    return build_config(backbone, **{k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
        "num_key_value_heads", "head_dim", "intermediate_size", "dropout_rate", "num_positions",
        "num_experts", "num_behavior", "behavior_embedding_dim", "behavior_base",
        "model_max_length", "dtype", "remat", "remat_policy")})


def step(B: int, blocks: int, policy, kernels: tuple, census: bool,
         backbone: str = "Qwen3Multi") -> dict:
    import torch

    from gamer_tpu_torch.core import trace
    from gamer_tpu_torch.entry import make_batch
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.memory import estimate_train_hbm_bytes
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = config(backbone, policy)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = QwenFamilyModel(cfg, device=dev, seed=0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(cfg, B, blocks).items()}
    trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                      OptimizerConfig(learning_rate=5e-4, lr_scheduler_type="constant",
                                      total_steps=10), TrainLoopConfig(seed=0),
                      graphed=False)  # a replayed graph allocates nothing
    trainer.train_step(batch)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    before = {k: trace.counter("launch." + k) for k in kernels}
    t = time.perf_counter()
    loss = float(trainer.train_step(batch))
    ms = (time.perf_counter() - t) * 1e3
    rec = dict(backbone=backbone, B=B, S=blocks * cfg.num_positions, policy=policy or "off",
               ms=ms, loss=loss, peak=torch.cuda.max_memory_allocated() - base,
               resident=resident,
               launches={k: trace.counter("launch." + k) - before[k] for k in kernels})
    if policy is None:
        rec["estimate"] = estimate_train_hbm_bytes(cfg, B, rec["S"])["total"]
    if census:
        sizes, seen = {}, set()

        def pack(t):
            key = (t.untyped_storage().data_ptr(), t.dtype)
            if key not in seen:
                seen.add(key)
                sig = f"{t.dtype}:{tuple(t.shape)}"
                sizes[sig] = sizes.get(sig, 0) + t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            make_loss_fn(model, cfg, deterministic=False)(batch, torch.Generator().manual_seed(1))
        tokens = B * blocks * cfg.num_positions
        rec["saved_bytes_per_token"] = sum(sizes.values()) / tokens
        rec["saved_by_shape"] = sorted(((sig, n / tokens) for sig, n in sizes.items()),
                                       key=lambda kv: -kv[1])
    del trainer, model, batch
    return rec


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join("results", "remat_memory.json"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_remat_memory: needs a CUDA device", file=sys.stderr)
        return 2
    from gamer_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    _build.build()
    kernels = ("a", "b", "h", "i", "j", "k", "K1", "K2", "N1", "N2")  # counters launch.<kernel>
    records = []
    runs = [("Qwen3Multi", B, blocks, policy) for B, blocks, policy in GEOMETRIES]
    runs += [("Qwen3MoeAction", B, blocks, None) for B, blocks in MOE_ACTION_GEOMETRIES]
    for backbone, B, blocks, policy in runs:
        rec = step(B, blocks, policy, kernels, policy is None and B in (64, 16), backbone)
        records.append(rec)
        extra = (f", saved {rec['saved_bytes_per_token']:.1f} B a token; largest "
                 f"{[(sig, round(b, 1)) for sig, b in rec['saved_by_shape'][:10]]}"
                 if "saved_by_shape" in rec else "")
        if "estimate" in rec:
            extra = (f", estimate {rec['estimate'] / 2 ** 30:.3f} GiB = "
                     f"{rec['estimate'] / rec['peak']:.3f}x the peak" + extra)
        print(f"{backbone} B={rec['B']} S={rec['S']} remat {rec['policy']}: step "
              f"{rec['ms']:.3f} ms, peak {rec['peak'] / 2 ** 30:.3f} GiB (resident "
              f"{rec['resident'] / 2 ** 30:.3f}), launches {rec['launches']}{extra} "
              f"(card {card})", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "records": records}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
