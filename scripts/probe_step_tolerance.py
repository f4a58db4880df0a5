"""Readings behind the bf16 train-step tolerances of `chip_smoke.py`.

    python3 scripts/probe_step_tolerance.py   # on one GPU

One training step through the kernels against one through the plain path
(`chip_smoke._paths_agree` with no limit: the loss's relative difference and
the worst grad's max |d| / max |plain|) on three geometries:
  - mb: Qwen3MoeAction as `train_MB_decoder` builds it on phase 8's dataset
    (mb_explicit_decoder_4, 5 positions, 3 behaviors, dropout 0.1), the
    first shuffled batch of 256 (S 120);
  - seq: Qwen3Moe as `train_decoder` builds it (4 positions), batch 256 (S 88);
  - gputest: Qwen3MoeAction with dropout 0.2 at B 8 x 101 blocks, the
    geometry of `tests/test_torch_kernels_gpu.py`.
Sound runs over five seeds in bf16 and fp32, then planted faults in the
kernel path (bf16, mb and gputest, two seeds), each made by wrapping the
wrapper the model calls (MoeAction's grouped MoE launch): the third
behavior level's output dropped, the third level run with the second
level's experts, the MoE dropout left out or on another seed, the behavior
bias dropped, the attention dropout left out.
A limit between the largest sound reading and the smallest fault reading
catches these faults (`tests/test_torch_step_tolerance.py` checks that on
the CPU at a tiny size). Prints one row a run, then the extremes.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("drop_level3", "level3_runs_level2", "moe_dropout_off", "moe_seed_off",
          "behavior_bias_off", "attn_dropout_off")


@contextlib.contextmanager
def planted(kind: str):
    """While the block runs, the kernel path carries the fault `kind`."""
    import torch

    from gamer_tpu_torch.modules import layers as L
    from gamer_tpu_torch.modules import moe as MOE
    from gamer_tpu_torch.ops import fused_attention as FA
    from gamer_tpu_torch.ops.fused_moe import TM

    moe0, attn0 = MOE.fused_moe_ffn_grouped, FA.fused_mask_attention

    class AttentionOps:
        """`ops.fused_attention` as `modules.layers` sees it, with the
        attention wrapper replaced (that module itself stays as it is)."""

        def __getattr__(self, name):
            return getattr(FA, name)

    def moe(xp, wgu, wd, btab, beh, groups, first, seed=0, act="silu", rate=0.0,
            use_bias=False):
        P = xp.shape[0]
        if kind == "level3_runs_level2":  # the third level's experts are the second's
            idx = torch.arange(wgu.shape[0], device=wgu.device)
            idx[first + 2 * P:first + 3 * P] -= P
            wgu, wd, btab = wgu[idx], wd[idx], btab[idx]
        rate = 0.0 if kind == "moe_dropout_off" else rate
        seed = seed + 1 if kind == "moe_seed_off" else seed
        use_bias = False if kind == "behavior_bias_off" else use_bias
        out = moe0(xp, wgu, wd, btab, beh, groups, first, seed, act, rate, use_bias)
        if kind == "drop_level3":  # the third level's rows give zero
            placed = groups.rows >= 0
            level = torch.full((xp.shape[1],), -1, dtype=torch.int32, device=xp.device)
            level[groups.rows[placed].long()] = groups.tile_level.repeat_interleave(TM)[placed]
            out = out * (level != 2).to(out.dtype)[None, :, None]
        return out

    def attn(*args):
        args = list(args)
        if kind == "attn_dropout_off":
            args[10] = 0.0  # dropout_rate, passed positionally by GQAAttention
        return attn0(*args)

    ops = AttentionOps()
    ops.fused_mask_attention = attn
    MOE.fused_moe_ffn_grouped, L.fa = moe, ops
    try:
        yield
    finally:
        MOE.fused_moe_ffn_grouped, L.fa = moe0, FA


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from gamer_tpu_torch import native
    from gamer_tpu_torch.data.batching import DecoderBatcher
    from gamer_tpu_torch.data.contract import DataFiles
    from gamer_tpu_torch.data.seq import SeqCorpus, SeqExampleBuilder
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
    from gamer_tpu_torch.models.generative.qwen_family import build_config
    from gamer_tpu_torch.tasks.test_decoder import seq_inter_type
    from gamer_tpu_torch.tasks.train_mb_decoder import load_mb_train

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    counters = cs.kernel_counters()
    batch_size = 256
    rows = []

    def run(label, cfg, batch, seed):
        loss, grad, at = cs._paths_agree(label, cfg, batch, dev, seed, counters,
                                         cs._step_launches(cfg, update=False), loss_tol=math.inf,
                                         grad_tol=math.inf)
        rows.append(dict(label=label, loss_rel=loss, grad_rel=grad, grad_at=at))

    def first_batch(train, valid, vocab, pad_multiple, seed):
        seq_len = DecoderBatcher.for_examples(train + valid, pad_multiple=pad_multiple).seq_len
        return next(iter(native.ExampleStore(train, vocab.behavior_token_ids).iterate(
            batch_size, seq_len, shuffle=True, seed=seed)))

    root = tempfile.mkdtemp(prefix="phase8_", dir=REPO)
    try:
        data = os.path.join(root, "data")
        write_synthetic_dataset(data, "Synth", SyntheticSpec(**cs.PHASE7_SPEC))
        corpus, layout, train, valid = load_mb_train("Synth", data, 20, ".index.json",
                                                     "mb_explicit_decoder_4", False)
        tc = layout.token_count(corpus.sole_item_len)
        mb_cfg = build_config("Qwen3MoeAction", vocab_size=corpus.vocab.vocab_size,
                              num_positions=tc, num_experts=tc + 1,
                              num_behavior=len(corpus.behavior_names),
                              behavior_base=corpus.vocab.behavior_base, temperature=0.7,
                              dtype="bfloat16", model_max_length=1024)
        seq_corpus = SeqCorpus(DataFiles(data, "Synth"), ".index.json", multi_behavior=False,
                               inter_type=seq_inter_type("seqrec", None))
        builder = SeqExampleBuilder(seq_corpus, 20)
        seq_train, seq_valid = builder.build("train"), builder.build("valid")
        seq_cfg = build_config("Qwen3Moe", vocab_size=seq_corpus.vocab.vocab_size,
                               num_positions=seq_corpus.sole_item_len,
                               num_experts=seq_corpus.sole_item_len + 1,
                               num_behavior=len(seq_corpus.behavior_names),
                               behavior_base=seq_corpus.vocab.behavior_base,
                               dtype="bfloat16", model_max_length=1024)
        gpu_cfg = build_config("Qwen3MoeAction", vocab_size=1024 + 17, num_positions=5,
                               num_experts=6, num_behavior=3, behavior_base=14,
                               dtype="bfloat16", dropout_rate=0.2)
        mb_pad, seq_pad = math.lcm(tc, 8), math.lcm(seq_corpus.sole_item_len, 8)

        for seed in range(5):
            mb_batch = first_batch(train, valid, corpus.vocab, mb_pad, seed)
            seq_batch = first_batch(seq_train, seq_valid, seq_corpus.vocab, seq_pad, seed)
            gpu_batch = cs.make_batch(gpu_cfg, 8, 101, seed=seed)
            for dtype in ("bfloat16", "float32"):
                run(f"sound mb {dtype} seed {seed}", mb_cfg.replace(dtype=dtype), mb_batch, seed)
                run(f"sound seq {dtype} seed {seed}", seq_cfg.replace(dtype=dtype), seq_batch,
                    seed)
                run(f"sound gputest {dtype} seed {seed}", gpu_cfg.replace(dtype=dtype),
                    gpu_batch, seed)
        for kind in FAULTS:
            for seed in (0, 1):
                mb_batch = first_batch(train, valid, corpus.vocab, mb_pad, seed)
                gpu_batch = cs.make_batch(gpu_cfg, 8, 101, seed=seed)
                with planted(kind):
                    run(f"fault {kind} mb bfloat16 seed {seed}", mb_cfg, mb_batch, seed)
                    run(f"fault {kind} gputest bfloat16 seed {seed}", gpu_cfg, gpu_batch, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    print("step tolerance readings (loss rel diff, worst grad rel err):")
    for r in rows:
        print(f"{r['label']:48s} loss {r['loss_rel']:.3e} grad {r['grad_rel']:.3e} "
              f"({r['grad_at']})")
    for kind in ("sound", "fault"):
        for dtype in ("bfloat16", "float32"):
            sel = [r for r in rows if r["label"].startswith(kind) and dtype in r["label"]]
            if sel:
                pick = max if kind == "sound" else min
                print(f"{kind} {dtype}: {'largest' if kind == 'sound' else 'smallest'} loss "
                      f"{pick(r['loss_rel'] for r in sel):.3e}, grad "
                      f"{pick(r['grad_rel'] for r in sel):.3e} over {len(sel)} runs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
