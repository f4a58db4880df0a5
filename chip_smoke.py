"""Smoke run of the PyTorch/CUDA port (`gamer_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. build the nine hand-written CUDA kernel libraries from
   `gamer_tpu_torch/ops/csrc` with nvcc for sm_90a (one nvcc per source,
   started together), and count each library's tensor-core instructions
   (HMMA for mma.sync, HGMMA for wgmma) in its SASS with `cuobjdump`: every
   library of a-k (attention a, b; MoE h, i; CE j, k) must have some (the
   elementwise hash dropout, optimizer update and q/k norm and RoPE have
   none by design);
2. hold each forward kernel (a, h, j) against its plain PyTorch version at
   the flagship shapes: fp32 inputs at 1e-4 and bf16 inputs (plain version
   run in fp32 on the same bf16 values) at 2e-2, both as
   max |kernel - plain| / max |plain|, TF32 off; attention also at S = 2048
   and S = 8192 (B = 1), and h at each activation (silu, tanh-gelu, relu)
   with bias and dropout 0.2. Each kernel is timed (CUDA events) beside its
   plain version and, where one exists, one PyTorch library call of the same
   function;
2b. the same for the backward kernels (b, i, k) against autograd through
   the plain versions, with dropout 0 and 0.2 (the same seed on both sides),
   attention also at B 1 x S 2048 and 8192 (the lengths of the TPU's
   streaming and XL kernels c-g, which kernels a and b cover); two bf16
   launches of a and b at B 64 x S 505, dropout 0.2, of h and i at the
   flagship MoE shape with bias and dropout 0.2, and of j and k at the
   flagship CE shape must be bit-identical; every time is printed with its
   achieved TFLOP/s and share of the bound, and the MoE times beside a
   yardstick: the same products alone as cuBLAS bf16 `torch.bmm` calls (2
   for h, 5 for i), without the elementwise work, so not the function; i
   also at gelu and relu (bias, dropout 0.2);
2c. the widths past the flagship's, forward and backward in both dtypes
   against the plain versions, with their bf16 times and bounds: MoE h/i at
   hidden 512 (D = Dout 512, F 1024) and at D 200, F 344 (the pad route), CE
   j/k at D 512 and 1024, attention a/b at head dims 48, 96, 256 and, on
   the wide route, 320 and 512 (B 8 x S 505);
2d. the residual hash dropout (`ops/hash_dropout.py`): K1 (with and
   without its residual) and K2 against their plain versions, bit for bit,
   at the flagship residual [64, 505, 256] bf16 (rates 0.2 and 0.1), fp32
   at the zoo's shape, an odd length at an aligned and at an offset
   pointer, and rows from row0 > 0 against the
   global batch's mask; K1 and K2 timed beside their plain versions and
   bounds;
2e. the optimizer update, kernel L (`ops/fused_optimizer.py`: L1 the global
   norm, L2 the clip and update), against its plain version
   (`train/state.plain_update`) at the flagship's 138 parameter tensors,
   for each family (adamw, adam, sgd, adagrad, rmsprop, the fallback adam),
   the clip triggered on some updates and not on others: after 10 updates
   every parameter and moment within 1e-5 of its tensor's largest entry,
   L1's norm within 1e-5 relative, two runs of L bit-identical; L1 and L2
   timed (CUDA events) beside their bounds, the plain version and the
   library calls (`clip_grad_norm_(foreach=True)`,
   `torch.optim.AdamW(fused=True)`);
2f. the attention prologue's q/k RMSNorm and RoPE (`ops/qk_norm_rope.py`):
   N1 against its plain version bit for bit (bf16 at the flagship's
   [256, 520] tokens, 6 q and 3 k heads of 64; fp32 and bf16 at head dims
   48, 64, 128, 258 (the wide kernels) and 320, B 8 x S 505, jumping
   positions), N2's grads no further from the fp32 plain grads than
   autograd through the bf16 plain version, two N2 runs bit-identical (at
   B 8 x S 505, on the timed flagship inputs and at B 256 x S 120); N1 and
   N2 timed at the flagship shapes in a CUDA graph beside their bounds
   (bytes) and the plain chain's forward and backward (their launches on
   the main path: phases 3, 4 and 5);
2g. MoeAction's grouped h and i (`ops/fused_moe.fused_moe_ffn_grouped`) at
   the h20 cell's MoE shapes (T 6144 block rows of 5 positions, D 256, F
   512, 3 levels and 19% pad blocks, bias, dropout 0.1, bf16): the output
   and dx bit-identical to one ungrouped launch a level with the masked
   sum; the grouped launches, the row table's build and the per-level
   launches timed beside the bound of the real rows' work;
3. the scoring forward (`make_loss_fn`, deterministic) of flagship
   Qwen3Multi in bf16 at batch 64 x 101 blocks (S = 505), random weights from
   a seeded generator, through `Trainer.evaluate` (`eval_phase`), compiled
   (its eval step captured as a CUDA graph and replayed) and eager
   (`graphed=False`): every eval loss bit-identical between the two, each
   run of the eval step's device part (the eager runs, the capture)
   launching exactly a 12, N1 12, h 8, j 1, a profiled replay running the eager
   eval's kernels of the port by name and count, each mode's median host
   time, busy share and peak memory; then the plain path on the same
   weights, the losses finite and within 1e-2 relative;
4. trie-constrained beam search (`search_phase`: 20 beams, batch 128, 4
   code levels of 256, several thousand items, left-padded prompts of up to
   100 blocks), compiled (one CUDA graph a key) and eager, with per-example,
   scalar and `None` behavior ids (the last the behavior-token decode over
   the behavior + item trie): codes equal and scores bit-identical between
   the two in each mode, two graphs captured, no launch of the port's
   kernels but N1 (12 in the prefill and in each decode step of every run
   of a search's device part), a profiled replay running the eager search's kernels by name
   and count; shapes, finite sorted scores, every returned code path in the
   trie; each mode's median host time, beams/s, busy share, peak memory and
   the memory the graphs keep reserved;
5. the training step of flagship Qwen3Multi through `Trainer` (bf16, batch
   64 x 101 blocks, dropout 0.2, AdamW lr 5e-4, 10 updates on one batch),
   compiled (the step captured as a CUDA graph and replayed, the default)
   and eager (`graphed=False`) from the same weights and seeds: losses and
   every parameter bit-identical; the launches counted at the capture, and
   in each eager step, exactly 12/12/8/8/1/1 of kernels a/b/h/i/j/k,
   20/20 of the hash dropout's K1/K2 (one a residual site) and 1/1 of
   kernel L's L1/L2, and a profiled replay running the same kernels of the
   port's sources, by name and count, as a profiled eager step; finite
   losses, the mean of the last 3 below the first; each step's median host
   time, sequences/s, busy share and peak memory; then one fp32 step at
   batch 16, kernel path against plain path on the same weights and dropout
   seeds (loss within 1e-5, every parameter's grad within 1e-3);
6. the long-history step: one fp32 forward and backward at B 4 x S 2050
   and B 1 x S 5000, kernel path (a and b launches counted) against the
   plain path (grads within 1e-3);
7. the task pipeline through `python -m gamer_tpu_torch`'s `main(argv)` at
   the flagship widths (`task_phase`): a synthetic dataset from the port's
   generator, one bf16 epoch of train_SMB_decoder at batch 64, compiled
   (per-step launches as in phase 5 at each capture and warm-up, the other
   steps replayed; the number of graphs printed), the C++ collation, the
   saved checkpoints, the reloaded "best" giving the best eval loss; the
   same epoch again from the same data and seed giving every step loss and
   the best valid loss bit for bit; the eval step compiled, one or two
   graphs, each run launching one scoring forward's kernels),
   test_SMB_decoder with 20 beams (one search graph: the last chunk is
   padded) and test_SMB_rule; prints the step time with host collation,
   the fit's peak memory, the eval's wall time, beams/s and graphs, and the
   metrics;
8. the multi- and single-behavior pipelines through the CLI at the
   presets' full widths (`seq_phase`): on phase 7's dataset, one bf16 epoch
   of train_MB_decoder (Qwen3MoeAction, mb_explicit_decoder_4, batch 256:
   per step a 8, b 8, h 8, i 8, j 1, k 1, kernels h and i once a layer,
   grouped over the behavior levels; the share of the grouped launch's
   tiles that held rows, read from the row tables after the fit), the reloaded "best", test_MB_decoder's three modes
   (the behavior-token decode included) with 20 beams; one bf16 epoch of
   train_decoder (Qwen3Moe, batch 256: a 8, b 8, h 8, i 8, j 1, k 1) and
   test_decoder (one search graph each mode and eval, one or two eval-step
   graphs a fit); prints the step times, S, peak memory and each eval's
   wall time, beams/s and graphs;
9. the remat policies and the memory estimate (`remat_phase`): flagship
   Qwen3Multi bf16 at B 64 x S 505 and B 16 x S 8190, each of remat off,
   full, attn and dots for a compiled `Trainer` step (its warm-up and
   capture) and a timed replay: launches per step (a 12/24/12/24, h
   8/16/16/16, K1 20/32/32/32, b 12, i 8, j 1, k 1, K2 20, L1 1, L2 1), the
   loss and a third step's grads bit-identical to remat off, two remat-off
   passes bit-identical (PyTorch's default algorithms), remat off and full
   also eagerly (`graphed=False`: losses and parameters bit-identical to the
   compiled steps, the eager peak printed beside the compiled one), peak
   memory full < attn, dots < off, and `train/memory.py`'s estimate within
   [1, 1.3] x the compiled remat-off peak; then
   the automatic choice at B 96 x S 8190 (which remat off would not fit
   in 70% of the card) takes policy attn and one step within 70% of the
   card's memory;
10. the enc-dec pipelines through the CLI at the shipped configs' widths
   (`encdec_phase`): one epoch of train_decoder --backbone TIGER (batch
   256) and test_decoder, one of train_SMB_decoder --backbone
   PBATransformer (batch 64 x 100 blocks) and test_SMB_decoder, 20 beams
   at batch 128; losses fall, the reloaded `best`, beams in the trie,
   metrics in [0, 1], no launch of kernels a-k, N1 or N2 (the enc-dec family
   runs none, as in JAX; it runs the hash dropout's K1 and K2 and kernel L,
   whose counts are printed), the eval step and each search compiled (one
   graph a search object).
11. data parallelism (`multiprocess_phase`, `core/distributed.py`):
   train_SMB_decoder in a one-process NCCL group against the same run
   ungrouped (the step's all-reduces captured with it: one graph a key as
   phase 7, launches at the capture those of phase 5, one gradient
   all-reduce a step, replays counted, losses within 1e-6), then phase 5's
   10 steps in that group compiled against `graphed=False` (bit-identical;
   step times, busy share and the NCCL kernels of a profiled step); two
   processes sharing the card over gloo, 4 fp32 steps at a global batch of
   16 x S 505 with dropout 0.2 against one process (losses 1e-5,
   parameters 1e-4, the processes' parameters bit-identical; the
   all-reduce's time a step; gloo stages through the host, so their steps
   stay eager); test_SMB_decoder striped over two processes against one
   (counts equal, metrics 1e-2; each process captures its search, and
   prints its peak memory);
12. the item-tokenizer chain (`tokenizer_phase`) at the shipped RQ-VAE
   widths on phase 7's 6000 items: SemEmb (hash, 768-d), RQVAE 20 epochs
   with --kmeans_init and CF embeddings, tokenize --mode rq_vae (collision
   rate 0 after repair), an fp32 RQ-VAE step on the card against the CPU
   (1e-4), and one epoch of train_SMB_decoder on the emitted semantic IDs
   through the kernels; the RQ-VAE's training step, emit and reclustering
   compiled (one CUDA graph each, L1/L2 once at the step's capture, the
   reclustering's graph replayed every later epoch), and one epoch of the
   compiled step and the compiled emit from best_collision against their
   eager forms, then the compiled reclustering and the epoch after it:
   bit-identical, the replay's kernels those of the eager step; each form's
   step time and busy share, the reclustering's wall and device time;
13. the discriminative zoo (`rec_phase`): one epoch of train_SMB_rec for
   each of SASRec, GRU4Rec, BERT4Rec, MBSTR, MBHT and PBAT from their
   shipped configs at scripts/train_SMB_rec.sh's geometry (smb_dis,
   --max_his_len 20, batch 256) on phase 7's sizes with sequential signal,
   the per-behavior test, --only_test on `best` (metrics within 1e-6), an
   fp32 step of `best` on the card twice (embedding table grads
   bit-identical) and against the CPU (loss 1e-5, grads 1e-4;
   ill-conditioned grads against float64), SASRec's sampled eval and a BPR
   epoch; losses fall, metrics in [0, 1], no launch of a-k, N1 or N2 (the zoo runs
   none, as in JAX; its dropout runs on K1 and K2 and its update on kernel
   L, whose counts are printed). The training step and the scorer are
   compiled (one CUDA graph each a fit, K1/K2 once a dropout site and L1/L2
   once at the capture); 5 compiled steps from `best` against 5 eager ones
   and the compiled scorer against the eager one: bit-identical, the
   replay's kernels those of the eager step; each form's step time and busy
   share.
14. the model axis (`model_axis_phase`, `core/mesh.py`): two gloo processes
   sharing the card at data 1 x model 2 (the flagship's experts 3 / 3, its
   vocab padded to 1152 rows, 576 / 576) against one process with the
   whole model: 4 fp32 steps at a global batch of 16 x S 505, dropout 0.2
   (losses 1e-5, gathered parameters 1e-4, the ranks' parameters
   bit-identical); one bf16 step at B 64 x S 505 on each rank (launches a
   12, b 12, h 8, i 8, j 1, k 1, K1 20, K2 20, 20 model-group collectives,
   their time);
   the 20-beam search of phase 4's geometry in fp32 (codes equal, scores
   1e-4; no graph captured: a live model axis puts collectives in every
   forward, so its owners stay eager); then h/i at P 2 and 3 and j/k
   at V 576 and 465 timed, with their plain versions and j/k's library
   call (`matmul` + `logsumexp`).

Prints the times and the total wall time, then `{"kernels": [...]}`, then the
card's name and power limit, and last `{"ok": true, "device": {...}}`. Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.
`python3 chip_smoke.py --mp-steps <dir> <device> <spec>` and `--mp-eval
<dir> <argv>` are worker processes of phase 11 and `--model-axis <dir>
<device> <spec>` one of phase 14 (started by the script itself).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores, NVIDIA data sheet
F64_FLOPS = 34e12  # H100 SXM fp64 peak outside the tensor cores, NVIDIA data sheet
# libraries with no tensor-core work by design (elementwise, bound by bytes)
NO_TENSOR_CORES = ("hash_dropout", "fused_optimizer", "qk_norm_rope")
# the launch counters of the Qwen family's kernels: the tensor-core kernels a-k
# and the q/k norm and RoPE's N1 and N2 (phases 10 and 13 launch none)
QWEN_KERNELS = ("fused_mask_attention", "fused_mask_attention_bwd", "fused_moe_ffn",
                "fused_moe_ffn_bwd", "fused_ce_rows", "fused_ce_rows_bwd", "qk_norm_rope_fwd",
                "qk_norm_rope_bwd")
F32_TOL, BF16_TOL, LOSS_TOL = 1e-4, 2e-2, 1e-2
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-5, 1e-3  # fp32 train step, kernel path vs plain path
# bf16 train step, kernel path vs plain path, set from the readings of
# scripts/probe_step_tolerance.py on an H100: sound runs reach a loss diff of
# 7.6e-5 and a grad err of 8.5e-2 (the q/k RMSNorm weights, whose grads sum
# many bf16 products); planted faults give grad errs of 1.0 and more
BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL = 5e-4, 0.3
DROP_SEED, DROP_RATE = 1234, 0.2
MP_TIMEOUT_S = 300  # phase 11: each process group's timeout and each worker's
NEG = -1e30  # score of a dead beam (gamer_tpu_torch/decode/beam.py)
BEAM_BATCH, NUM_BEAMS, LEVELS, LEVEL_SIZE, N_ITEMS, PROMPT_BLOCKS = 128, 20, 4, 256, 4096, 100


def flagship_config(**overrides):
    """Flagship Qwen3Multi widths (`gamer_tpu_torch.entry.flagship_config`)
    in bf16, dropout off unless overridden."""
    from gamer_tpu_torch.entry import flagship_config as config

    return config(**{"dtype": "bfloat16", **overrides})


def make_batch(cfg, batch_size: int, blocks: int, seed: int = 0) -> dict:
    """A padding-free batch of item blocks [<behavior>, codes]."""
    from gamer_tpu_torch.entry import make_batch as batch

    return batch(cfg, batch_size, blocks, np.random.default_rng(seed))


def make_trie_and_prompts(cfg, batch_size: int, n_items: int, levels: int, level_size: int,
                          max_blocks: int, seed: int = 0, behavior_level: bool = False):
    """A trie of `n_items` distinct code rows over `levels` levels of
    `level_size` codes (token base 17 + level_size * level), and left-padded
    prompts of whole item blocks plus the target behavior token. With
    `behavior_level`, the trie of the behavior-token decode (level 0 the
    behavior token, then the item's levels, as test_MB_decoder's
    BEHAVIOR_ITEM mode builds it) and prompts that end at a block boundary
    (one more column of padding)."""
    from gamer_tpu_torch.data.vocab import PAD_ID
    from gamer_tpu_torch.decode.trie import LeveledTrie

    rng = np.random.default_rng(seed)
    codes = np.unique(rng.integers(0, level_size, (n_items, levels)), axis=0)
    code_base = cfg.behavior_base + cfg.num_behavior
    bases = [code_base + level_size * lvl for lvl in range(levels)]
    if behavior_level:
        n = cfg.num_behavior
        trie = LeveledTrie.build(
            np.concatenate([np.repeat(np.arange(n), len(codes))[:, None], np.tile(codes, (n, 1))],
                           axis=1), [n] + [level_size] * levels, [cfg.behavior_base] + bases)
    else:
        trie = LeveledTrie.build(codes, [level_size] * levels, bases)
    S = max_blocks * (levels + 1) + 1
    ids = np.full((batch_size, S), PAD_ID, np.int32)
    attn = np.zeros((batch_size, S), np.int32)
    sessions = np.zeros((batch_size, S), np.int32)
    actions = np.zeros((batch_size, S), np.int32)
    prompt_len = np.zeros(batch_size, np.int32)
    for b in range(batch_size):
        blocks = max_blocks if b % 2 == 0 else int(rng.integers(1, max_blocks))
        items = codes[rng.integers(0, len(codes), blocks)] + np.asarray(bases)
        behs = rng.integers(0, cfg.num_behavior, blocks + 1)
        tail = [] if behavior_level else [[cfg.behavior_base + behs[-1]]]
        toks = np.concatenate([np.concatenate([[cfg.behavior_base + behs[i]], items[i]])
                               for i in range(blocks)] + tail)
        n = len(toks)
        ids[b, S - n:] = toks
        attn[b, S - n:] = 1
        sessions[b, S - n:] = np.repeat(np.sort(rng.integers(0, 5, blocks + 1)),
                                        levels + 1)[:n]
        actions[b, S - n:] = np.repeat(behs + 1, levels + 1)[:n]
        prompt_len[b] = n
    batch = {"input_ids": ids, "attention_mask": attn, "session_ids": sessions,
             "actions": actions,
             "extended_session_ids": np.maximum(np.cumsum(attn, axis=1) - 1, 0).astype(np.int32),
             "prompt_len": prompt_len}
    behavior_ids = (rng.integers(0, cfg.num_behavior, batch_size) + 1).astype(np.int32)
    return trie, batch, behavior_ids


def run_forward(cfg, device, seed: int = 0):
    """The model and its scoring-loss entry point."""
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    model = QwenFamilyModel(cfg, device=device, seed=seed)
    loss_fn = make_loss_fn(model, cfg, deterministic=True)
    return model, loss_fn


def check_beams(trie, codes, scores, batch_size, num_beams):
    """Shapes, finite and sorted scores, every code path in the trie."""
    codes, scores = codes.cpu().numpy(), scores.float().cpu().numpy()
    assert codes.shape == (batch_size, num_beams, trie.num_levels), codes.shape
    assert scores.shape == (batch_size, num_beams), scores.shape
    assert np.isfinite(scores).all() and (scores > NEG / 2).all(), "dead or non-finite beams"
    assert (np.diff(scores, axis=1) <= 0).all(), "beam scores are not sorted"
    for row in codes.reshape(-1, trie.num_levels):
        node = 0
        for lvl, c in enumerate(row):
            node = int(trie.child[lvl][node, c])
            assert node >= 0, f"code path {row.tolist()} is not in the trie"


# --------------------------------------------------------------------------- card-only


def _cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of `fn`: `iters` calls captured in a CUDA
    graph and replayed, so that the host's cost of a launch, which exceeds a
    short kernel's device time, is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def _host_us(fn, iters: int = 200) -> float:
    """Host time of one call of `fn` (a launch's Python, checks and CUDA runtime
    call), with the card kept busy ahead of it: µs a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / iters * 1e6


def _rel_err(out, ref) -> tuple[float, float]:
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def _bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _rate(flops: float, ms: float, bound: float) -> str:
    """Achieved TFLOP/s and share of the bound of a kernel time."""
    return f"{flops / ms / 1e9:.2f} TFLOP/s, {100 * bound / ms:.2f}% of bound"


def _cuobjdump() -> str:
    """cuobjdump beside nvcc, else the copy in Triton's package; raises if
    neither exists."""
    from gamer_tpu_torch.ops import _build

    cands = [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    except ImportError:
        pass
    for cand in cands:
        if os.path.exists(cand):
            return cand
    raise RuntimeError(f"cuobjdump not found (looked at {cands})")


def tensor_core_counts() -> dict:
    """{library: {"HMMA": n, "HGMMA": n}} from each built library's SASS;
    raises if a library has no tensor-core instruction (except the
    elementwise ones, `NO_TENSOR_CORES`)."""
    from gamer_tpu_torch.ops import _build

    tool, counts = _cuobjdump(), {}
    for name in _build.KERNEL_SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HMMA", "HGMMA")}
        print(f"sass {name}: {counts[name]['HMMA']} HMMA, {counts[name]['HGMMA']} HGMMA "
              f"tensor-core instructions", flush=True)
    for name in _build.KERNEL_SOURCES:
        if name not in NO_TENSOR_CORES and not sum(counts[name].values()):
            raise AssertionError(f"{name} has no tensor-core instruction in its SASS")
    return counts


def _products_ms(products) -> float:
    """Time of a list of (A, B) bf16 products as cuBLAS `torch.bmm` calls."""
    import torch

    return _cuda_ms(lambda: [torch.bmm(a, b) for a, b in products])


def _check(name, kernel, plain, args32, args16):
    """kernel vs plain on fp32 inputs (F32_TOL) and on bf16 inputs, plain in
    fp32 (BF16_TOL); returns the bf16 max abs error."""
    import torch

    out = kernel(*args32)
    torch.cuda.synchronize()
    ref = plain(*args32)
    _, rel32 = _rel_err(out[0] if isinstance(out, tuple) else out,
                        ref[0] if isinstance(ref, tuple) else ref)
    up = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args16]
    out16 = kernel(*args16)
    torch.cuda.synchronize()
    ref16 = plain(*up)
    err16, rel16 = _rel_err(out16[0] if isinstance(out16, tuple) else out16,
                            ref16[0] if isinstance(ref16, tuple) else ref16)
    ok = rel32 <= F32_TOL and rel16 <= BF16_TOL
    print(f"check {name}: fp32 rel err {rel32:.3e} (tol {F32_TOL}), bf16 rel err {rel16:.3e} "
          f"(tol {BF16_TOL}) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain version")
    return err16


def _attn_inputs(dev, cfg, B: int, S: int, seed: int, rnd):
    """q, k, v (fp32, from `rnd`) and the four mask streams of a batch with
    some right-padded rows and random sessions and actions."""
    import torch

    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    rng = np.random.default_rng(seed)
    attn = np.ones((B, S), np.int32)
    attn[1::4, S - S // 7:] = 0  # some right-padded rows
    blocks = -(-S // 5)
    sess = np.repeat(np.sort(rng.integers(0, 5, (B, blocks)), 1), 5, 1)[:, :S]
    act = np.repeat(rng.integers(1, 4, (B, blocks)), 5, 1)[:, :S]
    rel = np.cumsum(attn, 1) - 1
    blk = np.where(attn == 1, rel // 5, -1)
    streams = [torch.as_tensor(x.astype(np.int32), device=dev) for x in (attn, sess, act, blk)]
    return rnd(B, S, H * D), rnd(B, S, Hkv * D), rnd(B, S, Hkv * D), streams


def kernel_phase(dev) -> dict:
    """Phase 2: every kernel against its plain version, and its timings."""
    import torch
    import torch.nn.functional as F

    from gamer_tpu_torch.ops.fused_attention import (
        fused_mask_attention, fused_mask_attention_plain)
    from gamer_tpu_torch.ops.fused_ce import fused_ce_rows, fused_ce_rows_plain
    from gamer_tpu_torch.ops.fused_moe import fused_moe_ffn, fused_moe_ffn_plain
    from gamer_tpu_torch.ops.masks import streams_allowed

    g = torch.Generator(device="cpu").manual_seed(1)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g) * scale).to(dev)
    entries = {}
    cfg = flagship_config()
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    # ---- a: attention, flagship B=64 x S=505 and B=1 at S = 2048, 8192
    attn_inputs = lambda B, S, seed: _attn_inputs(dev, cfg, B, S, seed, rnd)
    attn_ms = {}
    for (B, S, kinds) in ((64, 505, ("causal", "multi", "session", "session_multi")),
                          (1, 2048, ("causal", "multi")), (1, 8192, ("causal",))):
        q, k, v, streams = attn_inputs(B, S, S)
        for kind in kinds:
            a32 = (q, k, v, *streams, 0, H, kind)
            a16 = (q.bfloat16(), k.bfloat16(), v.bfloat16(), *streams, 0, H, kind)
            err = _check(f"fused_mask_attention[{kind},B={B},S={S}]", fused_mask_attention,
                         fused_mask_attention_plain, a32, a16)
            if B == 64 and kind in ("causal", "multi"):
                allowed = streams_allowed(kind, *streams)
                pairs = float(allowed.sum().item())  # allowed (query, key) pairs of this data
                n_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * 4 * B * S
                flops = 4.0 * H * D * pairs
                bound, by = _bound_ms(n_bytes, flops)
                ms = _cuda_ms(lambda: fused_mask_attention(*a16))
                plain_ms = _cuda_ms(lambda: fused_mask_attention_plain(*a16), iters=3)
                qh = a16[0].view(B, S, H, D).transpose(1, 2)
                kh = a16[1].view(B, S, Hkv, D).transpose(1, 2)
                vh = a16[2].view(B, S, Hkv, D).transpose(1, 2)
                lib_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=allowed, enable_gqa=True))
                attn_ms[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by, max_abs_err=err)
                print(f"time fused_mask_attention[{kind}] B={B} S={S} bf16: kernel {ms:.4f} ms "
                      f"({_rate(flops, ms, bound)}), plain {plain_ms:.4f} ms, sdpa(bool mask) "
                      f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
    # the scoring forward runs 8 causal + 4 multi calls: report their mean
    entries["fused_mask_attention"] = {
        key: (8 * attn_ms["causal"][key] + 4 * attn_ms["multi"][key]) / 12
        for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    entries["fused_mask_attention"]["bound_by"] = attn_ms["causal"]["bound_by"]
    entries["fused_mask_attention"]["max_abs_err"] = max(v["max_abs_err"] for v in attn_ms.values())

    # ---- h: MoE FFN, flagship expert-major shapes
    P, T, Dm, Fd, NB = cfg.num_positions, 64 * 101, cfg.hidden_size, cfg.intermediate_size, 4
    xp, wgu = rnd(P, T, Dm), rnd(P, Dm, 2 * Fd, scale=Dm ** -0.5)
    wd, btab = rnd(P, Fd, Dm, scale=Fd ** -0.5), rnd(P, NB, 2 * Fd, scale=0.5)
    beh = torch.as_tensor(np.random.default_rng(2).integers(0, NB, (P, T)).astype(np.int32),
                          device=dev)
    for use_bias in (True, False):
        a32 = (xp, wgu, wd, btab, beh, use_bias)
        a16 = (xp.bfloat16(), wgu.bfloat16(), wd.bfloat16(), btab.bfloat16(), beh, use_bias)
        kern = lambda x, w1, w2, bt, bh, ub: fused_moe_ffn(x, w1, w2, bt, bh, use_bias=ub)
        err = _check(f"fused_moe_ffn[bias={use_bias}]", kern, fused_moe_ffn_plain, a32, a16)
        if use_bias:
            n_bytes = 2 * (xp.numel() + wgu.numel() + wd.numel() + btab.numel() + P * T * Dm) \
                + 4 * beh.numel()
            flops = 2.0 * P * T * (Dm * 2 * Fd + Fd * Dm)
            bound, by = _bound_ms(n_bytes, flops)
            ms = _cuda_ms(lambda: kern(*a16))
            plain_ms = _cuda_ms(lambda: fused_moe_ffn_plain(*a16), iters=3)
            h16 = rnd(P, T, Fd).bfloat16()
            bmm_ms = _products_ms([(a16[0], a16[1]), (h16, a16[2])])
            entries["fused_moe_ffn"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                            bound_ms=bound, bound_by=by, max_abs_err=err)
            print(f"time fused_moe_ffn P={P} T={T} bf16: kernel {ms:.4f} ms "
                  f"({_rate(flops, ms, bound)}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({by}); yardstick, its 2 products alone as cuBLAS bf16 bmm (no "
                  f"elementwise work, not the function): {bmm_ms:.4f} ms "
                  f"({_rate(flops, bmm_ms, bound)})", flush=True)

    # ---- h at each activation (silu, tanh-gelu, relu), bias and dropout 0.2
    for act in ("silu", "gelu", "relu"):
        kern = lambda x, w1, w2, bt, bh: fused_moe_ffn(x, w1, w2, bt, bh, DROP_SEED, act, DROP_RATE,
                                                       True)
        plain = lambda x, w1, w2, bt, bh: fused_moe_ffn_plain(x, w1, w2, bt, bh, True, DROP_SEED,
                                                              DROP_RATE, act)
        a16 = (xp.bfloat16(), wgu.bfloat16(), wd.bfloat16(), btab.bfloat16(), beh)
        _check(f"fused_moe_ffn[{act},bias,rate={DROP_RATE}]", kern, plain,
               (xp, wgu, wd, btab, beh), a16)
        ms = _cuda_ms(lambda: kern(*a16))
        print(f"time fused_moe_ffn[{act}] P={P} T={T} bf16 bias rate {DROP_RATE}: kernel "
              f"{ms:.4f} ms ({_rate(flops, ms, bound)})", flush=True)

    # ---- j: tied-head CE, flagship N = 64 x 504 rows, V = 1041
    N, V = 64 * 504, cfg.vocab_size
    h, table = rnd(N, Dm), rnd(V, Dm, scale=Dm ** -0.5)
    rng = np.random.default_rng(3)
    tgt = torch.as_tensor(rng.integers(0, V, N).astype(np.int32), device=dev)
    val = torch.as_tensor((rng.random(N) > 0.2).astype(np.int32), device=dev)
    a32, a16 = (h, table, tgt, val, 1.0), (h.bfloat16(), table.bfloat16(), tgt, val, 1.0)
    err = _check("fused_ce_rows", fused_ce_rows, fused_ce_rows_plain, a32, a16)
    n_bytes = 2 * (h.numel() + table.numel()) + 4 * (2 * N) + 4 * (2 * N)
    flops = 2.0 * N * V * Dm
    bound, by = _bound_ms(n_bytes, flops)
    ms = _cuda_ms(lambda: fused_ce_rows(*a16))
    plain_ms = _cuda_ms(lambda: fused_ce_rows_plain(*a16), iters=3)
    lib_ms = _cuda_ms(lambda: torch.logsumexp((a16[0] @ a16[1].T).float(), dim=-1))
    entries["fused_ce_rows"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                    bound_ms=bound, bound_by=by, max_abs_err=err)
    print(f"time fused_ce_rows N={N} V={V} bf16: kernel {ms:.4f} ms ({_rate(flops, ms, bound)}), "
          f"plain {plain_ms:.4f} ms, matmul+logsumexp {lib_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by})", flush=True)
    return entries


def _grad_check(name: str, got, want, tol: float) -> float:
    """Every tensor of `got` against `want` as max |d| / max |want|; returns
    the largest max abs error, raises above `tol`."""
    worst_rel, worst_abs = 0.0, 0.0
    for g_, w_ in zip(got, want):
        err, rel = _rel_err(g_, w_)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
    ok = worst_rel <= tol
    print(f"check {name}: rel err {worst_rel:.3e} (tol {tol}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return worst_abs


def _grad_ms(out, leaves, grad_out, iters: int = 10) -> float:
    """Time of the backward of a recorded graph (CUDA events)."""
    import torch

    return _cuda_ms(lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True,
                                                allow_unused=True), iters)


def backward_phase(dev) -> dict:
    """Phase 2b: the backward kernels b, i, k against autograd through the
    plain versions (fp32 at F32_TOL, bf16 at BF16_TOL, dropout 0 and 0.2),
    and their timings; attention also at the long lengths (rows c-g)."""
    import torch
    import torch.nn.functional as F

    from gamer_tpu_torch.ops import fused_attention as FA
    from gamer_tpu_torch.ops import fused_ce as FC
    from gamer_tpu_torch.ops import fused_moe as FM
    from gamer_tpu_torch.ops.masks import streams_allowed

    g = torch.Generator(device="cpu").manual_seed(2)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g) * scale).to(dev)
    cfg = flagship_config()
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    entries, long_s = {}, {}

    # ---- b (with a's lse and dropout): flagship B=64 x S=505, long S at B=1
    b_ms = {}
    for (B, S, kinds) in ((64, 505, ("causal", "multi")), (1, 2048, ("causal", "multi")),
                          (1, 8192, ("causal",))):
        q, k, v, streams = _attn_inputs(dev, cfg, B, S, 10 + S, rnd)
        dout = rnd(B, S, H * D)
        for kind in kinds:
            errs = []
            for rate in (0.0, DROP_RATE):
                for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
                    leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
                    out = FA.fused_mask_attention(*leaves, *streams, DROP_SEED, H, kind, rate)
                    grads = torch.autograd.grad(out, leaves, dout.to(dtype))
                    up = [t.detach().float() for t in leaves]
                    want_out = FA.fused_mask_attention_plain(*up, *streams, DROP_SEED, H, kind,
                                                             rate)
                    want = FA.fused_mask_attention_bwd_plain(
                        *up, dout.to(dtype).float(), *streams, DROP_SEED, H, kind, rate)
                    torch.cuda.synchronize()
                    errs.append(_grad_check(
                        f"attention a+b[{kind},B={B},S={S},rate={rate},{dtype}]",
                        (out, *grads), (want_out, *want), tol))
                    del out, grads, want_out, want
            # timings in bf16 at the training rate
            q16, k16, v16, d16 = q.bfloat16(), k.bfloat16(), v.bfloat16(), dout.bfloat16()
            args = (*streams, DROP_SEED, H, kind, DROP_RATE)
            out, lse = FA._launch_fwd(q16, k16, v16, streams, DROP_SEED, H, kind, DROP_RATE,
                                      with_lse=True)
            ms = _cuda_ms(lambda: FA.fused_mask_attention_bwd(q16, k16, v16, out, d16, lse, *args))
            fwd_ms = _cuda_ms(lambda: FA._launch_fwd(q16, k16, v16, streams, DROP_SEED, H, kind,
                                                     DROP_RATE, with_lse=True))
            leaves = [t.clone().requires_grad_(True) for t in (q16, k16, v16)]
            plain_fwd_ms = _cuda_ms(lambda: FA.fused_mask_attention_plain(*leaves, *args), iters=2)
            with torch.enable_grad():
                pout = FA.fused_mask_attention_plain(*leaves, *args)
            plain_ms = _grad_ms(pout, leaves, d16, iters=2)
            del pout
            allowed = streams_allowed(kind, *streams)
            heads = lambda t, n: t.detach().view(B, S, n, D).transpose(1, 2).requires_grad_(True)
            q4, k4, v4 = heads(q16, H), heads(k16, Hkv), heads(v16, Hkv)
            with torch.enable_grad():
                lout = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=allowed,
                                                      enable_gqa=True)
            lib_ms = _grad_ms(lout, (q4, k4, v4), d16.view(B, S, H, D).transpose(1, 2), iters=5)
            lib_fwd_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=allowed, enable_gqa=True), iters=5)
            del lout
            pairs = float(allowed.sum().item()) * H  # allowed (query, key) pairs, all heads
            io = 2 * (q16.numel() + k16.numel() + v16.numel())
            bound, by = _bound_ms(2 * io + 2 * d16.numel() + 4 * 2 * B * H * S + 16 * B * S,
                                  10.0 * D * pairs)
            fbound, fby = _bound_ms(io + 2 * q16.numel() + 4 * B * H * S + 16 * B * S,
                                    4.0 * D * pairs)
            print(f"time fused_mask_attention_bwd[{kind}] B={B} S={S} bf16 rate {DROP_RATE}: "
                  f"kernel {ms:.4f} ms ({_rate(10.0 * D * pairs, ms, bound)}), plain "
                  f"{plain_ms:.4f} ms, sdpa(bool mask) backward {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}); forward with lse: kernel {fwd_ms:.4f} ms "
                  f"({_rate(4.0 * D * pairs, fwd_ms, fbound)}), plain {plain_fwd_ms:.4f} ms, "
                  f"sdpa {lib_fwd_ms:.4f} ms, bound {fbound:.4f} ms ({fby})", flush=True)
            if B == 64:  # two bf16 launches of a and b on the same inputs: bit-identical
                out2, lse2 = FA._launch_fwd(q16, k16, v16, streams, DROP_SEED, H, kind,
                                            DROP_RATE, with_lse=True)
                runs = [FA.fused_mask_attention_bwd(q16, k16, v16, out, d16, lse, *args)
                        for _ in range(2)]
                same = torch.equal(out, out2) and torch.equal(lse, lse2) and all(
                    torch.equal(x, y) for x, y in zip(*runs))
                print(f"check determinism a+b[{kind},B={B},S={S},rate={DROP_RATE},bf16]: two "
                      f"launches {'bit-identical' if same else 'DIFFER'}", flush=True)
                if not same:
                    raise AssertionError("attention kernels a/b are not deterministic")
                del out2, lse2, runs
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                          bound_by=by, max_abs_err=max(errs))
            if B == 64:
                b_ms[kind] = timing
            elif kind == "causal":  # the self-attention kind: 8 of the 12 calls a step
                long_s[(S, "bwd")] = timing
                long_s[(S, "fwd")] = dict(ms=fwd_ms, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
                                          bound_ms=fbound, bound_by=fby, max_abs_err=max(errs))
            del out, lse
    entries["fused_mask_attention_bwd"] = {
        key: (8 * b_ms["causal"][key] + 4 * b_ms["multi"][key]) / 12
        for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    entries["fused_mask_attention_bwd"]["bound_by"] = b_ms["causal"]["bound_by"]
    entries["fused_mask_attention_bwd"]["max_abs_err"] = max(v["max_abs_err"] for v in b_ms.values())

    # ---- i: MoE backward, flagship expert-major shapes, with and without bias
    P, T, Dm, Fd, NB = cfg.num_positions, 64 * 101, cfg.hidden_size, cfg.intermediate_size, 4
    xp, wgu = rnd(P, T, Dm), rnd(P, Dm, 2 * Fd, scale=Dm ** -0.5)
    wd, btab = rnd(P, Fd, Dm, scale=Fd ** -0.5), rnd(P, NB, 2 * Fd, scale=0.5)
    gout = rnd(P, T, Dm)
    beh = torch.as_tensor(np.random.default_rng(4).integers(0, NB, (P, T)).astype(np.int32),
                          device=dev)
    n_bytes = 2 * 2 * (xp.numel() + wgu.numel() + wd.numel() + btab.numel()) \
        + 2 * 2 * gout.numel() + 4 * beh.numel()
    flops = 2.0 * P * T * (3 * Dm * 2 * Fd + 2 * Fd * Dm)
    bound, by = _bound_ms(n_bytes, flops)
    i_ms, errs = [], []
    for use_bias in (True, False):
        for rate in (0.0, DROP_RATE):
            for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
                leaves = [t.to(dtype).requires_grad_(True) for t in (xp, wgu, wd, btab)]
                out = FM.fused_moe_ffn(*leaves, beh, DROP_SEED, rate=rate, use_bias=use_bias)
                grads = torch.autograd.grad(out, leaves, gout.to(dtype))
                up = [t.detach().float() for t in leaves]
                want = FM.fused_moe_ffn_bwd_plain(*up, beh, gout.to(dtype).float(), DROP_SEED,
                                                  rate, use_bias)
                want_out = FM.fused_moe_ffn_plain(*up, beh, use_bias, DROP_SEED, rate)
                torch.cuda.synchronize()
                n = 4 if use_bias else 3  # without bias dbtab is 0 on both sides
                errs.append(_grad_check(
                    f"moe h+i[bias={use_bias},rate={rate},{dtype}]", (out, *grads[:n]),
                    (want_out, *want[:n]), tol))
                if not use_bias:
                    assert (grads[3] == 0).all() and (want[3] == 0).all()
        a16 = [t.bfloat16() for t in (xp, wgu, wd, btab)]
        ms = _cuda_ms(lambda: FM.fused_moe_ffn_bwd(*a16, beh, gout.bfloat16(), DROP_SEED,
                                                    DROP_RATE, use_bias))
        leaves = [t.clone().requires_grad_(True) for t in a16]
        with torch.enable_grad():
            pout = FM.fused_moe_ffn_plain(*leaves, beh, use_bias, DROP_SEED, DROP_RATE)
        plain_ms = _grad_ms(pout, leaves, gout.bfloat16(), iters=3)
        i_ms.append((ms, plain_ms))
        print(f"time fused_moe_ffn_bwd P={P} T={T} bf16 bias={use_bias} rate {DROP_RATE}: "
              f"kernel {ms:.4f} ms ({_rate(flops, ms, bound)}), plain {plain_ms:.4f} ms",
              flush=True)
    # i at the other activations (bias, dropout 0.2); silu's time is the
    # first of i_ms
    for act in ("gelu", "relu"):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            leaves = [t.to(dtype).requires_grad_(True) for t in (xp, wgu, wd, btab)]
            out = FM.fused_moe_ffn(*leaves, beh, DROP_SEED, act, DROP_RATE, True)
            grads = torch.autograd.grad(out, leaves, gout.to(dtype))
            up = [t.detach().float() for t in leaves]
            want = FM.fused_moe_ffn_bwd_plain(*up, beh, gout.to(dtype).float(), DROP_SEED,
                                              DROP_RATE, True, act)
            want_out = FM.fused_moe_ffn_plain(*up, beh, True, DROP_SEED, DROP_RATE, act)
            torch.cuda.synchronize()
            errs.append(_grad_check(f"moe h+i[{act},bias,rate={DROP_RATE},{dtype}]",
                                    (out, *grads), (want_out, *want), tol))
        a16 = [t.bfloat16() for t in (xp, wgu, wd, btab)]
        ms = _cuda_ms(lambda: FM.fused_moe_ffn_bwd(*a16, beh, gout.bfloat16(), DROP_SEED,
                                                    DROP_RATE, True, act))
        print(f"time fused_moe_ffn_bwd[{act}] P={P} T={T} bf16 bias rate {DROP_RATE}: kernel "
              f"{ms:.4f} ms ({_rate(flops, ms, bound)}); silu {i_ms[0][0]:.4f} ms", flush=True)
    # yardstick: the function's 5 products alone (gate/up recompute, dh, dx,
    # dWgu, dWd) as cuBLAS bf16 bmm on operands of the same shapes
    x16, w16, d16, g16 = (t.bfloat16() for t in (xp, wgu, wd, gout))
    dgu16, h16 = rnd(P, T, 2 * Fd).bfloat16(), rnd(P, T, Fd).bfloat16()
    bmm_ms = _products_ms([(x16, w16), (g16, d16.transpose(1, 2)), (dgu16, w16.transpose(1, 2)),
                           (x16.transpose(1, 2), dgu16), (h16.transpose(1, 2), g16)])
    print(f"yardstick fused_moe_ffn_bwd P={P} T={T}: its 5 products alone as cuBLAS bf16 bmm "
          f"(no elementwise work, not the function) {bmm_ms:.4f} ms "
          f"({_rate(flops, bmm_ms, bound)}); bound {bound:.4f} ms ({by})", flush=True)
    # two bf16 launches of h and of i on the same inputs: bit-identical
    b16 = btab.bfloat16()
    runs = [(FM._launch_fwd(x16, w16, d16, b16, beh, DROP_SEED, DROP_RATE, True),
             *FM.fused_moe_ffn_bwd(x16, w16, d16, b16, beh, g16, DROP_SEED, DROP_RATE, True))
            for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    print(f"check determinism h+i[P={P},T={T},bias,rate={DROP_RATE},bf16]: two launches "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        raise AssertionError("MoE kernels h/i are not deterministic")
    del runs
    entries["fused_moe_ffn_bwd"] = dict(
        ms=float(np.mean([m for m, _ in i_ms])), plain_ms=float(np.mean([p for _, p in i_ms])),
        library_ms=None, bound_ms=bound, bound_by=by, max_abs_err=max(errs))

    # ---- k: CE backward, flagship N = 64 x 504 rows, V = 1041
    N, V = 64 * 504, cfg.vocab_size
    h, table = rnd(N, Dm), rnd(V, Dm, scale=Dm ** -0.5)
    rng = np.random.default_rng(5)
    tgt = torch.as_tensor(rng.integers(0, V, N).astype(np.int32), device=dev)
    val = torch.as_tensor((rng.random(N) > 0.2).astype(np.int32), device=dev)
    gnll = torch.rand(N, generator=g).to(dev) / N
    errs = []
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        leaves = [t.to(dtype).requires_grad_(True) for t in (h, table)]
        nll, _ = FC.fused_ce_rows(*leaves, tgt, val, 1.0)
        grads = torch.autograd.grad(nll, leaves, gnll)
        want = FC.fused_ce_rows_bwd_plain(*(t.detach().float() for t in leaves), tgt, val, gnll,
                                          1.0)
        torch.cuda.synchronize()
        errs.append(_grad_check(f"ce j+k[{dtype}]", grads, want, tol))
    h16, t16 = h.bfloat16(), table.bfloat16()
    _, lse = FC._launch_fwd(h16, t16, tgt, val, 1.0)
    ms = _cuda_ms(lambda: FC.fused_ce_rows_bwd(h16, t16, tgt, val, lse, gnll, 1.0))
    leaves = [t.clone().requires_grad_(True) for t in (h16, t16)]
    with torch.enable_grad():
        pnll, _ = FC.fused_ce_rows_plain(*leaves, tgt, val, 1.0)
        logits = leaves[0] @ leaves[1].T
        lnll = torch.logsumexp(logits.float(), dim=-1) - logits.float().gather(
            1, tgt.long()[:, None])[:, 0]
    plain_ms = _grad_ms(pnll, leaves, gnll, iters=3)
    lib_ms = _grad_ms(lnll, leaves, gnll)
    n_bytes = 2 * 2 * (h.numel() + table.numel()) + 4 * 4 * N
    flops = 3 * 2.0 * N * V * Dm
    bound, by = _bound_ms(n_bytes, flops)
    entries["fused_ce_rows_bwd"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                        bound_ms=bound, bound_by=by, max_abs_err=max(errs))
    print(f"time fused_ce_rows_bwd N={N} V={V} bf16: kernel {ms:.4f} ms "
          f"({_rate(flops, ms, bound)}), plain {plain_ms:.4f} ms, matmul+logsumexp backward "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
    # two bf16 launches of j and of k on the same inputs: bit-identical
    runs = []
    for _ in range(2):
        nll, lse2 = FC._launch_fwd(h16, t16, tgt, val, 1.0)
        runs.append((nll, lse2, *FC.fused_ce_rows_bwd(h16, t16, tgt, val, lse2, gnll, 1.0)))
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    print(f"check determinism j+k[N={N},V={V},bf16]: two launches "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        raise AssertionError("CE kernels j/k are not deterministic")
    return entries, long_s


def _width_case(name: str, fn, plain_fn, inputs: list, gout, flops: tuple, n_bytes: tuple,
                card: str, lib: tuple | None = None) -> None:
    """One width case of phase 2c: `fn(*inputs)` through the kernels (forward
    and autograd backward) against `plain_fn` in fp32, on fp32 inputs at
    F32_TOL and on bf16 inputs at BF16_TOL; then the bf16 forward and
    backward times beside their bounds (flops and bytes: forward, backward),
    those of `plain_fn` and, where `lib` = (label, function) names one
    PyTorch call of the same function, those of that call."""
    import torch

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        g = gout.to(out.dtype)
        grads = torch.autograd.grad(out, leaves, g)
        up = [t.detach().float().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            want_out = plain_fn(*up)
            want = torch.autograd.grad(want_out, up, g.float())
        torch.cuda.synchronize()
        _grad_check(f"width {name} fwd+bwd [{dtype}]", (out, *grads), (want_out, *want), tol)
        del out, grads, want_out, want
    leaves = [t.detach().bfloat16().requires_grad_(True) for t in inputs]

    def fwd_bwd_ms(f, iters: int) -> tuple[float, float]:
        with torch.no_grad():
            fwd = _cuda_ms(lambda: f(*leaves), iters)
        with torch.enable_grad():
            out = f(*leaves)
        return fwd, _grad_ms(out, leaves, gout.to(out.dtype), iters)

    fwd_ms, bwd_ms = fwd_bwd_ms(fn, 10)
    plain_fwd, plain_bwd = fwd_bwd_ms(plain_fn, 3)
    fb, fby = _bound_ms(n_bytes[0], flops[0])
    bb, bby = _bound_ms(n_bytes[1], flops[1])
    lib_text = ""
    if lib is not None:
        lib_fwd, lib_bwd = fwd_bwd_ms(lib[1], 5)
        lib_text = f"; {lib[0]}: forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms"
    print(f"time width {name} bf16: forward {fwd_ms:.4f} ms ({_rate(flops[0], fwd_ms, fb)}; "
          f"bound {fb:.4f} ms, {fby}), backward {bwd_ms:.4f} ms ({_rate(flops[1], bwd_ms, bb)}; "
          f"bound {bb:.4f} ms, {bby}); plain: forward {plain_fwd:.4f} ms, backward "
          f"{plain_bwd:.4f} ms{lib_text} (card {card})", flush=True)
    del leaves


def width_phase(dev, card: str) -> None:
    """Phase 2c: the widths past the flagship's, each through the kernels
    forward and backward against the plain versions: MoE h/i at hidden 512
    (D = Dout 512, F 1024, the streamed forward) and at D 200, F 344 (the pad
    route), CE j/k at D 512 and 1024 (the wide kernels), attention a/b at
    head dims 48, 96 (padded), 256, and 320 and 512 (the wide route, 64
    output columns a CTA) at B 8 x S 505; bias and dropout 0.2 where the
    kernel has them."""
    import torch
    import torch.nn.functional as F

    from gamer_tpu_torch.ops import fused_attention as FA
    from gamer_tpu_torch.ops import fused_ce as FC
    from gamer_tpu_torch.ops import fused_moe as FM
    from gamer_tpu_torch.ops.masks import streams_allowed

    g = torch.Generator(device="cpu").manual_seed(4)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g) * scale).to(dev)
    P, T, NB = 5, 64 * 101, 4
    beh = torch.as_tensor(np.random.default_rng(6).integers(0, NB, (P, T)).astype(np.int32),
                          device=dev)
    for D, Fd in ((512, 1024), (200, 344)):
        inputs = [rnd(P, T, D), rnd(P, D, 2 * Fd, scale=D ** -0.5),
                  rnd(P, Fd, D, scale=Fd ** -0.5), rnd(P, NB, 2 * Fd, scale=0.5)]
        io = 2 * (sum(t.numel() for t in inputs) + P * T * D) + 4 * beh.numel()
        _width_case(f"moe h+i D={D} F={Fd} Dout={D} P={P} T={T}",
                    lambda *w: FM.fused_moe_ffn(*w, beh, DROP_SEED, "silu", DROP_RATE, True),
                    lambda *w: FM.fused_moe_ffn_plain(*w, beh, True, DROP_SEED, DROP_RATE),
                    inputs, rnd(P, T, D),
                    (2.0 * P * T * (D * 2 * Fd + Fd * D), 2.0 * P * T * (3 * D * 2 * Fd + 2 * Fd * D)),
                    (io, 2 * io), card)
    N, V = 64 * 504, 1041
    rng = np.random.default_rng(7)
    tgt = torch.as_tensor(rng.integers(0, V, N).astype(np.int32), device=dev)
    val = torch.as_tensor((rng.random(N) > 0.2).astype(np.int32), device=dev)

    def ce_lib(h, e):
        logits = (h @ e.T).float()
        return torch.logsumexp(logits, dim=-1) - logits.gather(1, tgt.long()[:, None])[:, 0]

    for D in (512, 1024):
        inputs = [rnd(N, D), rnd(V, D, scale=D ** -0.5)]
        io = 2 * (N * D + V * D) + 16 * N
        _width_case(f"ce j+k D={D} N={N} V={V}",
                    lambda h, e: FC.fused_ce_rows(h, e, tgt, val, 1.0)[0],
                    lambda h, e: FC.fused_ce_rows_plain(h, e, tgt, val, 1.0)[0],
                    inputs, torch.rand(N, generator=g).to(dev) / N,
                    (2.0 * N * V * D, 3 * 2.0 * N * V * D), (io, 2 * io), card,
                    lib=("matmul+logsumexp", ce_lib))
    B, S = 8, 505
    for D in (48, 96, 256, 320, 512):
        cfg = flagship_config(head_dim=D)
        H = cfg.num_attention_heads
        q, k, v, streams = _attn_inputs(dev, cfg, B, S, D, rnd)
        allowed = streams_allowed("causal", *streams)
        pairs = float(allowed.sum().item()) * H
        io = 2 * (q.numel() + k.numel() + v.numel())

        def sdpa(q, k, v, D=D, H=H, Hkv=cfg.num_key_value_heads, allowed=allowed):
            heads = lambda t, n: t.view(B, S, n, D).transpose(1, 2)
            return F.scaled_dot_product_attention(
                heads(q, H), heads(k, Hkv), heads(v, Hkv), attn_mask=allowed,
                enable_gqa=True).transpose(1, 2).reshape(B, S, H * D)

        _width_case(f"attention a+b head_dim={D} B={B} S={S} causal",
                    lambda *t: FA.fused_mask_attention(*t, *streams, DROP_SEED, H, "causal",
                                                       DROP_RATE),
                    lambda *t: FA.fused_mask_attention_plain(*t, *streams, DROP_SEED, H, "causal",
                                                             DROP_RATE),
                    [q, k, v], rnd(B, S, H * D),
                    (4.0 * D * pairs, 10.0 * D * pairs),
                    (io + 2 * q.numel() + 4 * B * H * S + 16 * B * S,
                     2 * io + 2 * q.numel() + 8 * B * H * S + 16 * B * S), card,
                    lib=("sdpa(bool mask, no dropout)", sdpa))


def _bits(t):
    """t's bit patterns as integers, so that == compares bit for bit."""
    import torch

    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def dropout_phase(dev, card: str) -> dict:
    """Phase 2d: the residual hash dropout's kernels against their plain
    versions on the same inputs, bit for bit: K1 with and without its
    residual and K2 at the flagship residual [64, 505, 256] bf16 (rates 0.2
    and 0.1, whose scale rounds in bf16), fp32 at the zoo's SASRec shape
    [256, 20, 128] (rate 0.5), an odd length at a 16-byte aligned and at
    an offset pointer (the scalar route), and rows from row0 > 0 against
    the global batch's plain mask. Times K1 (with residual) and K2 at the flagship
    shape, in a CUDA graph (a launch's host time exceeds the kernel's
    device time), beside their plain versions, bounds and host time a call;
    no single PyTorch call computes this hash (`F.dropout` draws Philox
    bits), so no library time."""
    import torch

    from gamer_tpu_torch.modules.dropout import hash_dropout_add, keep_threshold
    from gamer_tpu_torch.ops import hash_dropout as HD

    g = torch.Generator().manual_seed(4)
    rnd = lambda shape, dtype: torch.randn(*shape, generator=g).to(dev, dtype)

    def same(label, got, want):
        ok = got.dtype == want.dtype and got.shape == want.shape and bool(
            (_bits(got) == _bits(want)).all())
        err = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else -1
        print(f"check {label}: {'bit-identical' if ok else 'DIFFERS'} (max abs err {err:.3e})",
              flush=True)
        assert ok, f"{label}: the kernel differs from its plain version"
        return err

    def k1_k2(label, y, r, rate, seed=DROP_SEED):
        thr, kp = keep_threshold(rate)
        errs = [same(f"{label} K1+residual", HD.hash_dropout_fwd(y, seed, thr, kp, r),
                     HD.hash_dropout_add_plain(y, seed, thr, kp, r)),
                same(f"{label} K1", HD.hash_dropout_fwd(y, seed, thr, kp),
                     HD.hash_dropout_add_plain(y, seed, thr, kp)),
                same(f"{label} K2", HD.hash_dropout_bwd(y, seed, thr, kp),
                     HD.apply_mask(y, seed, thr, kp))]
        return max(errs)

    shape = (64, 505, 256)
    err = 0.0
    for rate in (DROP_RATE, 0.1):
        y, r = rnd(shape, torch.bfloat16), rnd(shape, torch.bfloat16)
        err = max(err, k1_k2(f"hash_dropout[{list(shape)},bf16,rate={rate}]", y, r, rate))
    zoo = (256, 20, 128)
    err = max(err, k1_k2(f"hash_dropout[{list(zoo)},fp32,rate=0.5]", rnd(zoo, torch.float32),
                         rnd(zoo, torch.float32), 0.5))
    n = 1_000_003  # not a multiple of 8
    for dtype in (torch.bfloat16, torch.float32):
        base_y, base_r = rnd((n + 1,), dtype), rnd((n + 1,), dtype)
        err = max(err, k1_k2(f"hash_dropout[n={n},{dtype},aligned]", base_y[:n], base_r[:n],
                             0.1))
        y, r = base_y[1:], base_r[1:]  # 2 or 4 bytes past a 16-byte boundary
        assert y.data_ptr() % 16 != 0
        err = max(err, k1_k2(f"hash_dropout[n={n},{dtype},offset pointer]", y, r, 0.1))
    # rows from row0 > 0: the global batch's mask
    B, row0 = 8, 3
    y, r = rnd((B, 505, 256), torch.bfloat16), rnd((B, 505, 256), torch.bfloat16)
    thr, kp = keep_threshold(DROP_RATE)
    want = HD.hash_dropout_add_plain(y, DROP_SEED, thr, kp, r)[row0:]
    err = max(err, same(f"hash_dropout[rows {row0}..{B} of {B},bf16] K1+residual",
                        hash_dropout_add(r[row0:], y[row0:], DROP_SEED, DROP_RATE, row0), want))

    # times at the flagship shape, bf16, rate 0.2; the calls cycle through 6
    # input sets (200 MB for K1), so that the inputs come from device memory
    # and not from the 50 MB L2, as in a step
    sets = [(rnd(shape, torch.bfloat16), rnd(shape, torch.bfloat16)) for _ in range(6)]
    turn = iter(range(1 << 30))
    pick = lambda: sets[next(turn) % len(sets)]
    y, r = sets[0]
    thr, kp = keep_threshold(DROP_RATE)
    numel = y.numel()
    entries = {}
    for name, n_in, kern, plain in (
            ("hash_dropout_fwd", 2,
             lambda: (lambda y, r: HD.hash_dropout_fwd(y, DROP_SEED, thr, kp, r))(*pick()),
             lambda: HD.hash_dropout_add_plain(y, DROP_SEED, thr, kp, r)),
            ("hash_dropout_bwd", 1, lambda: HD.hash_dropout_bwd(pick()[0], DROP_SEED, thr, kp),
             lambda: HD.apply_mask(y, DROP_SEED, thr, kp))):
        n_bytes = 2 * numel * (n_in + 1)  # each input read once, the output written once
        flops = numel * n_in  # the multiply, and the residual add
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        bound, by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
        ms = _graph_ms(kern)
        host_us, paced_ms = _host_us(kern), _cuda_ms(kern, iters=20)
        plain_ms = _cuda_ms(plain, iters=3)
        entries[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                             bound_by=by, max_abs_err=err)
        print(f"time {name} {list(shape)} bf16 rate {DROP_RATE}: kernel {ms:.4f} ms in a CUDA "
              f"graph ({n_bytes / ms / 1e6:.1f} GB/s, {100 * bound / ms:.1f}% of bound), "
              f"{paced_ms:.4f} ms a call launched from Python ({host_us:.1f} us host time a "
              f"call), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); library: none "
              f"(card {card})", flush=True)
    return entries


def grouped_moe_phase(dev, card: str) -> None:
    """Phase 2g (the module docstring): MoeAction's grouped h and i against
    one ungrouped launch per level, at the h20 cell's MoE shapes."""
    import torch

    from gamer_tpu_torch.ops import fused_moe as FM

    P, T, D, Fd, NB, rate = 5, 256 * 24, 256, 512, 3, 0.1
    E = P * NB + 1
    g = torch.Generator().manual_seed(23)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev, torch.bfloat16)
    xp, gout = rnd(P, T, D), rnd(P, T, D)
    wgu, wd = rnd(E, D, 2 * Fd, scale=D ** -0.5), rnd(E, Fd, D, scale=Fd ** -0.5)
    btab = rnd(E, NB + 1, 2 * Fd, scale=0.3)
    beh = torch.randint(0, NB + 1, (P, T), generator=g, dtype=torch.int32).to(dev)
    lv = torch.randint(1, NB + 1, (T,), generator=g)
    lv[torch.rand(T, generator=g) < 0.19] = 0
    lv = lv.to(dev)
    groups = FM.level_rows(lv, NB)
    args = (xp, wgu, wd, btab, beh)
    h = lambda: FM._launch_fwd(*args, DROP_SEED, rate, True, "silu", groups, 1)
    i = lambda: FM.fused_moe_ffn_bwd(*args, gout, DROP_SEED, rate, True, "silu", groups, 1)
    levels = [slice(P * (a - 1) + 1, P * a + 1) for a in range(1, NB + 1)]
    h_levels = lambda: [FM._launch_fwd(xp, wgu[w], wd[w], btab[w], beh, DROP_SEED, rate, True)
                        for w in levels]
    i_levels = lambda gs: [FM.fused_moe_ffn_bwd(xp, wgu[w], wd[w], btab[w], beh, gm, DROP_SEED,
                                                rate, True) for w, gm in zip(levels, gs)]
    masks = [(lv == a).to(torch.bfloat16)[None, :, None] for a in range(1, NB + 1)]
    out, dx = h(), i()[0]
    want_out = sum(y * m for y, m in zip(h_levels(), masks))
    want_dx = sum(d[0] for d in i_levels([gout * m for m in masks]))
    torch.cuda.synchronize()
    same = torch.equal(out, want_out) and torch.equal(dx, want_dx)
    real = int((lv > 0).sum())
    held, tiles = int(groups.level_tile[-1]), groups.tile_level.numel()
    flops_h, flops_i = (2 * real * P * (k * D * 2 * Fd + j * Fd * D) for k, j in ((1, 1), (3, 2)))
    weights = E * (D * 2 * Fd + Fd * D)
    bound_h, by_h = _bound_ms(2 * (real * P * 2 * D + weights), flops_h)
    bound_i, by_i = _bound_ms(2 * (real * P * 3 * D + 2 * weights), flops_i)
    ms_h, ms_i = _cuda_ms(h), _cuda_ms(i)
    ms_h3, ms_i3 = _cuda_ms(h_levels), _cuda_ms(lambda: i_levels([gout] * NB))
    ms_table = _graph_ms(lambda: FM.level_rows(lv, NB))
    print(f"phase 2g grouped h and i, P={P} T={T} ({real} rows of a level) D={D} F={Fd} "
          f"{NB} levels bf16 bias rate {rate}: output and dx "
          f"{'bit-identical' if same else 'DIFFER'} to {NB} launches a level with the masked "
          f"sum; row tiles holding rows {held} of {tiles}; h {ms_h:.4f} ms "
          f"({_rate(flops_h, ms_h, bound_h)}; bound {bound_h:.4f} ms by {by_h}) against "
          f"{ms_h3:.4f} ms per level; i {ms_i:.4f} ms ({_rate(flops_i, ms_i, bound_i)}; bound "
          f"{bound_i:.4f} ms by {by_i}) against {ms_i3:.4f} ms per level; the row table "
          f"{ms_table:.4f} ms (card {card})", flush=True)
    if not same:
        raise AssertionError("the grouped MoE launch differs from one launch per level")


def qk_norm_rope_phase(dev, card: str) -> dict:
    """Phase 2f: the attention prologue's q/k RMSNorm and RoPE, N1 and N2
    (`ops/qk_norm_rope.py`), against their plain version: N1 bit for bit
    (bf16 at the flagship's B 256 x S 520 tokens, 6 q and 3 k heads of 64,
    the train path's positions; fp32 and bf16 at head dims 48, 64, 128, 258
    (the wide kernels) and 320, B 8 x S 505, jumping positions); N2's four
    grads no further from the fp32 plain grads than autograd through the
    bf16 plain version is, and two N2 runs bit-identical, at B 8 x S 505
    (head dims 64 and 128), on the timed flagship inputs and at the
    MoeAction cell's B 256 x S 120 (whose warps walk several token groups).
    Times N1 and N2 at the flagship shapes in a CUDA graph (inputs cycled
    through two sets, 150 MB each, so they come from device memory) beside
    their bounds (each byte read or written once: q, k, their outputs or
    grads, the fp32 rstd and the int32 positions), and the plain chain's
    forward and its backward through autograd. Their launches on the main
    path are phase 5's."""
    import torch

    from gamer_tpu_torch.ops import qk_norm_rope as QN

    theta, eps = 1e6, 1e-6
    g = torch.Generator().manual_seed(6)

    def inputs(B, S, H, Hkv, D, dtype, jumps):
        q = (2 * torch.randn(B, S, H, D, generator=g) + 0.3).to(dev, dtype)
        k = torch.randn(B, S, Hkv, D, generator=g).to(dev, dtype)
        w = [(1 + 0.5 * torch.randn(D, generator=g)).to(dev) for _ in range(2)]
        pos = (torch.cumsum(torch.randint(0, 3, (B, S), generator=g), 1).to(torch.int32)
               if jumps else torch.arange(S, dtype=torch.int32)[None].expand(B, S)).to(dev)
        return q, k, *w, pos

    def cotangents(args):
        return [torch.randn(t.shape, generator=g).to(dev, torch.bfloat16) for t in args[:2]]

    def n1_same(label, args):
        got = QN.qk_norm_rope(*args, theta, eps)
        want = QN.qk_norm_rope_plain(*args, theta, eps, fixed_order=True)
        ok = all(a.dtype == b.dtype and bool((_bits(a) == _bits(b)).all())
                 for a, b in zip(got, want))
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        print(f"check qk_norm_rope_fwd {label}: {'bit-identical' if ok else 'DIFFERS'} "
              f"(max abs err {err:.3e})", flush=True)
        assert ok, f"N1 {label} differs from its plain version"
        return err

    def grads(args, cot, fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in args[:4]]
        torch.autograd.backward(fn(*leaves, args[4], theta, eps), cot)
        return [t.grad for t in leaves]

    def n2_close(label, args, cot):
        """N2's max abs err from the fp32 plain grads, checked as the
        docstring says."""
        up = lambda ts: [t.float() for t in ts]
        want = grads(up(args[:2]) + list(args[2:]), up(cot), QN.qk_norm_rope_plain)
        rel = lambda got: [((a.float() - b).abs().max() / b.abs().max()).item()
                           for a, b in zip(got, want)]
        kernel, again = grads(args, cot, QN.qk_norm_rope), grads(args, cot, QN.qk_norm_rope)
        same = all(bool((_bits(a) == _bits(b)).all()) for a, b in zip(kernel, again))
        k_err, p_err = rel(kernel), rel(grads(args, cot, QN.qk_norm_rope_plain))
        err = max((a.float() - b).abs().max().item() for a, b in zip(kernel, want))
        print(f"check qk_norm_rope_bwd {label} bf16: grads (q, k, wq, wk) from the fp32 plain "
              f"grads {['%.3e' % e for e in k_err]} of the largest (max abs err {err:.3e}), "
              f"bf16 plain path's {['%.3e' % e for e in p_err]}; two runs bit-identical: "
              f"{same}", flush=True)
        assert same and all(a <= b for a, b in zip(k_err, p_err)), f"N2 check {label} failed"
        del want, kernel, again
        return err

    flagship = (256, 520, 6, 3, 64)
    err = n1_same(f"{list(flagship)} bf16", inputs(*flagship, torch.bfloat16, False))
    for D in (48, 64, 128, 258, 320):
        for dtype in (torch.float32, torch.bfloat16):
            err = max(err, n1_same(f"[8, 505, 6, 3, {D}] {dtype}",
                                   inputs(8, 505, 6, 3, D, dtype, True)))
    n2_err = 0.0
    for D in (64, 128):
        args = inputs(8, 505, 6, 3, D, torch.bfloat16, True)
        n2_err = max(n2_err, n2_close(f"[8, 505, 6, 3, {D}]", args, cotangents(args)))
    args = inputs(256, 120, 6, 3, 64, torch.bfloat16, True)
    n2_err = max(n2_err, n2_close("[256, 120, 6, 3, 64]", args, cotangents(args)))
    del args

    # times at the flagship shapes, bf16
    sets = [inputs(*flagship, torch.bfloat16, False) for _ in range(2)]
    cots = [cotangents(s) for s in sets]
    n2_err = max(n2_err, n2_close(f"{list(flagship)} (the timed inputs)", sets[0], cots[0]))
    torch.cuda.empty_cache()
    prep = [(s[4].contiguous(), QN.rope_inv_freq(64, theta, dev)) for s in sets]
    saved = [QN.qk_norm_rope_fwd(*s[:4], *p, eps, True) for s, p in zip(sets, prep)]
    turn = iter(range(1 << 30))
    pick = lambda: next(turn) % 2
    B, S, H, Hkv, D = flagship
    tokens, heads = B * S, H + Hkv
    elems = tokens * heads * D
    n_bytes = {"qk_norm_rope_fwd": 2 * elems * 2 + 4 * tokens * heads + 4 * tokens,
               "qk_norm_rope_bwd": 3 * elems * 2 + 4 * tokens * heads + 4 * tokens}
    kern = {"qk_norm_rope_fwd": lambda: (lambda i: QN.qk_norm_rope_fwd(
                *sets[i][:4], *prep[i], eps, True))(pick()),
            "qk_norm_rope_bwd": lambda: (lambda i: QN.qk_norm_rope_bwd(
                *cots[i], *sets[i][:4], *saved[i][2:], *prep[i], eps))(pick())}
    leaves = [t.detach().clone().requires_grad_(True) for t in sets[0][:4]]
    outs = QN.qk_norm_rope_plain(*leaves, sets[0][4], theta, eps)
    plain = {"qk_norm_rope_fwd": lambda: QN.qk_norm_rope_plain(*sets[0], theta, eps),
             "qk_norm_rope_bwd": lambda: torch.autograd.grad(outs, leaves, cots[0],
                                                             retain_graph=True)}
    errs = {"qk_norm_rope_fwd": err, "qk_norm_rope_bwd": n2_err}
    entries = {}
    for name in ("qk_norm_rope_fwd", "qk_norm_rope_bwd"):
        bound = n_bytes[name] / HBM_BYTES_PER_S * 1e3
        ms = _graph_ms(kern[name])
        plain_ms = _cuda_ms(plain[name], iters=3)
        entries[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                             bound_by="bytes", max_abs_err=errs[name])
        print(f"time {name} [{B}, {S}] x {H}/{Hkv} heads of {D} bf16: kernel {ms:.4f} ms in a "
              f"CUDA graph ({n_bytes[name] / ms / 1e6:.1f} GB/s, {100 * bound / ms:.1f}% of "
              f"bound), plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes); library: none "
              f"(card {card})", flush=True)
    return entries


def optimizer_phase(dev, card: str) -> dict:
    """Phase 2e: kernel L (`ops/fused_optimizer.py`) against its plain
    version (`train/state.plain_update`) at the flagship's parameters (138
    fp32 tensors of Qwen3Multi), each family, max_grad_norm 1.0 with grads
    whose norm is about 5 on even updates (clipped) and 0.5 on odd ones:
    after 10 updates from the same start, every parameter and moment within
    1e-5 of its tensor's largest entry; L1's norm of the first grads within
    1e-5 relative of the plain norm; a second run of L bit-identical. Then
    L1 and L2 (adamw) timed with CUDA events beside their bounds (L1: 4
    bytes an element read, or an fp64 multiply-add an element; L2: p, g, m
    and v read and p, m and v written, 28 bytes an element), the plain
    version and the library calls: `clip_grad_norm_(foreach=True)` for L1
    (the norm and the scaling of the grads) and `torch.optim.AdamW(
    fused=True).step()` for L2 (no clip)."""
    import torch

    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.ops import fused_optimizer as FO
    from gamer_tpu_torch.train.state import Optimizer, OptimizerConfig, decay_mask, plain_update

    model = QwenFamilyModel(flagship_config(), device=dev, seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    decay = decay_mask(model)
    del model
    n_values = sum(p.numel() for p in start.values())
    gen = torch.Generator(device=dev)

    def grads(step):
        gen.manual_seed(step)
        scale = 1e-3 if step % 2 == 0 else 1e-4  # norm about 5 (clipped) or 0.5
        return {n: torch.randn(p.shape, generator=gen, device=dev) * scale
                for n, p in start.items()}

    def run(optim, kernel: bool):
        params = {n: p.clone() for n, p in start.items()}
        opt = Optimizer(OptimizerConfig(optim=optim, learning_rate=1e-3, warmup_steps=2,
                                        total_steps=10, max_grad_norm=1.0, weight_decay=0.01),
                        params, decay)
        norms = []
        for step in range(10):
            g = grads(step)
            opt.prepare()
            if kernel:
                opt.apply(g)
                norms.append(opt.last_table.totals.sum().sqrt())
            else:
                norms.append(torch.sqrt(sum(t.float().square().sum() for t in g.values())))
                plain_update(opt, g)
        state = {"p": params, **{k: v for k, v in opt.state_dict().items() if k != "count"}}
        return state, torch.stack([x.float() for x in norms]).cpu()

    err = 0.0
    for optim in ("adamw", "adam", "sgd", "adagrad", "rmsprop", "lion"):
        (got, got_norms), (again, _), (want, want_norms) = (
            run(optim, True), run(optim, True), run(optim, False))
        worst, worst_abs = 0.0, 0.0
        for slot, tensors in want.items():
            for n, w in tensors.items():
                d = (got[slot][n] - w).abs().max().item()
                worst = max(worst, d / max(w.abs().max().item(), 1e-30))
                worst_abs = max(worst_abs, d)
        identical = all(torch.equal(got[slot][n], again[slot][n])
                        for slot in got for n in got[slot])
        norm_rel = ((got_norms - want_norms).abs() / want_norms).max().item()
        clipped = int((want_norms >= 1.0).sum())
        print(f"check fused_optimizer {optim} [{len(start)} tensors, {n_values} values, 10 "
              f"updates, {clipped} clipped]: worst parameter/moment err {worst:.3e} of its "
              f"tensor's largest (tol 1e-5), norm rel err {norm_rel:.3e} (tol 1e-5), two runs "
              f"{'bit-identical' if identical else 'DIFFER'}", flush=True)
        assert 0 < clipped < 10, f"the clip was {'never' if not clipped else 'always'} triggered"
        assert worst <= 1e-5 and norm_rel <= 1e-5, f"kernel L ({optim}) differs from plain"
        assert identical, f"two runs of kernel L ({optim}) differ"
        err = max(err, worst_abs)

    # times: adamw at the flagship's parameters
    params = {n: p.clone() for n, p in start.items()}
    opt = Optimizer(OptimizerConfig(max_grad_norm=1.0), params, decay)
    g = grads(0)
    opt.prepare()
    opt.apply(g)
    table = opt.last_table
    b1, b2, eps = opt.betas
    l1_ms = _cuda_ms(lambda: FO.global_norm_sq(table), iters=20)
    l2_ms = _cuda_ms(lambda: FO.apply_update(table, opt.scalars, "adamw", b1, b2, eps, 0.01, 1.0),
                     iters=20)
    norm_plain_ms = _cuda_ms(lambda: torch.sqrt(sum(t.float().square().sum()
                                                    for t in g.values())), iters=5)
    plain_ms = _cuda_ms(lambda: plain_update(opt, g), iters=5)
    leaves = [torch.nn.Parameter(p.clone()) for p in start.values()]
    for leaf, t in zip(leaves, g.values()):
        leaf.grad = t.clone()
    clip_ms = _cuda_ms(lambda: torch.nn.utils.clip_grad_norm_(leaves, 1.0, foreach=True), iters=20)
    adamw = torch.optim.AdamW(leaves, lr=1e-3, weight_decay=0.01, fused=True)
    adamw_ms = _cuda_ms(adamw.step, iters=20)
    entries = {}
    for name, ms, plain, lib, lib_name, n_bytes, flops, peak in (
            ("global_norm_sq", l1_ms, norm_plain_ms, clip_ms, "clip_grad_norm_(foreach=True)",
             4 * n_values, 2 * n_values, F64_FLOPS),
            ("apply_update", l2_ms, plain_ms, adamw_ms, "AdamW(fused=True).step()",
             28 * n_values, 16 * n_values, F32_FLOPS)):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
        bound, by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
        entries[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                             max_abs_err=err)
        print(f"time {name} adamw [{len(start)} tensors, {n_values} fp32 values]: kernel "
              f"{ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s, {100 * bound / ms:.1f}% of bound), "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}); library {lib_name} "
              f"{lib:.4f} ms (card {card})", flush=True)
    del opt, params, leaves, adamw
    return entries


def _dropout_sites(cfg) -> list:
    """Hash-dropout applications of each layer in one training forward (K1
    launches; K2 the same in the backward): the residual sites (2, with a
    cross-attention 3) and a dense layer's MLP activation (a sparse layer's
    is inside kernel h); none when the rate is 0 or 1."""
    if not 0.0 < cfg.dropout_rate < 1.0:
        return [0] * cfg.num_hidden_layers
    return [(3 if i in cfg.cross_attention_layers else 2) + (i not in cfg.sparse_layers)
            for i in range(cfg.num_hidden_layers)]


UPDATE_LAUNCHES = {"global_norm_sq": 1, "apply_update": 1}  # kernel L of one optimizer update


def _step_launches(cfg) -> dict:
    """Wrapper calls of one training forward and backward: an attention
    forward and backward, and an N1 and N2 (the q/k norm and RoPE), per
    self- and cross-attention, an MoE forward and backward per sparse layer
    (MoeAction too: one grouped launch over the behavior levels), one CE
    forward and backward, and K1 and K2 at each hash-dropout site
    (`_dropout_sites`)."""
    attn = cfg.num_hidden_layers + len(cfg.cross_attention_layers)
    moe = len(cfg.sparse_layers)
    drop = sum(_dropout_sites(cfg))
    return {"fused_mask_attention": attn, "fused_mask_attention_bwd": attn,
            "fused_moe_ffn": moe, "fused_moe_ffn_bwd": moe,
            "fused_ce_rows": 1, "fused_ce_rows_bwd": 1,
            "hash_dropout_fwd": drop, "hash_dropout_bwd": drop,
            "qk_norm_rope_fwd": attn, "qk_norm_rope_bwd": attn}


def _train_step_launches(cfg) -> dict:
    """Wrapper calls of one `Trainer` step with an optimizer update: the
    forward and backward's (`_step_launches`) and kernel L's L1 and L2."""
    return {**_step_launches(cfg), **UPDATE_LAUNCHES}


def _step_grads(model, loss_fn, batch, seed: int):
    """Loss and {name: grad} of one training forward and backward."""
    import torch

    model.zero_grad(set_to_none=True)
    loss, aux = loss_fn(batch, torch.Generator().manual_seed(seed))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def tables_reproduce(label: str, first: dict, second: dict, tables) -> None:
    """The grads of the embedding `tables` of two training passes on one
    batch with the same seeds are equal bit for bit (`modules/layers.lookup`)."""
    differ = [n for n in tables if not np.array_equal(np.asarray(first[n]), np.asarray(second[n]))]
    print(f"{label}: one step's grads twice, {len(tables) - len(differ)} of {len(tables)} "
          f"embedding tables bit-identical{': differ ' + ', '.join(differ) if differ else ''}",
          flush=True)
    assert not differ, f"{label}: two passes of one step differ in {differ}"


def _paths_agree(label: str, cfg, batch, dev, seed: int, counters: dict,
                 expected: dict, plain_remat: bool = False, loss_tol: float = STEP_LOSS_TOL,
                 grad_tol: float = STEP_GRAD_TOL) -> tuple[float, float, str]:
    """One training step through the kernels (launch counts reset just
    before and checked just after) and through the plain path, on the same
    weights and dropout seeds: loss within `loss_tol` relative, every grad
    within `grad_tol` (max |d| / max |plain|); fp32 at STEP_LOSS_TOL and
    STEP_GRAD_TOL, bf16 at BF16_STEP_LOSS_TOL and BF16_STEP_GRAD_TOL.
    Returns (loss rel diff, worst grad rel err, its parameter)."""
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    model = QwenFamilyModel(cfg, device=dev, seed=seed)
    for w in counters.values():
        w.launches = 0
    loss, grads = _step_grads(model, make_loss_fn(model, cfg, deterministic=False), batch, seed)
    # a forward and backward: the counters of `expected` (no optimizer update)
    launches = {name: counters[name].launches for name in expected}
    print(f"{label} launches: {launches}", flush=True)
    assert launches == expected, f"kernel launches {launches}, expected {expected}"
    del model
    plain_cfg = cfg.replace(attention_impl="jnp", moe_impl="jnp", ce_impl="jnp",
                            remat=plain_remat)
    plain = QwenFamilyModel(plain_cfg, device=dev, seed=seed)
    plain_loss, plain_grads = _step_grads(
        plain, make_loss_fn(plain, plain_cfg, deterministic=False), batch, seed)
    rel = abs(loss - plain_loss) / abs(plain_loss)
    # a grad that only one path produced is off by all of it
    worst = max(((_rel_err(grads[n], plain_grads[n])[1]
                  if grads[n] is not None and plain_grads[n] is not None
                  else float(grads[n] is not plain_grads[n])), n) for n in grads)
    print(f"{label}: loss {loss:.7f} (kernels) vs {plain_loss:.7f} (plain), rel diff "
          f"{rel:.3e} (tol {loss_tol}); worst grad rel err {worst[0]:.3e} ({worst[1]}, "
          f"tol {grad_tol})", flush=True)
    assert np.isfinite(loss) and rel <= loss_tol, f"{label}: losses disagree"
    assert worst[0] <= grad_tol, f"{label}: grads disagree"
    return rel, worst[0], worst[1]


def _task_paths_agree(label: str, out: str, dev, counters: dict, train, valid, vocab,
                      pad_multiple: int, batch: int) -> None:
    """`_paths_agree` on a task's own geometry: the config the task saved in
    `out` (fresh weights from a seed) and the first shuffled training batch
    of its examples as the task collates it, in the config's dtype and in
    fp32, each at its dtype's step tolerances."""
    from gamer_tpu_torch import native
    from gamer_tpu_torch.data.batching import DecoderBatcher
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig

    cfg = QwenFamilyConfig.from_file(out)
    seq_len = DecoderBatcher.for_examples(train + valid, pad_multiple=pad_multiple).seq_len
    first = next(iter(native.ExampleStore(train, vocab.behavior_token_ids).iterate(
        batch, seq_len, shuffle=True, seed=0)))
    expected = _step_launches(cfg) if dev.type == "cuda" else {k: 0 for k in counters}
    tols = {cfg.dtype: (BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL),
            "float32": (STEP_LOSS_TOL, STEP_GRAD_TOL)}
    for dtype, (loss_tol, grad_tol) in tols.items():
        _paths_agree(f"{label} step {dtype} B={batch} S={seq_len}", cfg.replace(dtype=dtype),
                     first, dev, 5, counters, expected, loss_tol=loss_tol, grad_tol=grad_tol)


def _port_kernel_names() -> list:
    """The `__global__` kernels of the port's CUDA sources, by name."""
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gamer_tpu_torch", "ops",
                        "csrc")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as src:
                names |= set(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                    src.read()))
    return sorted(names, key=len, reverse=True)  # the longest first: a name may contain another


PRIMERS = 64  # `_profiled_step`'s spin kernels ahead of each profiled call


def _profiled_step(step, tries: int = 2) -> dict:
    """One call of `step` under torch.profiler (CPU and CUDA activities):
    the device kernels' summed time (ms), their count, the kernels of the
    port's sources by name and count (inside a replayed CUDA graph as well:
    CUPTI reports a graph's kernels), and every kernel by name and count
    (copies and fills from the host, which a graph does not hold, left out).
    The profiler can drop records of a window, never add them (phase 13's
    SASRec step showed 17 or 18 of its 18 K1/K2 launches from one run of
    the script to the next, in either form), so each window opens on
    `PRIMERS` spin kernels (`torch.cuda._sleep`, left out) and a
    synchronize, and the most complete of `tries` profiled calls counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = lambda e: (getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))
    names, best = _port_kernel_names(), None
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PRIMERS):
                torch.cuda._sleep(20000)
            torch.cuda.synchronize()
            time.sleep(0.02)
            step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and dev(e) > 0 and "spin_kernel" not in e.key]
        ours = {}
        for e in kernels:
            name = next((n for n in names if re.search(rf"\b{n}\b", e.key)), None)
            if name is not None:
                ours[name] = ours.get(name, 0) + e.count
        got = dict(device_ms=sum(dev(e) for e in kernels) / 1e3,
                   launches=sum(e.count for e in kernels), ours=ours,
                   kernels={e.key: e.count for e in kernels
                            if not e.key.startswith(("Memcpy", "Memset"))})
        if best is None or got["launches"] > best["launches"]:
            best = got
    return best


def _scoring_launches(cfg, cuda: bool, names) -> dict:
    """Wrapper calls of one scoring forward, for each counter of `names`: an
    attention forward and an N1 per self- and cross-attention, an MoE
    forward per sparse layer (MoeAction too: one grouped launch), one CE
    forward; none on the CPU."""
    launches = {k: 0 for k in names}
    if cuda:
        attn = cfg.num_hidden_layers + len(cfg.cross_attention_layers)
        launches.update(fused_mask_attention=attn, qk_norm_rope_fwd=attn,
                        fused_moe_ffn=len(cfg.sparse_layers), fused_ce_rows=1)
    return launches


def eval_phase(dev, counters: dict, card: str, cfg=None, geometry=(64, 101),
               calls: int = 6) -> dict:
    """Phase 3: the scoring forward of flagship Qwen3Multi in bf16 (B 64 x
    101 blocks, dropout off, random weights from seed 0) through
    `Trainer.evaluate`, compiled (its eval step, `train/loop.EvalStep`,
    captured as a CUDA graph and replayed: the default) and eager
    (`graphed=False`), `calls` evaluations of one batch each, from the same
    weights. Gates: every result bit-identical between the two; each run of
    the eval step's device part (eager, or the capture) launching exactly
    a 12, N1 12, h 8, j 1 and nothing else, with the counts zeroed just before each
    mode's run and read just after; the compiled eval one graph, replayed
    by every call after the first; a profiled replay running the eager
    eval's kernels of the port by name and count. Prints each mode's median
    host time of calls 2 on, busy share and peak memory. Then the plain path
    on the same weights: losses within LOSS_TOL relative. `cfg`, `geometry`
    and `calls` let a test run it tiny."""
    import torch

    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = cfg or flagship_config()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    batch = make_batch(cfg, *geometry)
    expected = _scoring_launches(cfg, cuda, counters)
    runs = {}
    for graphed in (True, False):
        label = "compiled" if graphed else "eager"
        model, eval_loss = run_forward(cfg, dev)
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model, OptimizerConfig(),
                          TrainLoopConfig(), eval_loss_fn=eval_loss, graphed=graphed)
        if cuda:
            sync()
            torch.cuda.reset_peak_memory_stats()
        for w in counters.values():
            w.launches = 0
        losses, times = [], []
        with _recording(counters) as rec, _captures() as cap:
            for _ in range(calls):
                t = time.perf_counter()
                losses.append(trainer.evaluate([batch]))  # ends in a host read of the sums
                times.append(time.perf_counter() - t)
        totals = {k: w.launches for k, w in counters.items()}
        captured = graphed and cuda
        want_calls = [(False, expected), (True, expected)] if captured else [(False, expected)] * calls
        assert rec["eval_calls"] == want_calls, f"phase 3 {label}: {rec['eval_calls']}"
        assert totals == {k: sum(d[k] for _, d in rec["eval_calls"]) for k in totals}, (
            f"phase 3 {label}: launches outside the eval step: {totals}")
        assert trainer.eval_step().graphs == int(captured) and cap == (
            {"eval step": 1} if captured else {}), (trainer.eval_step().graphs, cap)
        assert np.isfinite(losses).all(), f"non-finite scoring loss {losses}"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        prof = _profiled_step(lambda: trainer.evaluate([batch])) if cuda else None
        runs[label] = dict(losses=losses, ms=float(np.median(times[1:])) * 1e3,
                           first_ms=times[0] * 1e3, peak=peak, prof=prof)
        busy = (f"a profiled call: {prof['device_ms']:.3f} ms of device kernels, "
                f"{100 * prof['device_ms'] / runs[label]['ms']:.1f}% busy, {prof['launches']} "
                f"kernels, the port's {prof['ours']}; " if prof else "")
        print(f"phase 3 scoring forward Qwen3Multi {cfg.dtype} B={geometry[0]} "
              f"S={geometry[1] * cfg.num_positions} through Trainer.evaluate, {label}: "
              f"{runs[label]['ms']:.3f} ms a batch (median of calls 2-{calls}, host time to the "
              f"read of the sums; the first {times[0] * 1e3:.1f} ms); launches of each run of "
              f"the eval step {[d for _, d in rec['eval_calls']][:1]}, captured "
              f"{[c for c, _ in rec['eval_calls']]}, graphs {cap}; {busy}peak memory "
              f"{peak / 2 ** 30:.3f} GiB (card {card})", flush=True)
        del trainer, model, eval_loss
        if cuda:
            torch.cuda.empty_cache()
    compiled, eager = runs["compiled"], runs["eager"]
    same = sum(a == b for a, b in zip(compiled["losses"], eager["losses"]))
    print(f"phase 3 compiled vs eager: {same} of {calls} eval losses bit-identical "
          f"({compiled['losses'][0]!r})", flush=True)
    assert compiled["losses"] == eager["losses"], "the compiled eval differs from eager"
    if cuda:
        assert compiled["prof"]["ours"] == eager["prof"]["ours"] and compiled["prof"]["ours"], (
            "a replay does not run the eager eval's kernels")

    plain_cfg = cfg.replace(attention_impl="jnp", moe_impl="jnp", ce_impl="jnp")
    _, plain_loss_fn = run_forward(plain_cfg, dev)
    plain_loss, plain_aux = plain_loss_fn(batch)
    sync()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        plain_loss_fn(batch)
        sync()
        times.append(time.perf_counter() - t)
    plain_ms = float(np.median(times)) * 1e3
    loss, plain_loss = compiled["losses"][0], float(plain_loss)
    rel = abs(loss - plain_loss) / abs(plain_loss)
    print(f"phase 3 scoring loss {loss:.6f} (kernels, compiled) vs {plain_loss:.6f} (plain), rel "
          f"diff {rel:.3e} (tol {LOSS_TOL}); denom {int(plain_aux['denom'])}; plain forward "
          f"{plain_ms:.3f} ms (median host time, card {card})", flush=True)
    assert np.isfinite(plain_loss) and rel <= LOSS_TOL, "kernel and plain scoring losses disagree"
    return dict(ms=compiled["ms"], eager_ms=eager["ms"], launches=expected)


def search_phase(dev, counters: dict, card: str, cfg=None,
                 geometry=(BEAM_BATCH, NUM_BEAMS, N_ITEMS, LEVELS, LEVEL_SIZE, PROMPT_BLOCKS),
                 timed: int = 3) -> dict:
    """Phase 4: the trie-constrained beam search of flagship Qwen3Multi in
    bf16 at serving geometry (batch 128, 20 beams, 4 code levels of 256,
    4096 items, left-padded prompts of up to 100 blocks) through
    `make_beam_search_fn`'s objects, compiled (one CUDA graph a key: the
    default) and eager (`graphed=False`), on the same weights: per-example
    behavior ids, a scalar id (the per-example key's graph) and `None` (the
    behavior-token decode over the behavior + item trie: a second object and
    key). Gates: codes equal and scores bit-identical between the two in
    every mode; of the kernels of `kernel_counters` only N1 launched (the
    search runs none of the others, as in JAX), once an attention block in
    the prefill and in each of the L - 1 decode steps of every run of a
    search's device part: each eager call, the warm-up and the capture of
    each compiled key; two graphs captured by the compiled searches, none by
    the eager; a profiled replay running the same kernels by name and count
    as a profiled eager search; shapes, finite sorted scores, every code
    path in the trie. Prints each mode's median host time of `timed` calls
    after the first, beams/s, the busy share, and the peak memory and the
    memory the graphs keep reserved. `cfg` and `geometry` let a test run it
    tiny."""
    import torch

    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel

    cfg = cfg or flagship_config()
    B, K, n_items, levels, size, blocks = geometry
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trie, pbatch, beh_ids = make_trie_and_prompts(cfg, B, n_items, levels, size, blocks)
    btrie, bbatch, _ = make_trie_and_prompts(cfg, B, n_items, levels, size, blocks,
                                             behavior_level=True)
    model = QwenFamilyModel(cfg, device=dev, seed=0)
    attn_blocks = cfg.num_hidden_layers + len(cfg.cross_attention_layers)
    modes = {"per-example": ("item", pbatch, beh_ids), "scalar": ("item", pbatch, 2),
             "None": ("behavior", bbatch, None)}
    runs = {}
    for graphed in (True, False):
        label = "compiled" if graphed else "eager"
        searches = {name: make_beam_search_fn(model, t, BeamSearchConfig(num_beams=K),
                                              graphed=graphed)
                    for name, t in (("item", trie), ("behavior", btrie))}
        if cuda:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reserved0 = torch.cuda.memory_reserved()
        for w in counters.values():
            w.launches = 0
        out, ms, first = {}, {}, {}
        with _captures() as cap:
            for mode, (name, batch, beh) in modes.items():
                times = []
                for _ in range(timed + 1):
                    t = time.perf_counter()
                    codes, scores = searches[name](batch, beh)
                    sync()
                    times.append(time.perf_counter() - t)
                out[mode] = (codes.cpu(), scores.float().cpu())
                ms[mode], first[mode] = float(np.median(times[1:])) * 1e3, times[0] * 1e3
                check_beams(btrie if name == "behavior" else trie, codes, scores, B, K)
        launches = {k: w.launches for k, w in counters.items()}
        captured = graphed and cuda
        want = {k: 0 for k in counters}
        if cuda:  # device-part runs a mode: scalar ids share the per-example key's graph
            part_runs = ({"per-example": 2, "scalar": 0, "None": 2} if captured
                         else {mode: timed + 1 for mode in modes})
            levels_of = {mode: (btrie if name == "behavior" else trie).num_levels
                         for mode, (name, _, _) in modes.items()}
            want["qk_norm_rope_fwd"] = attn_blocks * sum(n * levels_of[m]
                                                         for m, n in part_runs.items())
        assert launches == want, f"phase 4 {label}: the search launched {launches}, not {want}"
        graphs = sum(s.graphs for s in searches.values())
        assert graphs == 2 * captured and cap == ({"beam search": 2} if captured else {}), (
            graphs, cap)
        peak = reserved = 0
        if cuda:
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved() - reserved0
        prof = (_profiled_step(lambda: searches["item"](pbatch, beh_ids)) if cuda else None)
        runs[label] = dict(out=out, ms=ms, prof=prof)
        for mode in modes:
            busy = (f", a profiled call {prof['device_ms']:.3f} ms of device kernels, "
                    f"{100 * prof['device_ms'] / ms[mode]:.1f}% busy, {prof['launches']} kernels"
                    if prof and mode == "per-example" else "")
            print(f"phase 4 beam search {label} B={B} beams={K} "
                  f"L={levels + (modes[mode][0] == 'behavior')} items={n_items} prompt "
                  f"S={pbatch['input_ids'].shape[1]} behavior "
                  f"{mode}: {ms[mode]:.3f} ms a search (median host time of {timed} after the "
                  f"first, which took {first[mode]:.1f} ms), {B * K / (ms[mode] / 1e3):.1f} "
                  f"beams/s{busy} (card {card})", flush=True)
        print(f"phase 4 {label}: graphs captured {cap}; peak memory {peak / 2 ** 30:.3f} GiB, "
              f"kept reserved by the search objects {reserved / 2 ** 30:.3f} GiB; kernel "
              f"launches {launches}", flush=True)
        del searches
    compiled, eager = runs["compiled"], runs["eager"]
    for mode in modes:
        (c, s), (c2, s2) = compiled["out"][mode], eager["out"][mode]
        print(f"phase 4 compiled vs eager, behavior {mode}: codes equal {torch.equal(c, c2)}, "
              f"scores bit-identical {torch.equal(s, s2)}", flush=True)
        assert torch.equal(c, c2) and torch.equal(s, s2), f"phase 4 {mode}: compiled != eager"
    if cuda:
        ck, ek = compiled["prof"]["kernels"], eager["prof"]["kernels"]
        same = ck == ek
        differ = {k: (ck.get(k, 0), ek.get(k, 0)) for k in set(ck) | set(ek)
                  if ck.get(k, 0) != ek.get(k, 0)}
        print(f"phase 4 a profiled replay runs the eager search's {len(ek)} kernels by name "
              f"and count: {same}{'' if same else f' (replay, eager: {differ})'}", flush=True)
        assert same and compiled["prof"]["kernels"], "a replay does not run the eager kernels"
    del model
    if cuda:
        torch.cuda.empty_cache()
    return dict(ms=compiled["ms"]["per-example"], eager_ms=eager["ms"]["per-example"])


def train_phase(dev, counters: dict, card: str) -> dict:
    """Phase 5: 10 `Trainer` steps of flagship Qwen3Multi in bf16 with
    dropout, compiled (captured as a CUDA graph and replayed) and eager
    (`graphed=False`) from the same weights and seeds: losses and parameters
    bit-identical, the launches of the capture and of every eager step
    `_step_launches`, a profiled replay running the eager step's kernels of
    the port; then one fp32 step of the kernel path against the plain path.
    The counts are zeroed just before the compiled run, the main path, and
    read just after it."""
    import torch

    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    cfg = flagship_config(dropout_rate=DROP_RATE)
    expected = _train_step_launches(cfg)
    batch = make_batch(cfg, 64, 101)
    runs = {}
    for graphed in (True, False):
        label = "compiled" if graphed else "eager"
        model = QwenFamilyModel(cfg, device=dev, seed=0)
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                          OptimizerConfig(learning_rate=5e-4, lr_scheduler_type="constant",
                                          total_steps=10),
                          TrainLoopConfig(seed=0), graphed=graphed)
        assert all(p.dtype == torch.float32 for p in model.parameters()), (
            "parameters must stay fp32")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in counters.values():
            w.launches = 0
        losses, times = [], []
        with _recording(counters) as rec:
            for _ in range(10):
                t = time.perf_counter()
                losses.append(trainer.train_step(batch))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        totals = {name: w.launches for name, w in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        replayed, captured = check_step_launches(f"phase 5 {label}", rec, expected)
        assert (replayed, captured, trainer.graphs) == ((9, 1, 1) if graphed else (0, 0, 0)), (
            replayed, captured, trainer.graphs)
        assert all(totals[k] == n * (2 if graphed else 10) for k, n in expected.items()), totals
        assert all(totals[k] > 0 for k in totals), f"a kernel of the path never launched: {totals}"
        step_ms = float(np.median(times[1:])) * 1e3
        losses = [float(x) for x in losses]
        assert np.isfinite(losses).all(), "non-finite training loss"
        assert np.mean(losses[-3:]) < losses[0], "the training loss did not fall"
        assert trainer.updates == 10
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        prof = _profiled_step(lambda: trainer.train_step(batch))
        runs[label] = dict(losses=losses, params=params, step_ms=step_ms, first_ms=times[0] * 1e3,
                           peak=peak, prof=prof, reserved=torch.cuda.memory_reserved())
        print(f"train Qwen3Multi bf16 B=64 S=505 dropout {DROP_RATE}, {label} step: losses "
              f"{[round(x, 5) for x in losses]}; {step_ms:.3f} ms/step (median of steps 2-10, "
              f"host time; the first {times[0] * 1e3:.1f} ms), {64 / (step_ms / 1e3):.1f} "
              f"sequences/s; a profiled step: {prof['device_ms']:.3f} ms of device kernels, "
              f"{100 * prof['device_ms'] / step_ms:.1f}% busy, {prof['launches']} kernels; "
              f"peak memory {peak / 2 ** 30:.3f} GiB, reserved "
              f"{runs[label]['reserved'] / 2 ** 30:.3f} GiB (card {card})", flush=True)
        del trainer, model
        torch.cuda.empty_cache()
    compiled, eager = runs["compiled"], runs["eager"]
    same_params = [n for n, p in compiled["params"].items() if torch.equal(p, eager["params"][n])]
    print(f"train step launches (at the capture; each eager step): {expected}; compiled vs "
          f"eager: {sum(a == b for a, b in zip(compiled['losses'], eager['losses']))} of 10 "
          f"losses and {len(same_params)} of {len(compiled['params'])} parameters "
          f"bit-identical; the port's kernels in a profiled replay {compiled['prof']['ours']}, in "
          f"a profiled eager step {eager['prof']['ours']}", flush=True)
    assert compiled["losses"] == eager["losses"], "the compiled step's losses differ from eager"
    assert len(same_params) == len(compiled["params"]), "the compiled step's parameters differ"
    assert compiled["prof"]["ours"] == eager["prof"]["ours"] and compiled["prof"]["ours"], (
        "a replay does not run the eager step's kernels")

    cfg32 = flagship_config(dtype="float32", dropout_rate=DROP_RATE)
    _paths_agree("train step fp32 B=16 S=505", cfg32, make_batch(cfg32, 16, 101, seed=1), dev, 1,
                 counters, _step_launches(cfg32))
    return dict(launches=expected, step_ms=compiled["step_ms"])


def long_phase(dev, counters: dict) -> dict:
    """Phase 6: one fp32 training step at S 2050 and at S 5000 (the lengths
    of the TPU's streaming and XL attention kernels c-g), kernel path against
    the plain path (which recomputes each layer to fit)."""
    cfg = flagship_config(dtype="float32", dropout_rate=DROP_RATE, model_max_length=8192)
    expected = _step_launches(cfg)
    launches = {}
    for B, blocks in ((4, 410), (1, 1000)):
        S = blocks * cfg.num_positions
        _paths_agree(f"long-history step fp32 B={B} S={S}", cfg,
                     make_batch(cfg, B, blocks, seed=2), dev, 2, counters, expected,
                     plain_remat=True)
        launches[S] = {k: counters[k].launches for k in ("fused_mask_attention",
                                                          "fused_mask_attention_bwd")}
    return launches


@contextlib.contextmanager
def _recording(counters: dict):
    """While the block runs, record each `Trainer.train_step`'s launches
    (the counts' change over the step), its start time, its loss and its
    batch's S; in "calls", a list a step of (captured, launches) for each
    run of the step's device part (`Trainer._device_step`): an eager run,
    or the capture of its CUDA graph (a replayed step has none: its kernels
    are launched by the graph, not by the wrappers); each
    `Trainer.evaluate`'s launches; and in "eval_calls" (captured, launches)
    for each run of the eval step's device part (`EvalStep.device_part`)."""
    import torch

    from gamer_tpu_torch.train import loop as TL

    rec = {"steps": [], "calls": [], "stamps": [], "evals": [], "eval_calls": [], "S": None,
           "losses": []}
    step0, device0, eval0 = TL.Trainer.train_step, TL.Trainer._device_step, TL.Trainer.evaluate
    eval_device0 = TL.EvalStep.device_part
    snapshot = lambda: {k: w.launches for k, w in counters.items()}

    def train_step(self, batch):
        before = snapshot()
        rec["stamps"].append(time.perf_counter())
        rec["S"] = int(np.shape(batch["input_ids"])[1])
        rec["calls"].append([])
        loss = step0(self, batch)
        rec["steps"].append({k: v - before[k] for k, v in snapshot().items()})
        rec["losses"].append(loss)  # a tensor: read after the run, so no step waits
        return loss

    def device_step(self, *args, **kwargs):
        before = snapshot()
        out = device0(self, *args, **kwargs)
        captured = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        rec["calls"][-1].append((captured, {k: v - before[k] for k, v in snapshot().items()}))
        return out

    def evaluate(self, batches):
        before = snapshot()
        loss = eval0(self, batches)
        rec["evals"].append({k: v - before[k] for k, v in snapshot().items()})
        return loss

    def eval_device(self, static):
        before = snapshot()
        eval_device0(self, static)
        captured = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        rec["eval_calls"].append((captured, {k: v - before[k] for k, v in snapshot().items()}))

    TL.Trainer.train_step, TL.Trainer.evaluate = train_step, evaluate
    TL.Trainer._device_step, TL.EvalStep.device_part = device_step, eval_device
    try:
        yield rec
    finally:
        TL.Trainer.train_step, TL.Trainer.evaluate = step0, eval0
        TL.Trainer._device_step, TL.EvalStep.device_part = device0, eval_device0


@contextlib.contextmanager
def _captures():
    """While the block runs, count the CUDA graphs captured, by cache name
    (the counters `graph.capture.<name>` of `core/trace.py`): "training
    step", "eval step", "beam search", "enc-dec beam search"."""
    from gamer_tpu_torch.core import trace

    before, got = trace.counters("graph.capture."), {}
    try:
        yield got
    finally:
        got.update({k: n - before.get(k, 0) for k, n in trace.counters("graph.capture.").items()
                    if n > before.get(k, 0)})


def check_step_launches(label: str, rec: dict, expected: dict) -> tuple[int, int]:
    """The launches of `rec`'s steps (`_recording`): every run of a step's
    device part, eager or captured, launched exactly `expected`, nothing
    was launched outside it, and a step either ran it (eagerly; on the
    first step of a CUDA graph's key, then once more to capture it) or
    replayed its graph with no launch from Python. Returns (steps
    replayed, graphs captured)."""
    for st, calls in zip(rec["steps"], rec["calls"]):
        assert len(calls) <= 2 and all(d == expected for _, d in calls), (
            f"{label}: device-step launches {calls} != {expected}")
        assert st == {k: sum(d[k] for _, d in calls) for k in st}, (
            f"{label}: launches outside the device step: {st}, {calls}")
        assert [c for c, _ in calls] in ([], [False], [False, True]), f"{label}: {calls}"
    return (sum(not calls for calls in rec["calls"]),
            sum(c for calls in rec["calls"] for c, _ in calls))


def _check_fit_evals(label: str, rec: dict, cap: dict, expected: dict, dev) -> None:
    """A fit's graphs (`_captures`) and evals (`_recording`): on the card the
    training step's graphs and one or two of the eval step (a short last
    valid batch is a second key), each run of the eval step's device part,
    eager or captured, launching `expected` (one scoring forward's kernels,
    `_scoring_launches`); on the CPU no graph."""
    assert rec["evals"] and all(d == expected for _, d in rec["eval_calls"]), (
        f"{label}: eval launches {rec['eval_calls']} != {expected}")
    if dev.type == "cuda":
        train_graphs = sum(c for calls in rec["calls"] for c, _ in calls)
        assert cap.get("training step") == train_graphs and cap.get("eval step") in (1, 2), (
            f"{label}: graphs {cap}")
        assert sum(c for c, _ in rec["eval_calls"]) == cap["eval step"], (label, cap)
    else:
        assert cap == {}, f"{label}: graphs captured on the CPU {cap}"


def _check_search_graphs(label: str, cap: dict, dev, n: int,
                         name: str = "beam search") -> None:
    """An eval's searches captured `n` CUDA graphs (`_captures`) on the card
    (one a search object: the tasks pad their last chunk), none on the CPU."""
    want = {name: n} if dev.type == "cuda" else {}
    assert cap == want, f"{label}: graphs captured {cap}, expected {want}"


def _reload_check(label: str, out: str, dev, train, valid, vocab, pad_multiple: int,
                  batch: int, best: float) -> None:
    """The model reloaded from `out`'s "best" gives the in-memory best eval
    loss `best` on `valid` within 1e-6 relative, batched as in training."""
    from gamer_tpu_torch import native
    from gamer_tpu_torch.data.batching import DecoderBatcher
    from gamer_tpu_torch.tasks.test_decoder import load_generative_model
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train import loop as TL
    from gamer_tpu_torch.train.state import OptimizerConfig

    model, cfg, _, _ = load_generative_model(out, "best", dev)
    seq_len = DecoderBatcher.for_examples(train + valid, pad_multiple=pad_multiple).seq_len
    store = native.ExampleStore(valid, vocab.behavior_token_ids)
    trainer = TL.Trainer(make_loss_fn(model, cfg, deterministic=False), model, OptimizerConfig(),
                         TL.TrainLoopConfig(),
                         eval_loss_fn=make_loss_fn(model, cfg, deterministic=True))
    reloaded = trainer.evaluate(store.iterate(batch, seq_len))
    rel = abs(reloaded - best) / abs(best)
    print(f"{label} reload: eval loss from 'best' {reloaded:.8f} vs in-memory best "
          f"{best:.8f}, rel diff {rel:.3e} (tol 1e-6); seq_len {seq_len}", flush=True)
    assert rel <= 1e-6, f"{label}: the reloaded checkpoint does not give the best eval loss"


# phase 7's dataset: 4 levels of 256 codes (vocab 1041, as the flagship's), 3
# behaviors, histories of 110-170 items, 700 users (3500 training examples:
# 55 steps at batch 64)
PHASE7_SPEC = dict(n_users=700, n_items=6000, n_clusters=256, num_levels=4,
                   level_sizes=(256,) * 4, min_len=110, max_len=170, emb_dim=8, seed=0)
PHASE7_TRAIN = ("--backbone", "Qwen3Multi", "--batch_size", "64", "--dtype", "bfloat16")


def task_phase(dev, counters: dict, card: str, phase5_ms: float, spec: dict = PHASE7_SPEC,
               train_args=PHASE7_TRAIN, extra_args=(), min_steps: int = 40,
               num_beams: int = 20) -> None:
    """Phase 7: the task pipeline of `python -m gamer_tpu_torch` at the
    flagship widths, in process through `main(argv)`: a synthetic dataset
    from the port's generator (`PHASE7_SPEC`; --max_his_len 100 gives
    prompts of 100 blocks), one bf16 epoch of train_SMB_decoder (Qwen3Multi
    from config/s2s-models/Qwen3Multi, batch 64), test_SMB_decoder with 20
    beams at batch 128 from the saved "best", and test_SMB_rule --unique.
    Gates: finite losses, each training step's launches exactly those of
    phase 5 (none on the CPU), the C++ collation, the saved files, merged
    metrics in [0, 1], and the model reloaded from "best" giving the
    in-memory best eval loss within 1e-6 relative. `spec`, `train_args`,
    `extra_args` (e.g. --device cpu) and the counts let a test run it tiny."""
    import math
    import shutil
    import tempfile

    import torch

    from gamer_tpu_torch import native
    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.data.loading_smb import load_smb_train
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="phase7_", dir=here)
    data, out = os.path.join(root, "data"), os.path.join(root, "ckpt")
    write_synthetic_dataset(data, "Synth", SyntheticSpec(**spec))
    assert native._load() is not None and native.AVAILABLE, "the C++ collation did not build"
    cli = lambda argv: main([*argv, *extra_args])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    common = ["--dataset", "Synth", "--data_path", data, "--max_his_len", "100"]
    train = lambda out: cli(["train_SMB_decoder", *common, "--tasks", "smb_explicit_decoder_4",
                             "--base_model", os.path.join(here, "config", "s2s-models",
                                                          "Qwen3Multi"),
                             *train_args, "--epochs", "1", "--output_dir", out])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with _recording(counters) as rec, _captures() as cap:
        t = time.perf_counter()
        res = train(out)
        sync()
        fit_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0
    steps = rec["steps"]
    losses = [h["train_loss"] for h in res["history"]] + [res["best_metric"]]
    assert np.isfinite(losses).all(), f"non-finite losses {losses}"
    cfg = QwenFamilyConfig.from_file(out)
    expected = _train_step_launches(cfg) if dev.type == "cuda" else {k: 0 for k in counters}
    assert len(steps) >= min_steps, f"only {len(steps)} training steps"
    replayed, captured = check_step_launches("phase 7", rec, expected)
    # on the card every step but each graph's first replays it; on the CPU every step is eager
    assert captured == res["graphs"] and replayed == (len(steps) - captured) * (
        dev.type == "cuda"), (replayed, captured)
    assert captured >= (dev.type == "cuda"), "the compiled step was not captured"
    _check_fit_evals("phase 7", rec, cap, _scoring_launches(cfg, dev.type == "cuda", counters),
                     dev)
    for name in ("best", "last", "config.json", "vocab.json"):
        assert os.path.exists(os.path.join(out, name)), f"{name} was not saved"
    step_ms = float(np.median(np.diff(rec["stamps"][1:]))) * 1e3
    print(f"phase 7 train_SMB_decoder {' '.join(train_args)}: {len(steps)} steps + eval: "
          f"train loss {res['history'][0]['train_loss']:.5f}, best valid loss "
          f"{res['best_metric']:.6f}; {res['graphs']} CUDA graphs captured, {replayed} steps "
          f"replayed one; launches at each capture and warm-up {expected}, eval "
          f"{rec['evals']}, eval step graphs {cap.get('eval step', 0)}; step "
          f"{step_ms:.3f} ms median with host collation ({64 / (step_ms / 1e3):.1f} "
          f"sequences/s; phase 5 random-batch step {phase5_ms:.3f} ms); fit {fit_s:.1f} s; "
          f"peak memory {peak:.3f} GiB (the training and the eval graphs' pools); "
          f"native collation {native.AVAILABLE} (card {card})", flush=True)

    # the same run again from the same data and seed: bit-identical
    with _recording(counters) as again:
        res2 = train(os.path.join(root, "again"))
    first, second = ([float(x) for x in r["losses"]] for r in (rec, again))
    same = sum(a == b for a, b in zip(first, second))
    print(f"phase 7 second run of one tree: {same} of {len(first)} step losses bit-identical, "
          f"best valid loss {res2['best_metric']!r} vs {res['best_metric']!r}", flush=True)
    assert first == second and res2["best_metric"] == res["best_metric"], (
        "two runs of train_SMB_decoder from one seed differ")

    # the model reloaded from "best" gives the in-memory best eval loss
    d = load_smb_train("Synth", data, 100, ".index.json", "smb_explicit_decoder_4")
    _reload_check("phase 7", out, dev, d.train, d.valid, d.corpus.vocab,
                  math.lcm(d.builder.tc, 8),
                  int(train_args[train_args.index("--batch_size") + 1]), res["best_metric"])

    with _captures() as search_cap:
        t = time.perf_counter()
        ev = cli(["test_SMB_decoder", *common, "--test_task", "smb_explicit", "--ckpt_path",
                  out, "--num_beams", str(num_beams), "--test_batch_size", "128",
                  "--results_file", os.path.join(root, "test.json")])
        sync()
        eval_s = time.perf_counter() - t
    _check_search_graphs("phase 7 test_SMB_decoder", search_cap, dev, 1)
    rule = cli(["test_SMB_rule", *common, "--test_task", "smb_explicit", "--unique",
                "--results_file", os.path.join(root, "rule.json")])
    for label, r in (("test_SMB_decoder", ev), ("test_SMB_rule", rule)):
        assert r["merged"] and all(0.0 <= v <= 1.0 for v in r["merged"].values()), (label, r)
    rows = sum(ev["counts"].values())
    print(f"phase 7 test_SMB_decoder {num_beams} beams batch 128: {rows} rows in {eval_s:.3f} s "
          f"wall ({rows * num_beams / eval_s:.1f} beams/s), graphs {search_cap}; merged "
          f"{ {k: round(v, 5) for k, v in ev['merged'].items()} }; test_SMB_rule --unique merged "
          f"{ {k: round(v, 5) for k, v in rule['merged'].items()} } (card {card})", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 7 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 8's runs: the scripts' geometry (scripts/train_MB_decoder.sh: batch
# 256, temperature 0.7; --max_his_len 20), the presets' full widths (those of
# config/s2s-models/Qwen3ActionMoe: hidden 256, 8 layers, 6/3 heads of 64,
# d_ff 512), bf16
PHASE8_MB = ("--backbone", "Qwen3MoeAction", "--tasks", "mb_explicit_decoder_4",
             "--batch_size", "256", "--temperature", "0.7", "--bf16")
PHASE8_SEQ = ("--backbone", "Qwen3Moe", "--batch_size", "256", "--bf16")
MB_MODES = ["Target Behavior", "Behavior Specific", "Behavior Item"]


def seq_phase(dev, counters: dict, card: str, spec: dict = PHASE7_SPEC, mb_args=PHASE8_MB,
              seq_args=PHASE8_SEQ, extra_args=(), min_steps=(10, 100),
              num_beams: int = 20) -> None:
    """Phase 8: the multi- and single-behavior pipelines of `python -m
    gamer_tpu_torch` in process, on phase 7's synthetic dataset with
    --max_his_len 20: one epoch of train_MB_decoder (Qwen3MoeAction on
    mb_explicit_decoder_4, whose MoE runs kernels h and i once a layer,
    grouped over the behavior levels), then test_MB_decoder's three modes
    with 20 beams at batch 128; one epoch of train_decoder (Qwen3Moe on the
    single-behavior interactions), then test_decoder. Gates: finite losses,
    each training step's launches exactly `_step_launches` (MoeAction and
    Qwen3Moe a 8, b 8, h 8, i 8, j 1, k 1; none on the CPU), the counter
    `moe.grouped` moving on the card in the MoeAction fit alone, the
    reloaded MB "best" giving its best eval loss within 1e-6, after each
    fit one step of the kernel path against the plain path on the task's
    saved config and first batch, in bf16 and fp32 (`_task_paths_agree`), the three
    modes in the JAX task's order and names, every metric in [0, 1],
    `collision_info` present. Prints each fit's step time (median of the
    step-to-step times, host collation included), sequences/s, S and peak
    memory, the grouped launch's counters and the share of its launched
    row tiles that held rows (read from the fit's row tables after the fit,
    a captured table as its last replay left it), and each eval mode's wall
    time and beams/s. `spec`, the
    argument tuples, `extra_args` (e.g. --device cpu) and the counts let a
    test run it tiny."""
    import math
    import shutil
    import tempfile

    import torch

    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.core import trace
    from gamer_tpu_torch.data.contract import DataFiles
    from gamer_tpu_torch.data.seq import SeqCorpus, SeqExampleBuilder
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig
    from gamer_tpu_torch.modules import moe as MOE
    from gamer_tpu_torch.tasks import test_mb_decoder as TMB
    from gamer_tpu_torch.tasks.test_decoder import seq_inter_type
    from gamer_tpu_torch.tasks.train_mb_decoder import load_mb_train

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase8_", dir=os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(root, "data")
    write_synthetic_dataset(data, "Synth", SyntheticSpec(**spec))
    cli = lambda argv: main([*argv, *extra_args])
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    common = ["--dataset", "Synth", "--data_path", data, "--max_his_len", "20"]

    def fit(task, args, out, n_min):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        tables, level_rows = [], MOE.level_rows  # the grouped launch's row tables
        MOE.level_rows = lambda *a: tables.append(level_rows(*a)) or tables[-1]
        grouped = trace.counter("moe.grouped"), trace.counter("moe.grouped_tiles")
        try:
            with _recording(counters) as rec, _captures() as cap:
                t = time.perf_counter()
                res = cli([task, *common, *args, "--epochs", "1", "--output_dir", out])
                sync()
                fit_s = time.perf_counter() - t
        finally:
            MOE.level_rows = level_rows
        grouped = (trace.counter("moe.grouped") - grouped[0],
                   trace.counter("moe.grouped_tiles") - grouped[1])
        held = sum(int(g.level_tile[-1]) for g in tables)
        launched = sum(g.tile_level.numel() for g in tables)
        assert (grouped[0] > 0) == (cuda and "Qwen3MoeAction" in args), (
            f"{task}: grouped launches {grouped}")
        steps = rec["steps"]
        losses = [h["train_loss"] for h in res["history"]] + [res["best_metric"]]
        assert np.isfinite(losses).all(), f"{task}: non-finite losses {losses}"
        cfg = QwenFamilyConfig.from_file(out)
        expected = _train_step_launches(cfg) if cuda else {k: 0 for k in counters}
        assert len(steps) >= n_min, f"{task}: only {len(steps)} training steps"
        replayed, captured = check_step_launches(f"phase 8 {task}", rec, expected)
        assert captured == res["graphs"] and captured >= cuda, (replayed, captured)
        _check_fit_evals(f"phase 8 {task}", rec, cap, _scoring_launches(cfg, cuda, counters), dev)
        step_ms = float(np.median(np.diff(rec["stamps"][1:]))) * 1e3
        batch = int(args[args.index("--batch_size") + 1])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        print(f"phase 8 {task} {' '.join(args)}: {len(steps)} steps + eval: train loss "
              f"{res['history'][0]['train_loss']:.5f}, best valid loss {res['best_metric']:.6f}; "
              f"{captured} CUDA graphs, {replayed} steps replayed; launches at each capture and "
              f"warm-up {expected}, eval {rec['evals']}, eval step graphs "
              f"{cap.get('eval step', 0)}; S {rec['S']}; step "
              f"{step_ms:.3f} ms median with host collation ({batch / (step_ms / 1e3):.1f} "
              f"sequences/s); peak memory {peak:.3f} GiB; fit {fit_s:.1f} s; grouped MoE "
              f"launches {grouped[0]} of {grouped[1]} row tiles, {len(tables)} row tables "
              f"holding rows in {held} of their {launched} tiles "
              f"({100 * held / max(launched, 1):.1f}%) (card {card})", flush=True)
        return res, cfg, batch

    # 1. multi-behavior: train_MB_decoder, the reload check, test_MB_decoder
    mb_out = os.path.join(root, "mb")
    res, cfg, batch = fit("train_MB_decoder", mb_args, mb_out, min_steps[0])
    assert cfg.moe_action == ("Qwen3MoeAction" in mb_args)
    corpus, layout, train, valid = load_mb_train(
        "Synth", data, 20, ".index.json", mb_args[mb_args.index("--tasks") + 1], False)
    pad_multiple = math.lcm(layout.token_count(corpus.sole_item_len), 8)
    _reload_check("phase 8 train_MB_decoder", mb_out, dev, train, valid, corpus.vocab,
                  pad_multiple, batch, res["best_metric"])
    _task_paths_agree("phase 8 train_MB_decoder", mb_out, dev, counters, train, valid,
                      corpus.vocab, pad_multiple, batch)
    times = []  # (seconds, rows, graphs captured) of each evaluation mode, in order

    def timed(fn):
        def run(*args, **kwargs):
            with _captures() as cap:
                t = time.perf_counter()
                totals, count = fn(*args, **kwargs)
                sync()
                sec = time.perf_counter() - t
            times.append((sec, count, cap))
            return totals, count
        return run

    saved = {name: TMB.TestMBDecoder.__dict__[name]
             for name in ("_behavior_specific", "_behavior_item")}
    seq_eval = TMB.run_seq_eval
    TMB.run_seq_eval = timed(seq_eval)
    for name, method in saved.items():
        setattr(TMB.TestMBDecoder, name, staticmethod(timed(method.__func__)))
    try:
        ev = cli(["test_MB_decoder", *common, "--test_task", "mb_explicit", "--ckpt_path",
                  mb_out, "--num_beams", str(num_beams), "--test_batch_size", "128",
                  "--results_file", os.path.join(root, "mb.json")])
    finally:
        TMB.run_seq_eval = seq_eval
        for name, method in saved.items():
            setattr(TMB.TestMBDecoder, name, method)
    assert [r["eval_type"] for r in ev] == MB_MODES and len(times) == 3, ev
    for r in ev:
        assert all(0.0 <= v <= 1.0 for k, v in r.items() if k != "eval_type"), r
    print("phase 8 test_MB_decoder " + "; ".join(
        f"{r['eval_type']}: {n} rows in {sec:.3f} s wall ({n * num_beams / sec:.1f} beams/s), "
        f"graphs {cap}, { {k: round(v, 5) for k, v in r.items() if k != 'eval_type'} }"
        for r, (sec, n, cap) in zip(ev, times)) + f" ({num_beams} beams, card {card})",
        flush=True)
    for r, (_, _, cap) in zip(ev, times):
        _check_search_graphs(f"phase 8 test_MB_decoder {r['eval_type']}", cap, dev, 1)

    # 2. single-behavior: train_decoder, test_decoder
    seq_out = os.path.join(root, "seq")
    _, _, batch = fit("train_decoder", seq_args, seq_out, min_steps[1])
    corpus = SeqCorpus(DataFiles(data, "Synth"), ".index.json", multi_behavior=False,
                       inter_type=seq_inter_type("seqrec", None))
    builder = SeqExampleBuilder(corpus, 20)
    _task_paths_agree("phase 8 train_decoder", seq_out, dev, counters, builder.build("train"),
                      builder.build("valid"), corpus.vocab, math.lcm(corpus.sole_item_len, 8),
                      batch)
    with _captures() as cap:
        t = time.perf_counter()
        ev = cli(["test_decoder", *common, "--ckpt_path", seq_out, "--num_beams",
                  str(num_beams), "--test_batch_size", "128", "--results_file",
                  os.path.join(root, "seq.json")])
        sync()
        eval_s = time.perf_counter() - t
    _check_search_graphs("phase 8 test_decoder", cap, dev, 1)
    assert ev["metrics"] and all(0.0 <= v <= 1.0 for v in ev["metrics"].values()), ev
    assert set(ev["collision_info"]) == {"total", "collision_items", "collision_samples",
                                         "collision_ratio"}, ev
    print(f"phase 8 test_decoder: {ev['count']} rows in {eval_s:.3f} s wall "
          f"({ev['count'] * num_beams / eval_s:.1f} beams/s), graphs {cap}, "
          f"{ {k: round(v, 5) for k, v in ev['metrics'].items()} }; collision_info "
          f"{ev['collision_info']} ({num_beams} beams, card {card})", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 8 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


PHASE9_POLICIES = (None, "full", "attn", "dots")  # None = remat off


def _remat_launches(cfg, policy) -> dict:
    """`_step_launches` of a step under remat `policy`: "full" and "dots" run
    every attention forward (a) and MoE forward (h) again in the backward,
    "attn" only the MoE forwards (the attention cores keep their outputs);
    every policy runs each attention block's N1 again (the prologue of the
    core). Every policy runs each layer's dropout sites again but its last: the
    recompute stops once it has rebuilt the last tensor the backward saved
    (`torch.utils.checkpoint`'s early stop), and the last residual's K1
    saves none. A forward and backward: no optimizer update."""
    launches = _step_launches(cfg)
    if policy in ("full", "dots"):
        launches["fused_mask_attention"] *= 2
    if policy is not None:
        launches["fused_moe_ffn"] *= 2
        launches["qk_norm_rope_fwd"] *= 2
        launches["hash_dropout_fwd"] += sum(max(n - 1, 0) for n in _dropout_sites(cfg))
    return launches


def _remat_step(cfg, batch, dev, counters: dict, expected: dict, seed: int = 0,
                graphed: bool = True):
    """Two `Trainer` steps of a model of `cfg` from `seed`, then the grads of
    a third forward and backward. The first step runs the device part
    eagerly (compiled: then once more to capture its CUDA graph), each run
    launching `expected`; the second is timed: a replay with no launch from
    Python (compiled) or `expected` again (eager). The peak memory is that
    of the first step when compiled (its warm-up and capture: the replay
    allocates nothing), of the second when eager. Returns (the second
    step's loss, grads, ms, peak bytes over what was allocated before the
    model, the launches counted, the parameters after the two steps)."""
    import torch

    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    base = torch.cuda.memory_allocated() if cuda else 0
    model = QwenFamilyModel(cfg, device=dev, seed=seed)
    trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                      OptimizerConfig(learning_rate=5e-4, lr_scheduler_type="constant",
                                      total_steps=10), TrainLoopConfig(seed=0), graphed=graphed)
    policy = cfg.remat_policy if cfg.remat else "off"
    peaks = []
    for timed in (False, True):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with _recording(counters) as rec:
            t = time.perf_counter()
            loss = trainer.train_step(batch)
            sync()
            ms = (time.perf_counter() - t) * 1e3
        peaks.append(torch.cuda.max_memory_allocated() - base if cuda else 0)
        replayed, captured = check_step_launches(f"remat {policy}", rec, expected)
        assert (replayed, captured) == ((timed, not timed) if trainer.captures else (0, 0)), (
            f"remat {policy}: {replayed} replayed, {captured} captured")
        if not timed:  # the capture's launches, or the eager step's
            launches = rec["calls"][0][-1][1]
    peak = peaks[0] if trainer.captures else peaks[1]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, grads = _step_grads(model, make_loss_fn(model, cfg, deterministic=False), batch, seed + 1)
    grads = {n: g.detach().clone() for n, g in grads.items()}
    del trainer, model
    return loss.detach(), grads, ms, peak, launches, params


def _two_passes_agree(cfg, batch, dev) -> None:
    """Two remat-off forward and backward passes of one model on one batch
    with the same dropout seeds give the same grads bit for bit (PyTorch's
    default algorithms; the port's lookups sum in a fixed order,
    `modules/layers.lookup`)."""
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    model = QwenFamilyModel(cfg, device=dev, seed=0)
    loss_fn = make_loss_fn(model, cfg, deterministic=False)
    first = {n: g.clone() for n, g in _step_grads(model, loss_fn, batch, 1)[1].items()}
    second = _step_grads(model, loss_fn, batch, 1)[1]
    differ = sorted(((_rel_err(second[n], g)[1], n) for n, g in first.items()
                     if not (second[n] == g).all()), reverse=True)
    print(f"phase 9 two remat-off passes: {len(differ)} of {len(first)} grads differ, worst "
          f"{differ[0][0] if differ else 0.0:.3e} relative "
          f"({', '.join(n for _, n in differ[:3])})", flush=True)
    assert not differ, "two passes of one step differ"
    del model


def remat_phase(dev, counters: dict, card: str, cfg=None,
                geometries=((64, 101), (16, 1638)), auto=(96, 1638)) -> dict:
    """Phase 9: the remat policies and the memory estimate on flagship
    Qwen3Multi (bf16, dropout 0.2) through `Trainer`. At each calibration
    geometry (B 64 x S 505 and B 16 x S 8190, 1638 blocks) each policy (off,
    full, attn, dots) takes a warm-up and a timed step: per-step launches as
    `_remat_launches`, the timed loss and a third step's grads
    bit-identical to remat off's (where not, within phase 5's fp32 limits
    at B 16 x S 505), two remat-off passes bit-identical,
    peak memory full < attn, dots < off, and `train/memory.py`'s estimate at
    least the remat-off peak and at most 1.3x it. Then the automatic choice
    at B 96 x S 8190 (`auto_remat_overrides`: remat off's estimate exceeds
    BUDGET_FRACTION of an 80 GB card there) takes policy attn and one step
    within BUDGET_FRACTION of the card's memory. `cfg`, the geometries and `auto`
    let a test run it tiny; on the CPU nothing launches and no memory is
    measured."""
    import torch

    from gamer_tpu_torch.train.memory import (
        BUDGET_FRACTION, auto_remat_overrides, device_hbm_bytes, estimate_train_hbm_bytes)

    cuda = dev.type == "cuda"
    cfg = cfg or flagship_config(dropout_rate=DROP_RATE, model_max_length=8192)
    gib = lambda n: n / 2 ** 30
    results = {}
    for B, blocks in geometries:
        S = blocks * cfg.num_positions
        batch = make_batch(cfg, B, blocks, seed=3)
        runs, eager = {}, {}
        for policy in PHASE9_POLICIES:
            pcfg = cfg.replace(remat=policy is not None, remat_policy=policy or "attn")
            expected = ({**_remat_launches(pcfg, policy), **UPDATE_LAUNCHES} if cuda
                        else {k: 0 for k in counters})
            runs[policy or "off"] = _remat_step(pcfg, batch, dev, counters, expected)
            if policy in (None, "full"):  # the compiled step against the eager one
                eager[policy or "off"] = _remat_step(pcfg, batch, dev, counters, expected,
                                                     graphed=False)
        loss0, grads0 = runs["off"][:2]
        for name, (loss, grads, ms, peak, launches, params) in runs.items():
            exact = torch.equal(loss, loss0) and all(torch.equal(grads[n], g)
                                                     for n, g in grads0.items())
            line = ""
            if name in eager:
                e_loss, _, e_ms, e_peak, _, e_params = eager[name]
                same = torch.equal(loss, e_loss) and all(torch.equal(params[n], p)
                                                         for n, p in e_params.items())
                line = (f"; eager step {e_ms:.3f} ms, eager peak {gib(e_peak):.3f} GiB, compiled "
                        f"and eager losses and parameters bit-identical: {same}")
                assert same, f"remat {name}: the compiled step differs from the eager one"
            print(f"phase 9 remat {name} B={B} S={S}: compiled step {ms:.3f} ms (a replay), "
                  f"peak {gib(peak):.3f} GiB (its warm-up and capture), launches at the capture "
                  f"{launches}, loss {float(loss):.7f}, loss and grads bit-identical to remat "
                  f"off: {exact}{line} (card {card})", flush=True)
            if not exact:  # hold it in fp32 to phase 5's limits
                cfg32 = cfg.replace(dtype="float32")
                small = make_batch(cfg32, 16, 101, seed=1)
                l32, g32 = _remat_step(cfg32.replace(remat=True, remat_policy=name), small,
                                       dev, {}, {})[:2]
                l0, g0 = _remat_step(cfg32, small, dev, {}, {})[:2]
                rel = abs(float(l32) - float(l0)) / abs(float(l0))
                worst = max(_rel_err(g32[n], g0[n])[1] for n in g0)
                print(f"phase 9 remat {name} fp32 B=16 S=505: loss rel diff {rel:.3e}, worst "
                      f"grad rel err {worst:.3e}", flush=True)
                assert rel <= STEP_LOSS_TOL and worst <= STEP_GRAD_TOL, f"remat {name} differs"
        if cuda:
            peaks = {name: run[3] for name, run in runs.items()}
            eager_off_peak = eager["off"][3]
            assert peaks["full"] < min(peaks["attn"], peaks["dots"]), peaks
            assert max(peaks["attn"], peaks["dots"]) < peaks["off"], peaks
            est = estimate_train_hbm_bytes(cfg, B, S)
            ratio = est["total"] / peaks["off"]
            print(f"phase 9 estimate B={B} S={S}: {gib(est['total']):.3f} GiB (acts "
                  f"{gib(est['acts']):.3f}, params {gib(est['params']):.3f}, logits "
                  f"{gib(est['logits']):.3f}) against the compiled remat-off peak "
                  f"{gib(peaks['off']):.3f} GiB: {ratio:.3f}x (must lie in [1, 1.3]; the eager "
                  f"step's estimate ratio {est['total'] / eager_off_peak:.3f}x); "
                  f"attn {'<' if peaks['attn'] < peaks['dots'] else '>='} dots (card {card})",
                  flush=True)
            assert 1.0 <= ratio <= 1.3, f"the estimate is {ratio:.3f}x the measured peak"
        results[(B, S)] = {name: run[2:5] for name, run in runs.items()}
        del runs, eager, loss0, grads0
        if (B, blocks) == geometries[0]:
            _two_passes_agree(cfg, batch, dev)

    B, blocks = auto
    S = blocks * cfg.num_positions
    overrides = auto_remat_overrides(cfg, B, S, dev)
    total = device_hbm_bytes(dev)
    if cuda:
        assert overrides == {"remat": True, "remat_policy": "attn"}, overrides
    acfg = cfg.replace(**overrides)
    expected = ({**_remat_launches(acfg, acfg.remat_policy if acfg.remat else None),
                 **UPDATE_LAUNCHES} if cuda else {k: 0 for k in counters})
    batch = make_batch(acfg, B, blocks, seed=3)
    base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    model = QwenFamilyModel(acfg, device=dev, seed=0)
    trainer = Trainer(make_loss_fn(model, acfg, deterministic=False), model,
                      OptimizerConfig(learning_rate=5e-4, lr_scheduler_type="constant",
                                      total_steps=10), TrainLoopConfig(seed=0))
    with _recording(counters) as rec:
        t = time.perf_counter()
        loss = float(trainer.train_step(batch))
        ms = (time.perf_counter() - t) * 1e3
    replayed, captured = check_step_launches("phase 9 automatic choice", rec, expected)
    assert captured == trainer.captures, (replayed, captured)
    peak = torch.cuda.max_memory_allocated() - base if cuda else 0
    print(f"phase 9 automatic choice B={B} S={S}: {overrides or 'remat off'}; one step "
          f"{ms:.3f} ms (the first: its warm-up and capture), loss {loss:.6f}, launches "
          f"{rec['calls'][0][0][1]} at the warm-up and at the capture, peak "
          f"{gib(peak):.3f} GiB of {gib(total):.3f} ({peak / total:.3f}, limit "
          f"{BUDGET_FRACTION}; card {card})", flush=True)
    assert np.isfinite(loss), loss
    assert peak <= BUDGET_FRACTION * total
    del trainer, model
    return results


# phase 10's runs: the enc-dec scripts' geometry at the shipped configs' full
# widths (config/s2s-models/TIGER: d_model 128, d_ff 1024, 4+4 layers, 6 heads
# of 64, relu; config/s2s-models/PBATransformer: d_model 256, d_ff 512, every
# layer sparse over 6 experts), the dataset's vocab
PHASE10_SEQ = ("--backbone", "TIGER", "--batch_size", "256", "--learning_rate", "5e-4",
               "--temperature", "1.0")
PHASE10_SMB = ("--backbone", "PBATransformer", "--base_model",
               os.path.join("config", "s2s-models", "PBATransformer"),
               "--tasks", "smb_explicit_decoder_4", "--batch_size", "64")


def encdec_phase(dev, counters: dict, card: str, spec: dict = PHASE7_SPEC,
                 seq_args=PHASE10_SEQ, smb_args=PHASE10_SMB, extra_args=(),
                 min_steps=(100, 40), num_beams: int = 20) -> None:
    """Phase 10: the enc-dec pipelines of `python -m gamer_tpu_torch` in
    process, on phase 7's synthetic dataset: one epoch of train_decoder
    --backbone TIGER (--max_his_len 20, batch 256) and test_decoder, then one
    epoch of train_SMB_decoder --backbone PBATransformer from its shipped
    config (--max_his_len 100, batch 64) and test_SMB_decoder, 20 beams at
    batch 128. Gates: finite losses, the mean of the last 3 steps below the
    first 3's, family "encdec" saved, the reloaded "best" giving the best
    eval loss within 1e-6, parameters on the card, every code path of a
    direct search over the first 128 test rows in the trie with finite
    sorted scores, metrics in [0, 1], and no launch of kernels a-k, N1 or N2
    in the whole phase (the enc-dec family runs none, as in JAX). Prints each fit's
    step time (median of the step-to-step times, host collation included),
    the encoder and decoder lengths, peak memory, and each eval's wall time
    and beams/s. `spec`, the argument tuples, `extra_args` (e.g. --device
    cpu) and the counts let a test run it tiny."""
    import shutil
    import tempfile

    import torch

    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.data.batching import EncDecBatcher, iterate_batches
    from gamer_tpu_torch.data.contract import DataFiles
    from gamer_tpu_torch.data.loading_smb import load_smb_test, load_smb_train
    from gamer_tpu_torch.data.seq import SeqCorpus, SeqExampleBuilder
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
    from gamer_tpu_torch.data.vocab import EOS_ID
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_encdec_fn
    from gamer_tpu_torch.decode.trie import LeveledTrie
    from gamer_tpu_torch.models.generative.encdec_utils import encdec_loss_fn
    from gamer_tpu_torch.tasks.test_decoder import load_generative_model
    from gamer_tpu_torch.train import loop as TL
    from gamer_tpu_torch.train.state import OptimizerConfig

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="phase10_", dir=here)
    smb_args = tuple(os.path.join(here, a) if a.startswith("config" + os.sep) else a
                     for a in smb_args)
    data = os.path.join(root, "data")
    write_synthetic_dataset(data, "Synth", SyntheticSpec(**spec))
    cli = lambda argv: main([*argv, *extra_args])
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    before = {k: w.launches for k, w in counters.items()}
    none = {k: 0 for k in counters if k in QWEN_KERNELS}

    def pipeline(label, train_task, args, his, n_min, train, valid, test, prefix_of, corpus,
                 eval_argv):
        out = os.path.join(root, label)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with _recording(counters) as rec, _captures() as cap:
            t = time.perf_counter()
            res = cli([train_task, "--dataset", "Synth", "--data_path", data, "--max_his_len",
                       str(his), *args, "--epochs", "1", "--output_dir", out])
            sync()
            fit_s = time.perf_counter() - t
        _check_fit_evals(f"phase 10 {label}", rec, cap, {k: 0 for k in counters}, dev)
        losses = [float(x) for x in rec["losses"]]
        assert len(losses) >= n_min, f"{label}: only {len(losses)} training steps"
        assert np.isfinite(losses).all() and np.isfinite(res["best_metric"]), losses
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), f"{label}: the loss did not fall"
        qwen = [{k: n for k, n in st.items() if k in QWEN_KERNELS} for st in rec["steps"]]
        assert all(st == none for st in qwen), f"{label}: a Qwen kernel ran {qwen[0]}"
        with open(os.path.join(out, "config.json")) as f:
            assert json.load(f)["family"] == "encdec"
        batch = int(args[args.index("--batch_size") + 1])
        batcher = EncDecBatcher.for_examples(train + valid, eos_id=EOS_ID)
        step_ms = float(np.median(np.diff(rec["stamps"][1:]))) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        print(f"phase 10 {train_task} {' '.join(args)} --max_his_len {his}: {len(losses)} steps "
              f"+ eval: losses first 3 {[round(x, 4) for x in losses[:3]]}, last 3 "
              f"{[round(x, 4) for x in losses[-3:]]}, best valid loss {res['best_metric']:.6f}; "
              f"encoder S {batcher.enc_len}, decoder S {batcher.dec_len}; step {step_ms:.3f} ms "
              f"median with host collation ({batch / (step_ms / 1e3):.1f} sequences/s); peak "
              f"memory {peak:.3f} GiB; fit {fit_s:.1f} s; graphs {cap}; launches of the first "
              f"step {rec['steps'][0]} (card {card})", flush=True)

        # the reloaded "best" gives the in-memory best eval loss
        model, cfg, vocab, family = load_generative_model(out, "best", dev)
        assert family == "encdec" and all(p.device.type == dev.type for p in model.parameters())
        trainer = TL.Trainer(encdec_loss_fn(model, cfg), model, OptimizerConfig(),
                             TL.TrainLoopConfig(),
                             eval_loss_fn=encdec_loss_fn(model, cfg, deterministic=True))
        reloaded = trainer.evaluate(iterate_batches(valid, batch, batcher.collate))
        rel = abs(reloaded - res["best_metric"]) / abs(res["best_metric"])
        print(f"phase 10 {label} reload: eval loss from 'best' {reloaded:.8f} vs in-memory best "
              f"{res['best_metric']:.8f}, rel diff {rel:.3e} (tol 1e-6); {model.cfg.extra.get('backbone')} "
              f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_layers}+{cfg.num_decoder_layers} "
              f"layers, {cfg.num_heads} heads x {cfg.d_kv}, vocab {cfg.vocab_size}, sparse "
              f"{cfg.sparse_layers_encoder}/{cfg.sparse_layers_decoder}", flush=True)
        assert rel <= 1e-6, f"{label}: the reloaded checkpoint does not give the best eval loss"

        # one step's grads of the embedding tables, twice
        first = batcher.collate(train[:batch])
        tables = [f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.Embedding)]
        passes = []
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            encdec_loss_fn(model, cfg, deterministic=False)(
                first, torch.Generator().manual_seed(7))[0].backward()
            passes.append({n: model.get_parameter(n).grad.cpu() for n in tables})
        tables_reproduce(f"phase 10 {label}", *passes, tables)

        # a direct search over the first test rows: code paths in the trie
        trie = LeveledTrie.from_token_rows(corpus.item_codes[~corpus.collision_rows], vocab)
        rows = test[:128]
        search = make_beam_search_encdec_fn(model, trie, BeamSearchConfig(num_beams=num_beams))
        with _captures() as cap:
            codes, scores = search(EncDecBatcher.for_examples(test, eos_id=EOS_ID).collate(rows),
                                   prefix_of(rows, vocab, cfg))
        _check_search_graphs(f"phase 10 {label} search", cap, dev, 1, "enc-dec beam search")
        check_beams(trie, codes, scores, len(rows), num_beams)
        del model, trainer, search

        with _captures() as cap:
            t = time.perf_counter()
            ev = cli([*eval_argv, "--dataset", "Synth", "--data_path", data, "--max_his_len",
                      str(his), "--ckpt_path", out, "--num_beams", str(num_beams),
                      "--test_batch_size", "128", "--results_file",
                      os.path.join(root, label + ".json")])
            sync()
            eval_s = time.perf_counter() - t
        _check_search_graphs(f"phase 10 {eval_argv[0]}", cap, dev, 1, "enc-dec beam search")
        return ev, eval_s, cap

    # 1. TIGER on the single-behavior data: train_decoder, test_decoder
    corpus = SeqCorpus(DataFiles(data, "Synth"), ".index.json", multi_behavior=False)
    builder = SeqExampleBuilder(corpus, 20)
    ev, eval_s, cap = pipeline(
        "tiger", "train_decoder", seq_args, 20, min_steps[0], builder.build("train"),
        builder.build("valid"), builder.build("test"),
        lambda rows, vocab, cfg: np.array([cfg.decoder_start_token_id], np.int32), corpus,
        ["test_decoder"])
    assert ev["metrics"] and all(0.0 <= v <= 1.0 for v in ev["metrics"].values()), ev
    print(f"phase 10 test_decoder TIGER: {ev['count']} rows in {eval_s:.3f} s wall "
          f"({ev['count'] * num_beams / eval_s:.1f} beams/s), graphs {cap}, "
          f"{ {k: round(v, 5) for k, v in ev['metrics'].items()} } ({num_beams} beams, "
          f"card {card})", flush=True)

    # 2. PBATransformer on the SMB data: train_SMB_decoder, test_SMB_decoder
    d = load_smb_train("Synth", data, 100, ".index.json", smb_args[smb_args.index("--tasks") + 1])
    test = load_smb_test("Synth", data, 100, ".index.json", "smb_explicit").test

    def smb_prefix(rows, vocab, cfg):
        btoks = [vocab.behavior_token(d.corpus.behavior_names[int(ex.target_behaviors[0])])
                 for ex in rows]
        return np.stack([np.full(len(rows), cfg.decoder_start_token_id), btoks], 1).astype(np.int32)

    ev, eval_s, cap = pipeline("pbat", "train_SMB_decoder", smb_args, 100, min_steps[1], d.train,
                          d.valid, test, smb_prefix, d.corpus,
                          ["test_SMB_decoder", "--test_task", "smb_explicit"])
    assert ev["merged"] and all(0.0 <= v <= 1.0 for v in ev["merged"].values()), ev
    rows = sum(ev["counts"].values())
    print(f"phase 10 test_SMB_decoder PBATransformer: {rows} rows in {eval_s:.3f} s wall "
          f"({rows * num_beams / eval_s:.1f} beams/s), graphs {cap}; merged "
          f"{ {k: round(v, 5) for k, v in ev['merged'].items()} } ({num_beams} beams, "
          f"card {card})", flush=True)
    moved = {k: w.launches - before[k] for k, w in counters.items()}
    print(f"phase 10 launches in the whole phase: {moved}", flush=True)
    moved = {k: n for k, n in moved.items() if k in QWEN_KERNELS}
    assert moved == none, f"phase 10 launched kernels {moved}: a model other than the enc-dec ran"
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


# --------------------------------------------------------------------------- phase 11


@contextlib.contextmanager
def _group_env(n: int, rank: int, port: int, backend: str | None = None):
    """The GAMER_* rendezvous variables of process `rank` of `n` while the
    block runs (a task started in it joins that group), then the group is
    destroyed and the variables restored."""
    from gamer_tpu_torch.core import distributed

    env = {"GAMER_COORDINATOR": f"localhost:{port}", "GAMER_NUM_PROCESSES": str(n),
           "GAMER_PROCESS_ID": str(rank), "GAMER_DIST_TIMEOUT": str(MP_TIMEOUT_S)}
    if backend:
        env["GAMER_BACKEND"] = backend
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        distributed.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mp_batches(cfg, steps: int, rows: int, blocks: int) -> list[dict]:
    """Phase 11b's global batches: the second half's rows (process 1's)
    lose most of their labels, so the processes hold unequal numbers of
    valid targets."""
    batches = [make_batch(cfg, rows, blocks, seed=20 + i) for i in range(steps)]
    half, S = rows // 2, blocks * cfg.num_positions
    for b in batches:
        for r in range(half, rows):
            b["labels"][r, :S * (r - half + 1) // (half + 1)] = -100
    return batches


def mp_steps(cfg, batches: list[dict], dev, ctx=None) -> dict:
    """`Trainer` steps (SGD, one update a step) of a model of `cfg` from seed
    0, each on this process's rows of a global batch of `batches` (all of
    them without a group; on a mesh `ctx`, its data index's rows, with the
    model sharded on its model axis): the losses, each step's host time,
    the final parameters (whole) as one flat fp32 vector, and under a group
    without a model axis the time of the gradient all-reduce (one flat fp32
    buffer of the parameters' size, median of 5 after the steps)."""
    import torch

    from gamer_tpu_torch.core import distributed
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    n, r = distributed.process_count(), distributed.process_index()
    model = QwenFamilyModel(cfg, device=dev, seed=0)
    if ctx is not None:
        n, r = ctx.n_data, ctx.data_index
        ctx.shard_params(model)
    # SGD: the parameters move by lr x the summed grads; Adam would turn the
    # last bits of near-zero grads (rare tokens' embedding rows) into steps of lr
    trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                      OptimizerConfig(optim="sgd", learning_rate=0.5, weight_decay=0.0,
                                      lr_scheduler_type="constant", total_steps=len(batches)),
                      TrainLoopConfig(save_checkpoints=False))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses, step_ms = [], []
    for b in batches:
        rows = len(b["input_ids"]) // n
        t = time.perf_counter()
        losses.append(float(trainer.train_step({k: v[r * rows:(r + 1) * rows]
                                                for k, v in b.items()})))
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
    params = torch.cat([p.detach().float().reshape(-1) for p in trainer.model_state().values()])
    reduce_ms = []
    if distributed.is_initialized() and ctx is None:
        for _ in range(6):
            buf = params.clone()
            sync()
            t = time.perf_counter()
            distributed.all_reduce_flat([buf])
            sync()
            reduce_ms.append((time.perf_counter() - t) * 1e3)
        reduce_ms = reduce_ms[1:]
    return {"losses": losses, "params": params.cpu(), "step_ms": step_ms,
            "reduce_ms": float(np.median(reduce_ms)) if reduce_ms else None,
            "graphs": trainer.graphs}


def _mp_steps_worker(out: str, device: str, spec_json: str) -> None:
    """A process of phase 11b: joins its group, runs `mp_steps` on its rows
    and saves the result as out/rank<r>.pt."""
    import torch

    from gamer_tpu_torch.core import distributed

    spec = json.loads(spec_json)
    distributed.maybe_initialize(device=device)
    try:
        cfg = flagship_config(**spec["cfg"])
        res = mp_steps(cfg, _mp_batches(cfg, *spec["geometry"]), torch.device(device))
        torch.save(res, os.path.join(out, f"rank{distributed.process_index()}.pt"))
    finally:
        distributed.shutdown()


def _mp_eval_worker(out: str, argv_json: str) -> None:
    """A process of phase 11c: runs the CLI task `argv_json` in its group
    (the GAMER_* variables), then saves the beam-search graphs it captured
    and its peak device memory as out/eval_rank<r>.json."""
    import torch

    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.core import distributed, trace

    try:
        main(json.loads(argv_json))
        peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
        with open(os.path.join(out, f"eval_rank{distributed.process_index()}.json"), "w") as f:
            json.dump({"graphs": trace.counter("graph.capture.beam search"),
                       "peak_gib": peak / 2 ** 30}, f)
    finally:
        distributed.shutdown()


def grouped_steps_agree(dev, counters: dict, card: str, spec: dict) -> None:
    """Phase 11a's in-process part, in this process's group: phase 5's
    `Trainer` steps (`spec`: the config's overrides, (B, blocks), steps)
    compiled (on the card under NCCL: the (loss·w, w) and the gradient
    all-reduce inside the graph) against `graphed=False`: every run of the
    device part launching phase 5's kernels, one graph replayed by every
    step after the first, one gradient all-reduce a step (replays counted),
    the capture issuing the step's two all-reduces on the capturing stream
    (a one-rank NCCL all-reduce launches no kernel, so no profile shows
    them), losses and every parameter bit-identical. Prints each form's
    step time and busy share."""
    import torch

    from gamer_tpu_torch.core import distributed, trace
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = flagship_config(**spec["cfg"])
    (B, blocks), n = spec["geometry"], spec["steps"]
    batch = make_batch(cfg, B, blocks)
    expected = _train_step_launches(cfg) if cuda else {k: 0 for k in counters}
    runs = {}
    for graphed in (True, False):
        form = "compiled" if graphed else "eager"
        model = QwenFamilyModel(cfg, device=dev, seed=0)
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                          OptimizerConfig(learning_rate=5e-4, lr_scheduler_type="constant",
                                          total_steps=n), TrainLoopConfig(seed=0), graphed=graphed)
        calls = trace.counter("all_reduce.flat")
        losses, times = [], []
        with _recording(counters) as rec, _issued_all_reduces() as issued:
            for _ in range(n):
                t = time.perf_counter()
                losses.append(trainer.train_step(batch))
                sync()
                times.append(time.perf_counter() - t)
        replayed, captured = check_step_launches(f"phase 11a grouped {form}", rec, expected)
        want = (n - 1, 1) if graphed and cuda else (0, 0)
        assert (replayed, captured, trainer.graphs) == (*want, want[1]), (
            f"phase 11a grouped {form}: replayed {replayed}, captured {captured}, graphs "
            f"{trainer.graphs}, expected {want}")
        reductions = trace.counter("all_reduce.flat") - calls
        assert reductions == n, f"phase 11a grouped {form}: {reductions} all-reduces, {n} steps"
        # (loss·w, w) and the gradients: at the warm-up and the capture, or at every eager step
        want_issued = [False, False, True, True] if graphed and cuda else [False, False] * n
        assert issued == want_issued, f"phase 11a grouped {form}: all-reduces issued {issued}"
        losses = [float(x) for x in losses]
        assert np.isfinite(losses).all(), f"phase 11a grouped {form}: non-finite losses"
        params = {name: p.detach().clone() for name, p in model.named_parameters()}
        ms = float(np.median(times[1:])) * 1e3
        prof = _profiled_step(lambda: trainer.train_step(batch)) if cuda else None
        runs[form] = dict(losses=losses, params=params)
        busy = (f"; a profiled step {prof['device_ms']:.3f} ms of device kernels, "
                f"{100 * prof['device_ms'] / ms:.1f}% busy, {prof['launches']} kernels"
                if prof else "")
        print(f"phase 11a grouped Trainer {cfg.dtype} B={B} S={blocks * cfg.num_positions} "
              f"dropout {cfg.dropout_rate}, {form}: {n} steps, {ms:.3f} ms a step (median of "
              f"steps 2-{n}, host time to a synchronize; the first {times[0] * 1e3:.1f} ms), "
              f"graphs {trainer.graphs}, {reductions} gradient all-reduces, all-reduces issued "
              f"while capturing {sum(issued)} of {len(issued)}{busy} (card {card})", flush=True)
        del trainer, model
        if cuda:
            torch.cuda.empty_cache()
    c, e = runs["compiled"], runs["eager"]
    same = [k for k, p in c["params"].items() if torch.equal(p, e["params"][k])]
    print(f"phase 11a grouped Trainer compiled vs eager: "
          f"{sum(a == b for a, b in zip(c['losses'], e['losses']))} of {n} losses and "
          f"{len(same)} of {len(c['params'])} parameters bit-identical; losses "
          f"{[round(x, 5) for x in c['losses']]}", flush=True)
    assert c["losses"] == e["losses"], "the compiled grouped step's losses differ from eager"
    assert len(same) == len(c["params"]), "the compiled grouped step's parameters differ"


@contextlib.contextmanager
def _issued_all_reduces():
    """While the block runs, each `torch.distributed.all_reduce` call, as
    whether the current stream was capturing a CUDA graph when it was
    issued."""
    import torch
    import torch.distributed as dist

    issued, all_reduce = [], dist.all_reduce

    def counted(*args, **kwargs):
        issued.append(torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())
        return all_reduce(*args, **kwargs)
    dist.all_reduce = counted
    try:
        yield issued
    finally:
        dist.all_reduce = all_reduce


# phase 11b: 4 fp32 steps at a global batch of 16 x 101 blocks, dropout 0.2
PHASE11_STEPS = dict(cfg=dict(dtype="float32", dropout_rate=0.2), geometry=(4, 16, 101))
# phase 11a's in-process part: phase 5's steps (bf16, B 64 x 101 blocks, dropout 0.2)
PHASE11_INPROC = dict(cfg=dict(dropout_rate=DROP_RATE), geometry=(64, 101), steps=10)


def multiprocess_phase(dev, counters: dict, card: str, spec: dict = PHASE7_SPEC,
                       train_args=PHASE7_TRAIN, steps_spec: dict = PHASE11_STEPS,
                       inproc_spec: dict = PHASE11_INPROC, extra_args=(),
                       min_steps: int = 40, num_beams: int = 20) -> None:
    """Phase 11: the data-parallel path (`core/distributed.py`) at the
    flagship widths.

    a. train_SMB_decoder (phase 7's run) in a one-process group (NCCL on the
       card) against the same run ungrouped: the grouped step captured as
       phase 7's is (its all-reduces inside the graph: one graph a key, the
       graphs and the eval step's as ungrouped), each run of its device part
       launching phase 5's kernels, one gradient all-reduce a step (replays
       counted), every step's loss within 1e-6 relative; then
       `grouped_steps_agree` in the same group.
    b. Two processes on the one card over gloo (NCCL refuses two ranks on
       one device; gloo stages the card's tensors through the host, so the
       step, whose device part reduces over it, stays eager): 4 fp32
       `Trainer` steps (`mp_steps`) at a global batch of 16 x S 505, dropout
       0.2, the second process's rows with fewer valid targets, against this
       process fed the whole global batches: losses within 1e-5 relative,
       final parameters within 1e-4 (max |d| / max |p|), the two processes'
       parameters bit-identical; prints the all-reduce's time a step.
    c. test_SMB_decoder striped over two processes (gloo) from a's
       checkpoint against one process: per-behavior row counts equal, the
       merged metrics within 1e-2 absolute (bf16 beams may flip with the
       batch's composition), each process's search captured as one
       process's is (it holds no collective); prints both and each
       process's peak memory.
    `spec`, the argument tuples, the specs, `extra_args` (e.g. --device cpu)
    and the counts let a test run it tiny."""
    import shutil
    import tempfile

    import torch

    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.core import distributed, trace
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="phase11_", dir=here)
    data = os.path.join(root, "data")
    write_synthetic_dataset(data, "Synth", SyntheticSpec(**spec))
    cli = lambda argv: main([*argv, *extra_args])
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    common = ["--dataset", "Synth", "--data_path", data, "--max_his_len", "100"]
    train = ["train_SMB_decoder", *common, "--tasks", "smb_explicit_decoder_4", "--base_model",
             os.path.join(here, "config", "s2s-models", "Qwen3Multi"), *train_args, "--epochs",
             "1"]

    # a. one-process group against ungrouped
    runs = {}
    for grouped in (False, True):
        out = os.path.join(root, "grouped" if grouped else "plain")
        calls = trace.counter("all_reduce.flat")
        with contextlib.ExitStack() as stack:
            if grouped:
                stack.enter_context(_group_env(1, 0, _free_port()))
            with _recording(counters) as rec, _captures() as cap:
                res = cli([*train, "--output_dir", out])
                sync()
            assert distributed.is_initialized() == grouped, "the task did not join its group"
            runs[grouped] = (rec, cap, res, trace.counter("all_reduce.flat") - calls, out)
            if grouped:
                assert distributed.backend() == ("nccl" if cuda else "gloo")
                grouped_steps_agree(dev, counters, card, inproc_spec)
    (plain, plain_cap, _, _, _), (rec, cap, res, reductions, out) = runs[False], runs[True]
    cfg = QwenFamilyConfig.from_file(out)
    expected = _train_step_launches(cfg) if cuda else {k: 0 for k in counters}
    steps = len(rec["steps"])
    assert steps >= min_steps, f"only {steps} grouped steps"
    # the grouped step is captured as phase 7's ungrouped one: one graph a key
    replayed, captured = check_step_launches("phase 11a grouped", rec, expected)
    assert captured == res["graphs"] and replayed == (steps - captured) * cuda, (
        replayed, captured)
    assert captured >= cuda, "the grouped step was not captured"
    _check_fit_evals("phase 11a grouped", rec, cap, _scoring_launches(cfg, cuda, counters), dev)
    assert cap == plain_cap, f"phase 11a: grouped graphs {cap}, ungrouped {plain_cap}"
    assert reductions == steps, f"{reductions} all-reduces for {steps} steps"
    a, b = np.array([float(x) for x in rec["losses"]]), np.array([float(x) for x in plain["losses"]])
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    step_ms = [float(np.median(np.diff(r["stamps"][1:]))) * 1e3 for r in (plain, rec)]
    print(f"phase 11a train_SMB_decoder in a one-process {'NCCL' if cuda else 'gloo'} group: "
          f"{len(a)} steps, {reductions} gradient all-reduces, graphs {cap} (ungrouped "
          f"{plain_cap}), {replayed} steps replayed; launches at each capture and warm-up "
          f"{expected}; "
          f"losses vs ungrouped: worst rel diff {rel:.3e} (tol 1e-6), first {a[0]:.7f} / "
          f"{b[0]:.7f}, last {a[-1]:.7f} / {b[-1]:.7f}; step {step_ms[1]:.3f} ms grouped, "
          f"{step_ms[0]:.3f} ms ungrouped (median, host collation; "
          f"card {card})", flush=True)
    assert np.isfinite(a).all() and rel <= 1e-6, "grouped losses differ from ungrouped"

    # b. two processes on one card against one process
    mp_dir = os.path.join(root, "mp")
    os.makedirs(mp_dir)
    dev_name = "cuda" if cuda else "cpu"
    worker = [os.path.abspath(__file__), "--mp-steps", mp_dir, dev_name, json.dumps(steps_spec)]
    distributed.spawn_local([worker, worker], backend="gloo", timeout_s=MP_TIMEOUT_S)
    cfg = flagship_config(**steps_spec["cfg"])
    one = mp_steps(cfg, _mp_batches(cfg, *steps_spec["geometry"]), dev)
    res = [torch.load(os.path.join(mp_dir, f"rank{r}.pt"), weights_only=True) for r in (0, 1)]
    assert torch.equal(res[0]["params"], res[1]["params"]), "the processes' parameters differ"
    # gloo stages the card's tensors through the host: a step that reduces over it stays eager
    assert [r["graphs"] for r in res] == [0, 0], (
        "a process of a gloo group captured its step, whose device part holds gloo all-reduces")
    loss_rel = float(np.max(np.abs(np.subtract(res[0]["losses"], one["losses"]))
                            / np.abs(one["losses"])))
    par_rel = float((res[0]["params"] - one["params"]).abs().max() / one["params"].abs().max())
    _, rows, blocks = steps_spec["geometry"]
    print(f"phase 11b 2 gloo processes on one {'card' if cuda else 'CPU'}, {cfg.dtype} B={rows} "
          f"S={blocks * cfg.num_positions} dropout {cfg.dropout_rate}, {len(one['losses'])} SGD "
          f"steps: losses {[round(x, 6) for x in res[0]['losses']]} "
          f"vs one process {[round(x, 6) for x in one['losses']]}, worst rel diff {loss_rel:.3e} "
          f"(tol 1e-5); parameters rel err {par_rel:.3e} (tol 1e-4), bit-identical across "
          f"processes; steps {[round(x, 1) for x in res[0]['step_ms']]} ms on process 0, "
          f"{[round(x, 1) for x in one['step_ms']]} ms one process; the gradient all-reduce "
          f"(one flat fp32 buffer, {res[0]['params'].numel() * 4 / 2 ** 20:.1f} MiB) "
          f"{res[0]['reduce_ms']:.3f} ms a step, timed alone (card {card})", flush=True)
    assert loss_rel <= 1e-5 and par_rel <= 1e-4, "two processes differ from one"

    # c. test_SMB_decoder over two processes
    evaluate = ["test_SMB_decoder", *common, "--test_task", "smb_explicit", "--ckpt_path", out,
                "--num_beams", str(num_beams), "--test_batch_size", "128"]
    with _captures() as cap:
        t = time.perf_counter()
        single = cli([*evaluate, "--results_file", os.path.join(root, "one.json")])
        sync()
        one_s = time.perf_counter() - t
    _check_search_graphs("phase 11c one process", cap, dev, 1)
    t = time.perf_counter()
    argv = [*evaluate, "--results_file", os.path.join(root, "two.json"), *extra_args]
    cmd = [os.path.abspath(__file__), "--mp-eval", root, json.dumps(argv)]
    logs = distributed.spawn_local([cmd, cmd], backend="gloo", timeout_s=MP_TIMEOUT_S)
    two_s = time.perf_counter() - t
    # the search holds no collective: each process captures it as one process does
    assert f"the search captured {int(cuda)} CUDA graphs" in logs[0], logs[0][-2000:]
    procs = []
    for r in (0, 1):
        with open(os.path.join(root, f"eval_rank{r}.json")) as f:
            procs.append(json.load(f))
    assert [p["graphs"] for p in procs] == [int(cuda)] * 2, f"phase 11c: graphs {procs}"
    with open(os.path.join(root, "two.json")) as f:
        merged = json.load(f)
    worst = max(abs(merged["merged"][k] - v) for k, v in single["merged"].items())
    print(f"phase 11c test_SMB_decoder {num_beams} beams, rows per behavior "
          f"{merged['counts']} over 2 processes (one process {single['counts']}); merged "
          f"{ {k: round(v, 5) for k, v in merged['merged'].items()} } vs one process "
          f"{ {k: round(v, 5) for k, v in single['merged'].items()} }, worst diff {worst:.2e} "
          f"(tol 1e-2); {two_s:.1f} s wall with the processes' start, one process {one_s:.1f} s; "
          f"each process's search graphs {[p['graphs'] for p in procs]}, peak memory "
          f"{[round(p['peak_gib'], 3) for p in procs]} GiB (card {card})", flush=True)
    assert merged["counts"] == single["counts"], "row counts differ"
    assert worst <= 1e-2, "two-process metrics differ from one process's"
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 11 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


# --------------------------------------------------------------------------- phase 12

# phase 12: the shipped RQ-VAE widths (gamer_tpu/models/tokenizer/rqvae.py
# defaults, scripts' batch 1024, alpha 0.02, beta 1e-4) on 768-d embeddings
PHASE12_RQ = ("--layers", "2048,1024,512,256,128,64", "--e_dim", "32", "--num_emb", "256",
              "--num_levels", "4", "--sk_epsilons", "0,0,0,0.003", "--batch_size", "1024",
              "--alpha", "0.02", "--beta", "0.0001")


def tokenizer_phase(dev, counters: dict, card: str, spec: dict = PHASE7_SPEC,
                    rq_args=PHASE12_RQ, emb_dim: int = 768, epochs: int = 20,
                    eval_step: int = 10, train_args=PHASE7_TRAIN, extra_args=(),
                    min_steps: int = 40) -> None:
    """Phase 12: the item-tokenizer chain through `python -m
    gamer_tpu_torch` on phase 7's dataset (6000 items): SemEmb (hash
    backend, 768-d), RQVAE at the shipped widths for 20 epochs with
    --kmeans_init and seeded 32-d CF embeddings (evals at epochs 10 and 20),
    tokenize --mode rq_vae from best_collision, then one epoch of
    train_SMB_decoder on the emitted index through the kernels. Gates:
    finite losses, the last eval's reconstruction loss below the first
    epoch's (the total is printed, not gated: the CF InfoNCE's pull on the
    quantized vectors grows the quantization loss as it falls, so the total
    rises between the evals; the port's step equals the JAX task's at 1e-5,
    tests/test_torch_tokenizer.py), one code row
    of `levels` codes an item, each in its level's range, collision rate 0
    after the repair, each training step's launches those of phase 5, and
    one fp32 RQ-VAE training step on the card against the same step on the
    CPU (same parameters, batch and diversity noise, TF32 off) within 1e-4
    relative. The task's training step, emit and reclustering are
    compiled: one graph each, the step's warm-up and capture launching
    L1/L2 once and nothing else, every later step replayed, the
    reclustering's graph replayed at every epoch after the first; then one
    epoch of the compiled step against the eager one from best_collision,
    the compiled emit against the eager one, and the compiled reclustering
    and the epoch after it against their eager forms (`rqvae_forms_agree`:
    bit-identical; the step time and busy share of both forms, and the
    reclustering's wall and device time, printed). Prints the k-means init's
    cluster sizes and time, the epoch time, tokenize's wall time and the
    decoder's step time. `spec`, the
    argument tuples, the sizes, `extra_args` and the counts let a test run
    it tiny."""
    import copy
    import shutil
    import tempfile

    import torch

    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig
    from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
    from gamer_tpu_torch.ops.kmeans import cluster_codebook
    from gamer_tpu_torch.tasks import rqvae as TR
    from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="phase12_", dir=here)
    data, ckpt = os.path.join(root, "data"), os.path.join(root, "rq")
    write_synthetic_dataset(data, "Synth", SyntheticSpec(**spec))
    cli = lambda argv: main([*argv, *extra_args])
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ds = ["--dataset", "Synth", "--data_path", data]

    emb = cli(["SemEmb", *ds, "--emb_dim", str(emb_dim)])["output_file"]
    cf = os.path.join(root, "cf.npy")
    e_dim = int(rq_args[rq_args.index("--e_dim") + 1])  # the CF width the InfoNCE needs
    np.save(cf, np.random.default_rng(0).standard_normal((spec["n_items"], e_dim)).astype(
        np.float32))
    t = time.perf_counter()
    with _recording_calls(counters, TR.RQVAEStep) as rq_rec, _captures() as rq_cap:
        rq = cli(["RQVAE", *ds, "--emb_file", emb, "--cf_emb_file", cf, "--kmeans_init",
                  *rq_args, "--epochs", str(epochs), "--eval_step", str(eval_step),
                  "--output_dir", ckpt])
        sync()
    rq_s = time.perf_counter() - t
    rq_expected = staged_step_launches(rq_rec["owner"].model, cuda, counters)
    rq_replayed, rq_captured = check_step_launches("phase 12 RQVAE", rq_rec, rq_expected)
    want = ({"rq-vae training step": 1, "rq-vae emit": 1, "rq-vae recluster": 1} if cuda
            else {})
    assert rq_cap == want and rq_captured == int(cuda), f"phase 12 RQVAE graphs {rq_cap}"
    print(f"phase 12 RQVAE compiled: graphs {rq_cap}, {rq_replayed} of {len(rq_rec['steps'])} "
          f"steps replayed, launches at the warm-up and capture {rq_expected}", flush=True)
    hist = rq["history"]
    sizes = [np.asarray(s) for s in rq["init_cluster_sizes"]]
    print(f"phase 12 RQVAE {' '.join(rq_args)}: k-means init {rq['init_s']:.2f} s, cluster "
          f"sizes a level (min/median/max, empty) "
          f"{[(int(s.min()), float(np.median(s)), int(s.max()), int((s == 0).sum())) for s in sizes]}; "
          f"epoch {float(np.median(rq['epoch_s'])) * 1e3:.1f} ms median of {len(rq['epoch_s'])} "
          f"(recluster and {-(-spec['n_items'] // int(rq_args[rq_args.index('--batch_size') + 1]))} "
          f"steps); evals "
          f"{[{k: round(v, 5) for k, v in h.items()} for h in hist]}; {rq_s:.1f} s (card {card})",
          flush=True)
    epochs_ = rq["epochs"]
    print(f"phase 12 RQVAE epoch means (loss, recon, quant, cf): "
          f"{[tuple(round(e[k], 4) for k in ('loss', 'recon_loss', 'quant_loss', 'cf_loss')) for e in epochs_]}",
          flush=True)
    assert all(np.isfinite([e[k] for k in ("loss", "recon_loss", "quant_loss", "cf_loss")]).all()
               for e in epochs_), "non-finite RQ-VAE losses"
    assert len(hist) >= 2 and hist[-1]["recon_loss"] < epochs_[0]["recon_loss"], (
        "the reconstruction loss did not fall from the first epoch")
    assert all(s.sum() == spec["n_items"] for s in sizes)

    t = time.perf_counter()
    tok = cli(["tokenize", "--mode", "rq_vae", *ds, "--ckpt_path", ckpt, "--ckpt_tag",
               "best_collision", "--epoch", str(epochs), "--emb_file", emb])
    sync()
    tok_s = time.perf_counter() - t
    cfg = RQVAEConfig.from_file(ckpt)
    codes = tok["codes"]
    print(f"phase 12 tokenize rq_vae: {codes.shape[0]} items x {codes.shape[1]} codes, collision "
          f"rate {tok['collision_rate']} after repair (best_collision's {rq['best_collision']}); "
          f"{tok_s:.2f} s wall (card {card})", flush=True)
    assert codes.shape == (spec["n_items"], cfg.num_levels)
    assert (codes >= 0).all() and (codes < np.asarray(cfg.num_emb_list)).all()
    assert tok["collision_rate"] == 0.0, "collisions left after the repair"

    # one fp32 RQ-VAE step on the card against the CPU
    state = torch.load(os.path.join(ckpt, "best_collision", "state.pt"), weights_only=True)
    x = torch.as_tensor(TR.load_embeddings(emb)[:int(rq_args[rq_args.index("--batch_size") + 1])])
    c = torch.as_tensor(np.load(cf)[:len(x)])
    labels = torch.as_tensor(np.stack([np.pad(cluster_codebook(
        state["codebooks"][lvl, :n], min(cfg.n_clusters, n), 0), (0, max(cfg.num_emb_list) - n))
        for lvl, n in enumerate(cfg.num_emb_list)]))
    steps = {}
    for where in (dev, torch.device("cpu")):
        model = RQVAE(cfg, device=where)
        model.load_state_dict(copy.deepcopy(state))
        opt = make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-3,
                                             weight_decay=1e-4, lr_scheduler_type="constant",
                                             warmup_ratio=0.0, max_grad_norm=0.0), model)
        steps[where.type] = float(TR.train_step(model, opt, x.to(where), c.to(where),
                                                labels.to(where), TR.step_generator(0, 0, 0))[0])
    step_rel = abs(steps[dev.type] - steps["cpu"]) / abs(steps["cpu"])
    print(f"phase 12 RQ-VAE fp32 step B={len(x)}: loss {steps[dev.type]:.7f} ({dev.type}) vs "
          f"{steps['cpu']:.7f} (cpu), rel diff {step_rel:.3e} (tol 1e-4)", flush=True)
    assert step_rel <= 1e-4, "the RQ-VAE step on the card differs from the CPU's"
    rqvae_forms_agree(cfg, state, TR.load_embeddings(emb), np.load(cf), labels.numpy(),
                      int(rq_args[rq_args.index("--batch_size") + 1]), dev, card, counters)

    # the generative model on the emitted semantic IDs, through the kernels
    index = os.path.basename(tok["output_file"]).removeprefix("Synth")
    out = os.path.join(root, "decoder")
    with _recording(counters) as rec:
        res = cli(["train_SMB_decoder", *ds, "--max_his_len", "100", "--index_file", index,
                   "--tasks", "smb_explicit_decoder_4", "--base_model",
                   os.path.join(here, "config", "s2s-models", "Qwen3Multi"), *train_args,
                   "--epochs", "1", "--output_dir", out])
        sync()
    expected = (_train_step_launches(QwenFamilyConfig.from_file(out)) if cuda
                else {k: 0 for k in counters})
    losses = [float(v) for v in rec["losses"]]
    assert len(losses) >= min_steps and np.isfinite(losses).all(), losses
    replayed, captured = check_step_launches("phase 12", rec, expected)
    step_ms = float(np.median(np.diff(rec["stamps"][1:]))) * 1e3
    print(f"phase 12 train_SMB_decoder on {index}: {len(losses)} steps, {captured} CUDA graphs, "
          f"{replayed} steps replayed; launches at each capture and warm-up {expected}, train "
          f"loss {res['history'][0]['train_loss']:.5f}, best valid loss "
          f"{res['best_metric']:.6f}; step {step_ms:.3f} ms median with host collation "
          f"(card {card})", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 12 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


def rqvae_forms_agree(cfg, state: dict, x: np.ndarray, cf: np.ndarray, labels: np.ndarray,
                      batch_size: int, dev, card: str, counters: dict) -> None:
    """Phase 12's compiled RQ-VAE against its eager form from the same
    state: one epoch of `tasks/rqvae.RQVAEStep` over a seeded permutation
    of every item, wrapped to whole batches as the task wraps it
    (`staged_forms_agree`: each step's [loss, recon, quant, cf] and every
    parameter bit-identical, one graph, L1/L2 once at the capture, the
    replay's kernels those of the eager step), then `RQVAEEmit` over every
    item on each form's model: the codes equal, one emit graph."""
    import torch

    from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE
    from gamer_tpu_torch.tasks import rqvae as TR
    from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

    xs = torch.as_tensor(x, device=dev)
    cfs = torch.as_tensor(cf, device=dev)
    n = len(x)
    pad_n = -(-n // batch_size) * batch_size
    order = np.random.default_rng(0).permutation(n)
    order = np.concatenate([order, order[:pad_n - n]])

    def make(graphed):
        model = RQVAE(cfg, device=dev)
        model.load_state_dict(state)
        opt = make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-3,
                                             weight_decay=1e-4, lr_scheduler_type="constant",
                                             warmup_ratio=0.0, max_grad_norm=0.0), model)
        step = TR.RQVAEStep(model, opt, xs, cfs, graphed)
        step.set_labels(labels)
        return step, model

    calls = [lambda st, s=s: st(order[s:s + batch_size], TR.step_generator(0, 0, s))
             for s in range(0, pad_n, batch_size)]
    runs = staged_forms_agree(f"phase 12 RQ-VAE epoch B={batch_size} ({len(calls)} steps)",
                              make, calls, TR.RQVAEStep, counters, dev, card)
    with _captures() as cap:
        codes = {form: TR.RQVAEEmit(model, xs, batch_size, form == "compiled")()
                 for form, (_, model, _) in runs.items()}
    print(f"phase 12 RQ-VAE emit of {n} items: compiled vs eager codes equal "
          f"{bool((codes['compiled'] == codes['eager']).all())}; graphs {cap}", flush=True)
    assert codes["compiled"].shape == (n, cfg.num_levels)
    assert (codes["compiled"] == codes["eager"]).all(), "the compiled emit differs from eager"
    assert cap == ({"rq-vae emit": 1} if dev.type == "cuda" else {}), cap
    recluster_forms_agree(cfg, runs, [lambda st, s=s: st(order[s:s + batch_size],
                                                         TR.step_generator(0, 1, s))
                                      for s in range(0, pad_n, batch_size)], dev, card)


RECLUSTERS = 4  # phase 12's reclusterings of each form (epochs 1-4)


def recluster_forms_agree(cfg, runs: dict, calls: list, dev, card: str) -> None:
    """Phase 12's compiled reclustering against its eager form, on the
    models and steps `rqvae_forms_agree` left (equal, bit for bit):
    `tasks/rqvae.RQVAERecluster` into each step's label buffer at epochs
    1-4 (the compiled form captured at the first and replayed after), the
    labels bit-identical to each other and to `ops/kmeans.cluster_codebook`
    a level at every epoch; then one more epoch of `calls` (the steps,
    reading the last labels) on each form: every step's output and every
    parameter and buffer bit-identical. Prints the reclustering's wall time
    (a replay, or an eager run, ending in a synchronize; median of epochs
    2-4) and, on the card, the device time and kernels of a profiled one."""
    import torch

    from gamer_tpu_torch.core import trace
    from gamer_tpu_torch.ops.kmeans import cluster_codebook
    from gamer_tpu_torch.tasks import rqvae as TR

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    labels, info = {}, {}
    for form, (step, model, _) in runs.items():
        recluster = TR.RQVAERecluster(model, step.labels, form == "compiled")
        before = trace.counter("graph.capture.rq-vae recluster")
        labels[form], times = [], []
        for epoch in range(1, RECLUSTERS + 1):
            sync()
            t = time.perf_counter()
            recluster(0, epoch)
            sync()
            times.append(time.perf_counter() - t)
            labels[form].append(step.labels.clone())
        new = trace.counter("graph.capture.rq-vae recluster") - before
        want = int(cuda and form == "compiled")
        assert recluster.staged.graphs == new == want, (
            f"phase 12 reclustering {form}: {recluster.staged.graphs} graphs, {new} captured")
        prof = _profiled_step(lambda: recluster(0, RECLUSTERS)) if cuda else None
        info[form] = dict(ms=float(np.median(times[1:])) * 1e3, first_ms=times[0] * 1e3,
                          prof=prof)
        busy = (f"; a profiled one {prof['device_ms']:.3f} ms of device kernels in "
                f"{prof['launches']} kernels" if prof else "")
        print(f"phase 12 RQ-VAE reclustering ({cfg.num_levels} levels of "
              f"{cfg.num_emb_list} codes, {cfg.n_clusters} clusters) {form}: "
              f"{info[form]['ms']:.3f} ms wall (median of epochs 2-{RECLUSTERS}, to a "
              f"synchronize; the first {info[form]['first_ms']:.1f} ms), graphs "
              f"{recluster.staged.graphs}{busy} (card {card})", flush=True)
    same = sum(torch.equal(a, b) for a, b in zip(labels["compiled"], labels["eager"]))
    model = runs["eager"][1]
    books = model.codebooks.detach()
    host = np.stack([np.pad(cluster_codebook(books[lvl, :n], min(cfg.n_clusters, n),
                                             RECLUSTERS + lvl), (0, max(cfg.num_emb_list) - n))
                     for lvl, n in enumerate(cfg.num_emb_list)])
    print(f"phase 12 RQ-VAE reclustering compiled vs eager: labels bit-identical at {same} of "
          f"{RECLUSTERS} epochs; the last equal to cluster_codebook's a level "
          f"{bool((labels['eager'][-1].cpu().numpy() == host).all())}", flush=True)
    assert same == RECLUSTERS, "the compiled reclustering's labels differ from eager"
    assert (labels["eager"][-1].cpu().numpy() == host).all(), (
        "the reclustering's labels differ from cluster_codebook's")
    outs = {form: [call(step) for call in calls] for form, (step, _, _) in runs.items()}
    same_out = sum(torch.equal(a, b) for a, b in zip(outs["compiled"], outs["eager"]))
    c_state, e_state = (runs[f][1].state_dict() for f in ("compiled", "eager"))
    same_state = [k for k in c_state if torch.equal(c_state[k], e_state[k])]
    print(f"phase 12 RQ-VAE epoch after the reclustering, compiled vs eager: {same_out} of "
          f"{len(calls)} step outputs and {len(same_state)} of {len(c_state)} parameters and "
          f"buffers bit-identical", flush=True)
    assert same_out == len(calls) and len(same_state) == len(c_state), (
        "the epoch after the compiled reclustering differs from eager")


# --------------------------------------------------------------------------- phase 13

# phase 13: scripts/train_SMB_rec.sh's geometry, each backbone from its
# shipped config (config/dis-models/<name>, nothing cut), on phase 7's sizes
# with the sequential signal of scripts/quality_run.py's datasets (a global
# cluster successor graph, Zipf item popularity): on phase 7's iid data
# SASRec's and GRU4Rec's losses stay at the uniform floor through their
# first epoch, in the JAX task too (PERF.md §6)
PHASE13_SPEC = dict(PHASE7_SPEC, cluster_stickiness=0.6, succ_per_cluster=3, item_pop_alpha=1.0)
PHASE13_BACKBONES = ("SASRec", "GRU4Rec", "BERT4Rec", "MBSTR", "MBHT", "PBAT")
PHASE13_ARGS = ("--tasks", "smb_dis", "--max_his_len", "20", "--batch_size", "256",
                "--learning_rate", "1e-3", "--optim", "adamw")
REC_LOSS_TOL, REC_GRAD_TOL = 1e-5, 1e-4  # phase 13's fp32 step, card vs CPU


def _rel_max(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / float(want.double().abs().max())


def grads_agree(got: dict, want: dict, tol: float, reference=None) -> tuple[float, dict]:
    """Hold grads `got` (name -> tensor) to `want`: max |got - want| / max
    |want| within `tol` for each parameter. Returns (the worst such error,
    {name: (got's, want's error against float64)} of the parameters held to
    the float64 reference instead).

    A parameter whose grad vanishes analytically (an attention's key bias:
    softmax ignores a shift common to all keys) holds float noise on both
    sides: it must stay under 1e-6 of the largest grad of all. A parameter
    whose fp32 grad is ill-conditioned (PBAT's covariance stream: sqrt(c)
    and 1/c amplify rounding where c is near its floor, so fp32 itself is
    off the exact grad by more than `tol`) is held to `reference()`, its
    float64 grads: `got`'s error against them within twice `want`'s."""
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    worst, over = 0.0, []
    for name, w in want.items():
        g = got[name].float().cpu()
        if float(w.abs().max()) < floor:
            assert float(g.abs().max()) < floor, f"{name}: grad {float(g.abs().max())} not ~0"
            continue
        err = _rel_max(g, w)
        if err > tol:
            over.append(name)
        else:
            worst = max(worst, err)
    held = {}
    if over:
        err = _rel_max(got[over[0]], want[over[0]])
        assert reference is not None, f"{over[0]}: grad err {err:.3e} > {tol}"
        ref = reference()
        for name in over:
            held[name] = (_rel_max(got[name], ref[name]), _rel_max(want[name], ref[name]))
            assert held[name][0] <= 2 * held[name][1], (
                f"{name}: grad err against float64 {held[name][0]:.3e} > 2 x the CPU's "
                f"{held[name][1]:.3e}")
    return worst, held


def random_rec_batch(B: int, L: int, his: int, n_items: int, n_users: int, seed: int) -> dict:
    """A right-padded train_SMB_rec batch: histories of 1..his items, their
    behaviors 1..3 (0 = pad), targets, negatives and user ids."""
    rng = np.random.default_rng(seed)
    seq_len = rng.integers(1, his + 1, B)
    real = np.arange(L)[None] < seq_len[:, None]
    return {"inputs": np.where(real, rng.integers(1, n_items + 1, (B, L)), 0).astype(np.int32),
            "behaviors": np.where(real, rng.integers(1, 4, (B, L)), 0).astype(np.int32),
            "seq_len": seq_len.astype(np.int32),
            "target": rng.integers(1, n_items + 1, B).astype(np.int32),
            "behavior": rng.integers(0, 3, B).astype(np.int32),
            "neg_item": rng.integers(1, n_items + 1, B).astype(np.int32),
            "uid": rng.integers(1, n_users + 1, B).astype(np.int32),
            "row_valid": np.ones(B, np.int32)}


def rec_step_on(backbone: str, out: str, where, batch: dict, n_items: int, n_users: int,
                seed: int = 0, dtype=None):
    """One training forward and backward of `out`'s saved `best` model on
    device `where` (fp32, or `dtype`): (loss, {name: grad on the CPU}). The
    masked-LM draws and the dropout seeds come from one CPU generator, the
    same on every device."""
    import torch

    from gamer_tpu_torch.core.device import to_device
    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR

    cfg = DisModelConfig.from_file(out)
    L = int(batch["inputs"].shape[1])
    model = TR.build_dis_model(backbone, cfg, n_items, L, cfg.n_behaviors, n_users, where)
    model.load_state_dict(torch.load(os.path.join(out, "best", "state.pt"), weights_only=True))
    model.to(dtype or torch.float32)
    loss = TR.make_dis_loss_fn(backbone, model, cfg)(
        {k: to_device(v, where) for k, v in batch.items()}, TR.step_generator(seed, 0))
    loss.backward()
    tables = [f"{n}.weight" for n, m in model.named_modules() if isinstance(m, torch.nn.Embedding)]
    return (float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            tables)


def rec_steps_agree(backbone: str, out: str, dev, batch: dict, n_items: int,
                    n_users: int) -> tuple:
    """`rec_step_on` on `dev` twice (the embedding tables' grads
    bit-identical), then against the CPU: the loss within REC_LOSS_TOL
    relative, the grads by `grads_agree` at REC_GRAD_TOL (float64 on the
    CPU as the reference where fp32 is ill-conditioned). Returns (card
    loss, CPU loss, loss rel diff, worst grad err, `grads_agree`'s
    float64-held parameters)."""
    import torch

    got = rec_step_on(backbone, out, dev, batch, n_items, n_users)
    again = rec_step_on(backbone, out, dev, batch, n_items, n_users)
    tables_reproduce(f"phase 13 {backbone} on the {dev.type}", got[1], again[1], got[2])
    want = rec_step_on(backbone, out, torch.device("cpu"), batch, n_items, n_users)
    rel = abs(got[0] - want[0]) / abs(want[0])
    assert np.isfinite(want[0]) and rel <= REC_LOSS_TOL, f"{backbone}: step loss rel diff {rel:.3e}"
    worst, held = grads_agree(got[1], want[1], REC_GRAD_TOL, lambda: rec_step_on(
        backbone, out, torch.device("cpu"), batch, n_items, n_users, dtype=torch.float64)[1])
    return got[0], want[0], rel, worst, held


@contextlib.contextmanager
def _recording_calls(counters: dict, cls):
    """While the block runs, record each call of the staged step class
    `cls` (`tasks/train_smb_rec.RecTrainStep`, `tasks/rqvae.RQVAEStep`: its
    host part, then its device part through `core/graphs.StagedGraphs`) as
    `_recording` records `Trainer.train_step`: its start time ("stamps"),
    its launches ("steps"), and a list a call of (captured, launches) for
    each run of its device part ("calls": an eager run, or the capture of
    its CUDA graph; a replay has none). "owner" is the last step object."""
    import torch

    rec = {"steps": [], "calls": [], "stamps": [], "owner": None}
    call0, part0 = cls.__call__, cls.device_part
    snapshot = lambda: {k: w.launches for k, w in counters.items()}

    def call(self, *args, **kwargs):
        before = snapshot()
        rec["stamps"].append(time.perf_counter())
        rec["calls"].append([])
        rec["owner"] = self
        out = call0(self, *args, **kwargs)
        rec["steps"].append({k: v - before[k] for k, v in snapshot().items()})
        return out

    def part(self, static):
        before = snapshot()
        out = part0(self, static)
        captured = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        rec["calls"][-1].append((captured, {k: v - before[k] for k, v in snapshot().items()}))
        return out

    cls.__call__, cls.device_part = call, part
    try:
        yield rec
    finally:
        cls.__call__, cls.device_part = call0, part0


def staged_step_launches(model, cuda: bool, names) -> dict:
    """Wrapper calls of one zoo or RQ-VAE training step, for each counter
    of `names`: K1 once a dropout site (`model.dropout_sites`: every site
    drops at a rate in (0, 1)), K2 once a site on the gradient's path (all
    but the RQ-VAE encoder's first, which drops the input embeddings), L1
    and L2 once (the update); none on the CPU."""
    from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE

    launches = {k: 0 for k in names}
    if cuda:
        sites = model.dropout_sites
        launches.update(hash_dropout_fwd=sites,
                        hash_dropout_bwd=sites - int(isinstance(model, RQVAE) and sites > 0),
                        **UPDATE_LAUNCHES)
    return launches


def staged_forms_agree(label: str, make, calls: list, cls, counters: dict, dev,
                       card: str) -> dict:
    """`calls` (each one step of a staged step object, `cls`) on `make(graphed)`
    (a fresh step object and its model, from the same state each time),
    compiled then eager (`graphed=False`): every run of the device part
    (the eager runs, the capture) launching exactly `staged_step_launches`,
    read as the change of the counts over it, nothing launched outside it,
    the compiled form one graph replayed by every call after the first;
    the outputs and every parameter and buffer bit-identical between the
    forms; a profiled extra call of each running the same kernels of the
    port by name and count. Prints each form's median step time (calls 2 on,
    each ending in a synchronize) and busy share (the profiled call's device
    time over that median). Returns {form: (the last step object, the model,
    {"ms", "prof"})}."""
    import torch

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    runs = {}
    for graphed in (True, False):
        form = "compiled" if graphed else "eager"
        step, model = make(graphed)
        expected = staged_step_launches(model, cuda, counters)
        outs, times = [], []
        with _recording_calls(counters, cls) as rec:
            for call in calls:
                sync()
                t = time.perf_counter()
                outs.append(call(step))
                sync()
                times.append(time.perf_counter() - t)
        replayed, captured = check_step_launches(f"{label} {form}", rec, expected)
        want = (len(calls) - 1, 1) if graphed and cuda else (0, 0)
        assert (replayed, captured, step.staged.graphs) == (*want, want[1]), (
            f"{label} {form}: replayed {replayed}, captured {captured}, graphs "
            f"{step.staged.graphs}, expected {want}")
        state = {n: t.detach().clone() for n, t in model.state_dict().items()}
        ms = float(np.median(times[1:])) * 1e3
        prof = _profiled_step(lambda: calls[-1](step)) if cuda else None
        runs[form] = (step, model, dict(outs=[o.cpu() for o in outs], state=state, ms=ms,
                                        prof=prof, expected=expected))
        busy = (f"; a profiled step {prof['device_ms']:.3f} ms of device kernels, "
                f"{100 * prof['device_ms'] / ms:.1f}% busy, {prof['launches']} kernels, the "
                f"port's {prof['ours']}" if prof else "")
        print(f"{label} {form}: {len(calls)} steps, {ms:.3f} ms a step (median of steps "
              f"2-{len(calls)}, host time to a synchronize; the first {times[0] * 1e3:.1f} ms); "
              f"launches at each run of the device part {expected}, captured "
              f"{[c for calls_ in rec['calls'] for c, _ in calls_]}{busy} (card {card})",
              flush=True)
    c, e = runs["compiled"][2], runs["eager"][2]
    same_out = sum(torch.equal(a, b) for a, b in zip(c["outs"], e["outs"]))
    same_state = [n for n in c["state"] if torch.equal(c["state"][n], e["state"][n])]
    print(f"{label} compiled vs eager: {same_out} of {len(calls)} step outputs and "
          f"{len(same_state)} of {len(c['state'])} parameters and buffers bit-identical "
          f"({c['outs'][0].tolist()})", flush=True)
    assert same_out == len(calls), f"{label}: the compiled step's outputs differ from eager"
    assert len(same_state) == len(c["state"]), f"{label}: the compiled step's state differs"
    if cuda:
        assert c["prof"]["ours"] == e["prof"]["ours"], (
            f"{label}: a replay does not run the eager step's kernels: {c['prof']['ours']} vs "
            f"{e['prof']['ours']}")
    return runs


REC_STAGED_STEPS = 5  # phase 13's compiled and eager steps a backbone


def rec_forms_agree(backbone: str, out: str, dev, card: str, counters: dict, batcher, train,
                    test, batch_size: int, n_items: int, n_users: int,
                    eval_batch_size: int = 128) -> None:
    """Phase 13, 4.: `REC_STAGED_STEPS` steps of `tasks/train_smb_rec.RecTrainStep`
    on the first training batches, compiled and eager, from `out`'s `best`
    (`staged_forms_agree`: outputs and parameters bit-identical, one graph,
    the launches at the capture, the replay's kernels); then `RecScorer`
    compiled (its capture, then a replay) and eager on the first test
    chunk, padded as the task pads it: the scores bit-identical, one graph."""
    import torch

    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR
    from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

    cfg = DisModelConfig.from_file(out)
    L = batcher.seq_len
    state = torch.load(os.path.join(out, "best", "state.pt"), weights_only=True)

    def make(graphed):
        model = TR.build_dis_model(backbone, cfg, n_items, L, cfg.n_behaviors, n_users, dev)
        model.load_state_dict(state)
        opt = make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-3,
                                             lr_scheduler_type="constant", warmup_ratio=0.0,
                                             max_grad_norm=0.0), model)
        return TR.RecTrainStep(backbone, model, cfg, opt, graphed), model

    n = min(REC_STAGED_STEPS, len(train) // batch_size)
    batches = [batcher.collate(train[i * batch_size:(i + 1) * batch_size]) for i in range(n)]
    calls = [lambda st, b=b, i=i: st(b, TR.step_generator(0, i)) for i, b in enumerate(batches)]
    runs = staged_forms_agree(f"phase 13 {backbone} step B={batch_size} L={L}", make, calls,
                              TR.RecTrainStep, counters, dev, card)
    model = runs["compiled"][1]
    chunk = list(test[:eval_batch_size])
    chunk += [chunk[0]] * (eval_batch_size - len(chunk))
    ev = batcher.collate(chunk)
    with _captures() as cap:
        compiled = TR.RecScorer(backbone, model, dev)
        scores = [compiled(ev) for _ in range(2)]
    eager = TR.RecScorer(backbone, model, dev, graphed=False)(ev)
    same = [torch.equal(s, eager) for s in scores]
    print(f"phase 13 {backbone} scorer B={eval_batch_size}: compiled (capture, replay) vs "
          f"eager bit-identical {same}; graphs {cap}", flush=True)
    assert all(same), f"{backbone}: the compiled scorer differs from eager"
    assert cap == ({"rec scorer": 1} if dev.type == "cuda" else {}), cap
    del runs, model


def rec_phase(dev, counters: dict, card: str, spec: dict = PHASE13_SPEC,
              backbones=PHASE13_BACKBONES, train_args=PHASE13_ARGS, cfg_overrides=None,
              extra_args=(), min_steps: int = 100, window: int = 20) -> None:
    """Phase 13: the discriminative zoo through `python -m gamer_tpu_torch
    train_SMB_rec` in process, on a synthetic dataset of phase 7's sizes
    with sequential signal (PHASE13_SPEC) at scripts/train_SMB_rec.sh's
    geometry (smb_dis, --max_his_len 20, batch 256, AdamW lr 1e-3), each
    backbone from its shipped config. Per backbone:
    1. one epoch and its per-behavior test; 2. `--only_test` on the saved
    `best`, whose metrics must equal step 1's within 1e-6; 3. one fp32
    training forward and backward of `best` on the card against the CPU on
    the first training batch (TF32 off, the same masked-LM draws and hash
    dropout seeds), loss within 1e-5 relative, every grad within 1e-4 of
    its largest (`rec_steps_agree`; where fp32 is ill-conditioned, within
    twice the CPU's error of a float64 reference); 4. `REC_STAGED_STEPS`
    steps of the compiled `RecTrainStep` (a CUDA graph) against as many
    eager ones (`graphed=False`) from `best`, and the compiled scorer
    against the eager one (`rec_forms_agree`: bit-identical, one graph
    each, K1/K2 once a dropout site and L1/L2 once at the capture, the
    replay's kernels those of the eager step; the step time and busy share
    of both forms printed). The fit's training step and scorer are
    compiled: one graph each, the warm-up and capture launching as step 4's,
    every later step replayed. Then SASRec's
    `--only_test` with `--test_task smb_dis_sample` (1000 sampled
    negatives) and one epoch of
    SASRec on smb_dis_neg with loss_type BPR (a config copy). Gates: finite
    losses at every step, the mean of the last `window` step losses below
    the mean of the first `window`, metrics in [0, 1], per-behavior test
    counts equal to the eval builder's rows, and no launch of kernels a-k,
    N1 or N2 in the phase (the zoo runs none, as in JAX). Prints per backbone the
    median step time (host collation included) and sequences/s, the fit's
    and the `--only_test` run's wall times and the peak device memory.
    `spec`, the arguments, `cfg_overrides` (applied to every config copy),
    `extra_args` (e.g. --device cpu) and the counts let a test run it tiny."""
    import shutil
    import tempfile

    import torch

    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.data.contract import DataFiles
    from gamer_tpu_torch.data.smb import SMBCorpus
    from gamer_tpu_torch.data.smb_dis import DisBatcher, SMBDisBuilder
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset
    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR
    from gamer_tpu_torch.tasks.train_smb_rec import MASKED_MODELS

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="phase13_", dir=here)
    data = os.path.join(root, "data")
    write_synthetic_dataset(data, "Synth", SyntheticSpec(**spec))
    cli = lambda argv: main([*argv, *extra_args])
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    before = {k: w.launches for k, w in counters.items()}
    none = {k: 0 for k in counters if k in QWEN_KERNELS}
    his = int(train_args[train_args.index("--max_his_len") + 1])
    batch_size = int(train_args[train_args.index("--batch_size") + 1])
    corpus = SMBCorpus(DataFiles(data, "Synth"))
    builder = SMBDisBuilder(corpus, his)
    test_rows = [len(builder.filter_by_behavior(builder.build_eval("test"), b))
                 for b in range(len(corpus.behavior_names))]
    ds = ["--dataset", "Synth", "--data_path", data]

    def config(backbone, **changes):
        path = os.path.join(root, "cfg", f"{backbone}{'-' if changes else ''}"
                            f"{'-'.join(map(str, changes.values()))}")
        DisModelConfig.from_file(os.path.join(here, "config", "dis-models", backbone)).replace(
            **(cfg_overrides or {}), **changes).save(path)
        return path

    def check_test(label, res):
        for b, name in enumerate(corpus.behavior_names):
            ms = res["test"][name]
            assert ms["count"] == test_rows[b], f"{label} {name}: {ms['count']} != {test_rows[b]}"
            assert all(0.0 <= v <= 1.0 for k, v in ms.items() if k != "count"), (label, ms)

    def fit(label, backbone, cfg_path, args):
        out = os.path.join(root, label)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with _recording_calls(counters, TR.RecTrainStep) as rec, _captures() as cap:
            t = time.perf_counter()
            res = cli(["train_SMB_rec", *ds, "--backbone", backbone, "--base_model", cfg_path,
                       *args, "--epochs", "1", "--output_dir", out,
                       "--result_dir", os.path.join(out, "results")])
            sync()
            fit_s = time.perf_counter() - t
        stamps = rec["stamps"]
        expected = staged_step_launches(rec["owner"].model, cuda, counters)
        replayed, captured = check_step_launches(f"phase 13 {label}", rec, expected)
        want = {"rec training step": 1, "rec scorer": 1} if cuda else {}
        assert cap == want and captured == int(cuda), f"{label}: graphs {cap}, captured {captured}"
        losses = res["losses"]
        assert len(losses) >= min_steps, f"{label}: only {len(losses)} training steps"
        assert np.isfinite(losses).all(), f"{label}: non-finite losses"
        first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
        assert last < first, f"{label}: the loss did not fall ({first} -> {last})"
        check_test(label, res)
        step_ms = float(np.median(np.diff(stamps))) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        print(f"phase 13 {label} {' '.join(args)}: {len(losses)} steps, loss mean of the first "
              f"{window} {first:.5f} -> last {window} {last:.5f}; compiled: graphs {cap}, "
              f"{replayed} steps replayed, launches at the warm-up and capture {expected}; "
              f"step {step_ms:.3f} ms median "
              f"with host collation ({batch_size / (step_ms / 1e3):.1f} sequences/s); fit "
              f"(epoch, valid and test evals) {fit_s:.2f} s; peak memory {peak:.3f} GiB "
              f"(card {card})", flush=True)
        return out, res

    try:
        for backbone in backbones:
            cfg_path = config(backbone)
            out, res = fit(backbone, backbone, cfg_path, train_args)
            print(f"phase 13 {backbone} test " + "; ".join(
                f"{name} ({ms['count']}): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in ms.items() if k != "count")
                for name, ms in res["test"].items()), flush=True)
            # 2. the saved best, reloaded: the same per-behavior metrics
            t = time.perf_counter()
            again = cli(["train_SMB_rec", *ds, "--backbone", backbone, "--base_model", cfg_path,
                         *train_args, "--only_test", "--output_dir", out,
                         "--result_dir", os.path.join(out, "results")])
            sync()
            eval_s = time.perf_counter() - t
            worst = max(abs(again["test"][n][m] - v) for n, ms in res["test"].items()
                        for m, v in ms.items())
            assert worst <= 1e-6, f"{backbone}: --only_test on best differs by {worst}"
            # 3. one fp32 step of best on the card against the CPU
            L = his + 1 if backbone == "MBHT" else his
            b = SMBDisBuilder(corpus, his, add_uid=backbone == "PBAT")
            train = b.build_train("base", 42)
            if backbone == "MBHT":
                train = [e for e in train
                         if int(e.target_behaviors[0]) == corpus.target_behavior_idx]
            masked = backbone in MASKED_MODELS
            batcher = DisBatcher.for_examples(
                train + b.build_eval("valid", append_mask_slot=masked)
                + b.build_eval("test", append_mask_slot=masked), seq_len=L)
            batch = batcher.collate(train[:batch_size])
            got, want, loss_rel, grad_err, held = rec_steps_agree(
                backbone, out, dev, batch, b.num_items, len(corpus.users))
            e64 = [max(e[i] for e in held.values()) if held else 0.0 for i in (0, 1)]
            print(f"phase 13 {backbone}: --only_test on best {eval_s:.2f} s wall (max metric "
                  f"diff {worst:.1e}); fp32 step B={len(batch['inputs'])} L={L}, {dev.type} vs "
                  f"cpu: loss {got:.7f} vs {want:.7f} (rel diff {loss_rel:.3e}, tol "
                  f"{REC_LOSS_TOL}), worst grad err {grad_err:.3e} (tol {REC_GRAD_TOL}); "
                  f"{len(held)} parameters over it held to float64 instead (worst error against "
                  f"it {e64[0]:.3e} on the {dev.type}, {e64[1]:.3e} on the cpu; tol 2x the "
                  f"cpu's){': ' + ', '.join(sorted(held)) if held else ''}", flush=True)
            # 4. the compiled step and scorer against their eager forms, from best
            rec_forms_agree(backbone, out, dev, card, counters, batcher, train, b.build_eval(
                "test", append_mask_slot=masked), batch_size, b.num_items, len(corpus.users))
            if backbone == "SASRec":
                t = time.perf_counter()
                sampled = cli(["train_SMB_rec", *ds, "--backbone", backbone, "--base_model",
                               cfg_path, *train_args, "--only_test", "--test_task",
                               "smb_dis_sample", "--output_dir", out,
                               "--result_dir", os.path.join(root, "sampled")])
                sync()
                check_test("SASRec sampled", sampled)
                print(f"phase 13 SASRec --test_task smb_dis_sample (1000 negatives): "
                      f"{time.perf_counter() - t:.2f} s wall; " + "; ".join(
                          f"{n} hit@10 {ms['hit@10']:.4f} ndcg@10 {ms['ndcg@10']:.4f}"
                          for n, ms in sampled["test"].items()), flush=True)

        # SASRec with BPR on the negative-sampling variant
        neg = list(train_args)
        neg[neg.index("--tasks") + 1] = "smb_dis_neg"
        fit("SASRec-BPR", "SASRec", config("SASRec", loss_type="BPR"), tuple(neg))
        moved = {k: w.launches - before[k] for k, w in counters.items()}
        print(f"phase 13 launches in the whole phase: {moved}", flush=True)
        moved = {k: n for k, n in moved.items() if k in QWEN_KERNELS}
        assert moved == none, f"phase 13 launched kernels {moved}: the zoo runs no Qwen kernel"
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 13 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


# --------------------------------------------------------------------------- phase 14

# phase 14: a. phase 11b's 4 fp32 steps (global batch 16 x 101 blocks, dropout
# 0.2); b. phase 5's bf16 step (B 64 x 101 blocks); c. phase 4's search
# (batch 128, 20 beams, 4096 items, prompts of 100 blocks) in fp32; the
# flagship widths, at data 1 x model 2
PHASE14 = dict(steps=PHASE11_STEPS, step16=dict(cfg=dict(dropout_rate=DROP_RATE),
                                                 geometry=(64, 101)),
               search=dict(cfg=dict(dtype="float32"),
                           geometry=(BEAM_BATCH, NUM_BEAMS, N_ITEMS, PROMPT_BLOCKS)),
               model=2)


class LaunchCounter:
    """A kernel's launches since `.launches` was last set, read from the
    port's counter `name` (`core/trace.py`, `launch.<kernel>`)."""

    def __init__(self, name: str):
        self.name, self.base = name, 0

    @property
    def launches(self) -> int:
        from gamer_tpu_torch.core import trace

        return trace.counter(self.name) - self.base

    @launches.setter
    def launches(self, n: int) -> None:
        from gamer_tpu_torch.core import trace

        self.base = trace.counter(self.name) - n


def kernel_counters() -> dict:
    """The launches of a-k, of the hash dropout's K1 and K2, of the
    optimizer update's L1 and L2 and of the q/k norm and RoPE's N1 and N2,
    by the name of the wrapper that launches each (`LaunchCounter`s)."""
    kernels = {"fused_mask_attention": "a", "fused_mask_attention_bwd": "b",
               "fused_moe_ffn": "h", "fused_moe_ffn_bwd": "i", "fused_ce_rows": "j",
               "fused_ce_rows_bwd": "k", "hash_dropout_fwd": "K1", "hash_dropout_bwd": "K2",
               "global_norm_sq": "L1", "apply_update": "L2", "qk_norm_rope_fwd": "N1",
               "qk_norm_rope_bwd": "N2"}
    return {name: LaunchCounter("launch." + k) for name, k in kernels.items()}


def model_collectives(cfg, n_model: int) -> int:
    """The model-group collectives of one training step (remat off, one
    update), as the design places them: the token table's lookup sums the
    ranks' rows (1); each sparse layer whose experts split sums the ranks'
    outputs forward and their input grads backward (2 each); the CE gathers
    (lse, target logit) forward and sums dh backward (2); the clip norm sums
    the split parameters' squares (1)."""
    split = cfg.total_experts % n_model == 0
    return 1 + 2 * len(cfg.sparse_layers) * split + 2 + 1


def _model_axis_config(overrides: dict, n_model: int):
    """The flagship config of `overrides` with its vocab padded to a
    multiple of lcm(128, n_model), as train_SMB_decoder pads it."""
    import math

    from gamer_tpu_torch.core.mesh import pad_to_multiple

    cfg = flagship_config(**overrides)
    return cfg.replace(padded_vocab_size=pad_to_multiple(cfg.vocab_size,
                                                         math.lcm(128, n_model)))


def model_axis_run(dev, spec: dict, ctx=None) -> dict:
    """Phase 14's runs in this process, sharded on `ctx`'s model axis (or
    whole without it): a. `mp_steps`; b. (sharded only) a warm-up and a
    timed bf16 `Trainer` step: its launches of a-k, its model-group
    collectives and their time; c. the search: codes and scores."""
    import torch

    from gamer_tpu_torch.core import trace
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    n_model = spec["model"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    shard = (lambda m: ctx.shard_params(m)) if ctx is not None else (lambda m: m)
    cfg = _model_axis_config(spec["steps"]["cfg"], n_model)
    out = {"steps": mp_steps(cfg, _mp_batches(cfg, *spec["steps"]["geometry"]), dev, ctx)}

    if ctx is not None:
        cfg = _model_axis_config(spec["step16"]["cfg"], n_model)
        model = shard(QwenFamilyModel(cfg, device=dev, seed=0))
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                          OptimizerConfig(learning_rate=5e-4, lr_scheduler_type="constant",
                                          total_steps=10), TrainLoopConfig(seed=0))
        B, blocks = spec["step16"]["geometry"]
        batch = make_batch(cfg, B, blocks)
        trainer.train_step(batch)  # warm-up
        sync()
        counters = kernel_counters()
        for w in counters.values():
            w.launches = 0
        # traced: each model-axis collective is a span timed between two synchronizes
        trace.enable()
        trace.reset()
        calls = trace.counter("all_reduce.model")
        t = time.perf_counter()
        loss = float(trainer.train_step(batch))
        sync()
        ms = (time.perf_counter() - t) * 1e3
        held = trace.snapshot()["spans"].get("all_reduce.model", {"n": 0, "mean_ms": 0.0})
        trace.disable()
        out["step16"] = dict(
            loss=loss, ms=ms, launches={k: w.launches for k, w in counters.items()},
            collectives=trace.counter("all_reduce.model") - calls,
            collective_ms=held["n"] * held["mean_ms"],
            expected=model_collectives(cfg, n_model), expected_launches=_train_step_launches(cfg),
            block=(tuple(model.embed_tokens.weight.shape), tuple(model.lm_table().shape),
                   tuple(model.layers[0].mlp.experts_gate.shape)))
        del trainer, model

    cfg = _model_axis_config(spec["search"]["cfg"], n_model)
    B, K, n_items, blocks = spec["search"]["geometry"]
    model = shard(QwenFamilyModel(cfg, device=dev, seed=0))
    trie, pbatch, beh_ids = make_trie_and_prompts(cfg, B, n_items, LEVELS, LEVEL_SIZE, blocks)
    search = make_beam_search_fn(model, trie, BeamSearchConfig(num_beams=K))
    t = time.perf_counter()
    codes, scores = search(pbatch, beh_ids)
    sync()
    out["search"] = dict(codes=codes.cpu(), scores=scores.float().cpu(),
                         s=time.perf_counter() - t, graphs=search.graphs)
    return out


def _model_axis_worker(out: str, device: str, spec_json: str) -> None:
    """A process of phase 14: joins its group, runs `model_axis_run` on a
    data 1 x model n mesh and saves the result as out/rank<r>.pt."""
    import torch

    from gamer_tpu_torch.core import distributed
    from gamer_tpu_torch.core.mesh import MeshContext, default_mesh

    spec = json.loads(spec_json)
    distributed.maybe_initialize(device=device)
    try:
        ctx = MeshContext(default_mesh(data=1, model=spec["model"]), device=device)
        res = model_axis_run(torch.device(device), spec, ctx)
        torch.save(res, os.path.join(out, f"rank{distributed.process_index()}.pt"))
    finally:
        distributed.shutdown()


def _local_kernel_times(dev, card: str) -> None:
    """Phase 14d: kernels h and i on a rank's experts (P 2 and 3 of the
    flagship's 5) and j and k on a rank's vocab rows (576 and 465 of 1041,
    the targets shifted by the rank's first row), bf16 at the flagship
    shapes, beside the whole-model shapes; CUDA events over 10 launches;
    each beside its plain version (i: autograd through h's; k: with the
    lse given, as the kernel takes it) and, for j and k, the library call
    (`matmul` + `logsumexp`, its backward for k)."""
    import torch

    from gamer_tpu_torch.ops import fused_ce as FC
    from gamer_tpu_torch.ops import fused_moe as FM

    g = torch.Generator(device=dev).manual_seed(14)
    rnd = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.05).bfloat16()
    T, D, F = 64 * 101, 256, 512
    for P in (5, 3, 2):
        xp, wgu, down, btab = rnd(P, T, D), rnd(P, D, 2 * F), rnd(P, F, D), rnd(P, 4, 2 * F)
        beh = torch.randint(0, 4, (P, T), generator=g, device=dev, dtype=torch.int32)
        gout = rnd(P, T, D)
        args = (xp, wgu, down, btab, beh)
        with torch.no_grad():
            fwd = _cuda_ms(lambda: FM.fused_moe_ffn(*args, DROP_SEED, "silu", DROP_RATE, True))
        bwd = _cuda_ms(lambda: FM.fused_moe_ffn_bwd(*args, gout, DROP_SEED, DROP_RATE, True))
        weights = wgu.numel() + down.numel() + btab.numel()  # phase 2 and 2b's counts
        hb = _bound_ms(2 * (xp.numel() + weights + gout.numel()) + 4 * beh.numel(),
                       2.0 * P * T * (D * 2 * F + F * D))
        ib = _bound_ms(2 * 2 * (xp.numel() + weights) + 2 * 2 * gout.numel() + 4 * beh.numel(),
                       2.0 * P * T * (3 * D * 2 * F + 2 * F * D))
        plain = _cuda_ms(lambda: FM.fused_moe_ffn_plain(*args, True, DROP_SEED, DROP_RATE),
                         iters=3)
        leaves = [t.clone().requires_grad_(True) for t in (xp, wgu, down, btab)]
        with torch.enable_grad():  # i's plain version: autograd through h's, as phase 2b
            pout = FM.fused_moe_ffn_plain(*leaves, beh, True, DROP_SEED, DROP_RATE)
        plain_bwd = _grad_ms(pout, leaves, gout, iters=3)
        del pout, leaves
        print(f"phase 14d MoE P={P} T={T} D={D} F={F} bf16: h {fwd:.4f} ms (bound "
              f"{hb[0]:.4f} ms by {hb[1]}, {100 * hb[0] / fwd:.1f}%; plain {plain:.4f} ms), "
              f"i {bwd:.4f} ms (bound {ib[0]:.4f} ms by {ib[1]}, {100 * ib[0] / bwd:.1f}%; "
              f"plain {plain_bwd:.4f} ms) (card {card})", flush=True)
    N, inv_t = 64 * 504, 1.0
    h = rnd(N, D)
    targets = torch.randint(0, 1041, (N,), generator=g, device=dev, dtype=torch.int32)
    valid = torch.ones(N, dtype=torch.int32, device=dev)
    for V, v0 in ((1041, 0), (576, 0), (465, 576)):
        table = rnd(V, D)
        shifted = targets - v0
        fwd = _cuda_ms(lambda: FC.ce_rows_fwd(h, table, shifted, valid, inv_t))
        _, lse = FC.ce_rows_fwd(h, table, shifted, valid, inv_t)
        gnll = torch.ones(N, device=dev)
        bwd = _cuda_ms(lambda: FC.fused_ce_rows_bwd(h, table, shifted, valid, lse, gnll, inv_t))
        jb = _bound_ms(2 * (h.numel() + table.numel()) + 4 * (2 * N) + 4 * (2 * N),
                       2.0 * N * V * D)
        kb = _bound_ms(2 * 2 * (h.numel() + table.numel()) + 4 * 4 * N, 3 * 2.0 * N * V * D)
        plain = _cuda_ms(lambda: FC.fused_ce_rows_plain(h, table, shifted, valid, inv_t),
                         iters=3)
        lib = _cuda_ms(lambda: torch.logsumexp((h @ table.T).float(), dim=-1))
        # k's library call: the backward of matmul + logsumexp - the target
        # logit (phase 2b's), the targets outside this block's rows masked
        leaves = [t.clone().requires_grad_(True) for t in (h, table)]
        inside = ((shifted >= 0) & (shifted < V)).float()
        with torch.enable_grad():
            logits = (leaves[0] @ leaves[1].T).float()
            lnll = torch.logsumexp(logits, dim=-1) - logits.gather(
                1, shifted.clamp(0, V - 1).long()[:, None])[:, 0] * inside
        lib_bwd = _grad_ms(lnll, leaves, gnll)
        del logits, lnll, leaves
        plain_bwd = _cuda_ms(lambda: FC.fused_ce_rows_bwd_lse_plain(h, table, shifted, valid,
                                                                     lse, gnll, inv_t), iters=3)
        print(f"phase 14d CE N={N} V={V} (targets shifted by {v0}) D={D} bf16: j {fwd:.4f} ms "
              f"(bound {jb[0]:.4f} ms by {jb[1]}, {100 * jb[0] / fwd:.1f}%; plain {plain:.4f} "
              f"ms, matmul+logsumexp {lib:.4f} ms), k {bwd:.4f} ms "
              f"(bound {kb[0]:.4f} ms by {kb[1]}, {100 * kb[0] / bwd:.1f}%; plain {plain_bwd:.4f} "
              f"ms, matmul+logsumexp backward {lib_bwd:.4f} ms) (card {card})", flush=True)


def model_axis_phase(dev, counters: dict, card: str, spec: dict = PHASE14) -> None:
    """Phase 14: the model axis (`core/mesh.py`): two gloo processes sharing
    the card at data 1 x model 2, the flagship's experts split 3 / 3 (each
    rank's periodic pass over P 2 / 3 positions) and its padded vocab of
    1152 rows 576 / 576 (real 576 / 465), against this process with the
    whole model:
    a. `mp_steps` (phase 11b's steps): losses within 1e-5 relative, the
       gathered parameters within 1e-4 of their largest, the two ranks'
       (gathered and replicated) parameters bit-identical;
    b. one bf16 step at B 64 x S 505 on each rank: launches a 12, b 12,
       h 8, i 8, j 1, k 1, model-group collectives `model_collectives`
       (20); prints their time;
    c. the 20-beam search at phase 4's geometry (fp32): codes equal to one
       process's, scores within 1e-4;
    d. the kernels at the ranks' local shapes (CUDA only).
    `spec` lets a test run it tiny."""
    import shutil
    import tempfile

    import torch

    from gamer_tpu_torch.core import distributed

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="phase14_", dir=here)
    cuda = dev.type == "cuda"
    n = spec["model"]
    worker = [os.path.abspath(__file__), "--model-axis", root, "cuda" if cuda else "cpu",
              json.dumps(spec)]
    t = time.perf_counter()
    distributed.spawn_local([worker] * n, backend="gloo", timeout_s=MP_TIMEOUT_S)
    workers_s = time.perf_counter() - t
    res = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(n)]
    one = model_axis_run(dev, spec)

    # a. training steps against one process
    a, ref = res[0]["steps"], one["steps"]
    assert all(torch.equal(r["steps"]["params"], a["params"]) for r in res), (
        "the ranks' parameters differ")
    loss_rel = float(np.max(np.abs(np.subtract(a["losses"], ref["losses"]))
                            / np.abs(ref["losses"])))
    par_rel = float((a["params"] - ref["params"]).abs().max() / ref["params"].abs().max())
    rows, blocks = spec["steps"]["geometry"][1:]
    print(f"phase 14a data 1 x model {n}, {n} gloo processes on one {dev.type}, fp32 B={rows} "
          f"S={blocks * 5} dropout {spec['steps']['cfg'].get('dropout_rate')}, "
          f"{len(ref['losses'])} SGD steps: losses {[round(x, 6) for x in a['losses']]} vs one "
          f"process {[round(x, 6) for x in ref['losses']]}, worst rel diff {loss_rel:.3e} (tol "
          f"1e-5); parameters rel err {par_rel:.3e} (tol 1e-4), bit-identical across the ranks; "
          f"steps {[round(x, 1) for x in a['step_ms']]} ms on rank 0, "
          f"{[round(x, 1) for x in ref['step_ms']]} ms one process (card {card})", flush=True)
    assert loss_rel <= 1e-5 and par_rel <= 1e-4, "the sharded steps differ from one process"

    # b. launches and collectives of a sharded bf16 step on each rank
    for r, rr in enumerate(res):
        st = rr["step16"]
        expected = st["expected_launches"] if cuda else {k: 0 for k in counters}
        print(f"phase 14b rank {r} bf16 B={spec['step16']['geometry'][0]} "
              f"S={spec['step16']['geometry'][1] * 5}: launches {st['launches']}; model-group "
              f"collectives {st['collectives']} (predicted {st['expected']}) taking "
              f"{st['collective_ms']:.3f} ms; step {st['ms']:.3f} ms host time, loss "
              f"{st['loss']:.6f}; token table block, tied head, layer 0 experts "
              f"{st['block']} (card {card})", flush=True)
        assert st["launches"] == expected, f"rank {r}: launches {st['launches']} != {expected}"
        assert st["collectives"] == st["expected"], (
            f"rank {r}: {st['collectives']} model-group collectives, predicted {st['expected']}")

    # c. the search on the sharded parameters against one process
    c, ref = res[0]["search"], one["search"]
    B, K = spec["search"]["geometry"][:2]
    same = all(torch.equal(r["search"]["codes"], ref["codes"]) for r in res)
    worst = max(float((r["search"]["scores"] - ref["scores"]).abs().max()) for r in res)
    print(f"phase 14c search B={B} beams={K} {spec['search']['cfg'].get('dtype')}: codes equal "
          f"to one process's on every rank: {same}; worst score diff {worst:.3e} (tol 1e-4); "
          f"{c['s']:.3f} s on rank 0, {ref['s']:.3f} s one process (card {card})", flush=True)
    assert same and worst <= 1e-4, "the sharded search differs from one process's"
    assert [r["search"]["graphs"] for r in res] == [0] * n, (
        "a search under a live model axis was captured: its forward holds the model group's "
        "collectives, which time themselves on the host, so it stays eager")
    if cuda:
        _local_kernel_times(dev, card)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 14 wall time {time.perf_counter() - t_phase:.1f} s ({workers_s:.1f} s in the "
          f"{n} processes)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gamer_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {len(logs)} libraries compiled in {time.perf_counter() - t0:.1f} s", flush=True)
    tensor_core_counts()

    # 2. kernels against their plain versions
    entries = kernel_phase(dev)
    # 2b. backward kernels against autograd through the plain versions
    bwd_entries, long_s = backward_phase(dev)
    entries.update(bwd_entries)
    # 2c. the widths past the flagship's
    width_phase(dev, card)
    # 2d. the residual hash dropout's K1 and K2, bit for bit
    entries.update(dropout_phase(dev, card))
    # 2e. the optimizer update, kernel L, against its plain version
    entries.update(optimizer_phase(dev, card))
    # 2f. the q/k RMSNorm and RoPE's N1 and N2 against their plain version
    entries.update(qk_norm_rope_phase(dev, card))
    # 2g. MoeAction's grouped h and i against one launch per level
    grouped_moe_phase(dev, card)

    # 3. the scoring forward through the compiled and the eager eval step
    counters = kernel_counters()
    eval_phase(dev, counters, card)
    # 4. the constrained beam search at serving geometry, compiled and eager
    search_phase(dev, counters, card)

    # 5. training steps; 6. the long-history step
    train = train_phase(dev, counters, card)
    long_launches = long_phase(dev, counters)
    # 7. the task pipeline through the CLI
    task_phase(dev, counters, card, train["step_ms"])
    # 8. the multi- and single-behavior pipelines through the CLI
    seq_phase(dev, counters, card)
    # 9. the remat policies and the memory estimate
    remat_phase(dev, counters, card)
    # 10. the enc-dec pipelines through the CLI
    encdec_phase(dev, counters, card)
    # 11. data parallelism: a one-process NCCL group, two processes on gloo
    multiprocess_phase(dev, counters, card)
    # 12. the item-tokenizer chain, then the decoder on its semantic IDs
    tokenizer_phase(dev, counters, card)
    # 13. the discriminative zoo through train_SMB_rec
    rec_phase(dev, counters, card)
    # 14. the model axis: two gloo processes, experts and vocab split
    model_axis_phase(dev, counters, card)

    csrc, tpu = "gamer_tpu_torch/ops/csrc/", "gamer_tpu/ops/"
    attn_fwd, attn_bwd = csrc + "fused_attention_fwd.cu", csrc + "fused_attention_bwd.cu"
    sources = {"fused_mask_attention": (attn_fwd, tpu + "pallas_attention.py:136"),
               "fused_mask_attention_bwd": (attn_bwd, tpu + "pallas_attention.py:171"),
               "fused_moe_ffn": (csrc + "fused_moe_fwd.cu", tpu + "pallas_moe.py:73"),
               "fused_moe_ffn_bwd": (csrc + "fused_moe_bwd.cu", tpu + "pallas_moe.py:88"),
               "fused_ce_rows": (csrc + "fused_ce_fwd.cu", tpu + "pallas_ce.py:53"),
               "fused_ce_rows_bwd": (csrc + "fused_ce_bwd.cu", tpu + "pallas_ce.py:67"),
               # XLA's fusion of the hash dropout into its residual add (no pallas_call)
               "hash_dropout_fwd": (csrc + "hash_dropout.cu",
                                    "gamer_tpu/modules/dropout.py:119-146"),
               "hash_dropout_bwd": (csrc + "hash_dropout.cu",
                                    "gamer_tpu/modules/dropout.py:119-146"),
               # XLA's fusion of the optax chain in the jitted step (no pallas_call)
               "global_norm_sq": (csrc + "fused_optimizer.cu", "gamer_tpu/train/state.py:90-95"),
               "apply_update": (csrc + "fused_optimizer.cu", "gamer_tpu/train/state.py:90-95"),
               # XLA's fusion of GQAAttention's q/k norm and RoPE (no pallas_call)
               "qk_norm_rope_fwd": (csrc + "qk_norm_rope.cu",
                                    "gamer_tpu/modules/layers.py:215-219"),
               "qk_norm_rope_bwd": (csrc + "qk_norm_rope.cu",
                                    "gamer_tpu/modules/layers.py:215-219")}
    row = lambda name, src, rep, n, e: dict(
        name=name, route="cuda", source=src, replaces=rep, launches=n,
        max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
        bound_by=e["bound_by"], library_ms=e["library_ms"])
    kernels = [row(name, src, rep, train["launches"][name], entries[name])
               for name, (src, rep) in sources.items()]
    # c-g: the TPU's long-S kernels, covered by a and b; launches from the
    # long-history steps, times at B 1 x S 2048 / 8192 of phase 2b
    short, xl = sorted(long_launches)
    for letter, fn, line, src, kind, S_run, S_time in (
            ("c", "_stream_fwd_kernel", 259, attn_fwd, "fused_mask_attention", short, 2048),
            ("d", "_stream_dq_kernel", 330, attn_bwd, "fused_mask_attention_bwd", short, 2048),
            ("e", "_stream_dkv_kernel", 387, attn_bwd, "fused_mask_attention_bwd", short, 2048),
            ("f", "_stream_fwd_kernel_xl", 465, attn_fwd, "fused_mask_attention", xl, 8192),
            ("g", "_stream_dq_kernel_xl", 536, attn_bwd, "fused_mask_attention_bwd", xl, 8192)):
        timing = long_s[(S_time, "bwd" if kind.endswith("bwd") else "fwd")]
        kernels.append(row(f"{kind}[{letter}: {fn}, launched at S={S_run}, timed at B=1 S={S_time}]",
                           src, f"{tpu}pallas_attention.py:{line}", long_launches[S_run][kind],
                           timing))
    print(f"total wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-steps"]:  # one process of phase 11b
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _mp_steps_worker(*sys.argv[2:5])
        sys.exit(0)
    if sys.argv[1:2] == ["--mp-eval"]:  # one process of phase 11c
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _mp_eval_worker(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--model-axis"]:  # one process of phase 14
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _model_axis_worker(*sys.argv[2:5])
        sys.exit(0)
    sys.exit(main())
