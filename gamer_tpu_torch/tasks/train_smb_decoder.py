"""train_SMB_decoder: the flagship GAMER training pipeline.

PyTorch counterpart of `gamer_tpu/tasks/train_smb_decoder.py`:
`make_loss_fn` (the temperature-scaled causal-LM loss of a batch and its
valid-target count, either the training loss, dropout on and differentiable,
or the eval loss, dropout off and no grad), `parse_model_overrides`,
`make_model_config`, `fit_and_save` (the training loop the decoder tasks
share) and the `train_SMB_decoder` task for the Qwen3 family:
the SMB data with generative augmentation, one sequence length for train and
valid, the C++ example store (`native.ExampleStore`) feeding shuffled micro
batches, AdamW + schedule, early stopping on valid loss, and `config.json`,
`vocab.json` and the checkpoints (`best`, `last`, `last_state`) in
`--output_dir`, which `test_SMB_decoder` reads back.

Without `--gradient_checkpointing` (and no `remat` override), remat is
chosen from the geometry by `train/memory.auto_remat_overrides`: off when
the estimated remat-off step fits under 70% of the card's memory, else
policy "attn" (never on the CPU). The enc-dec backbones (TIGER,
PBATransformer) train through `_run_encdec`: `EncDecBatcher` batches, the
enc-dec CE (`models/generative/encdec_utils.py`), the same `Trainer`, and
`config.json` with family "encdec"; `--gradient_checkpointing` does not
apply to them (ignored with a warning, as in JAX).

Under a process group (`core/distributed.py`, started by `Task.invoke`)
each process stores its stride-shard of the examples and feeds
micro // process_count rows a step; `Trainer` sums the gradients, so the
step is the global batch's. `run(mesh_ctx=...)` (the library's way, as in
JAX; the CLI has no flag for it) takes a (data, model) mesh: with a model
axis above 1 the vocab table is padded to a multiple of lcm(128, n_model)
and split by rows, the experts split by expert (`core/mesh.shard_params`),
the examples shard over the data axis, and the remat choice sees
micro // n_data rows. JAX switches `moe_impl` to its einsum path there
(`pallas_call` has no partitioning rule); the port keeps kernels h and i,
each rank on its own experts: the same function. Differences: `--device`
picks the card (default) or the CPU; `--dtype auto` is bfloat16 on CUDA and
float32 on the CPU;
`--attention_impl auto` is the kernels and `jnp` the plain path;
`--profile_dir` writes a `torch.profiler` trace of five steps, with the
port's spans (`core/trace.py`) on for them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re

import torch

from gamer_tpu_torch.core import distributed, trace
from gamer_tpu_torch.core.device import to_device
from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.mesh import MeshContext, local_batch_size, pad_to_multiple
from gamer_tpu_torch.core.metrics import MetricWriter
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.batching import DecoderBatcher, EncDecBatcher, iterate_batches
from gamer_tpu_torch.data.loading_smb import load_smb_train
from gamer_tpu_torch.data.vocab import EOS_ID
from gamer_tpu_torch.models.generative.encdec import (
    EncDecConfig, EncDecModel, build_encdec_config)
from gamer_tpu_torch.models.generative.encdec_utils import encdec_loss_fn
from gamer_tpu_torch.models.generative.qwen_family import (
    QwenFamilyConfig, QwenFamilyModel, build_config, prepare_train_inputs)
from gamer_tpu_torch.modules.losses import (
    causal_lm_loss_with_denom, fused_causal_lm_loss_with_denom)
from gamer_tpu_torch.tasks.base import (
    Task, add_dataset_args, add_global_args, add_hf_train_args, add_ref_compat_args,
    resolve_hf_train_args, task_device)
from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
from gamer_tpu_torch.train.memory import auto_remat_overrides
from gamer_tpu_torch.train.state import OptimizerConfig, schedule_horizon

logger = get_logger("tasks.train_smb_decoder")

ENCDEC_BACKBONES = ("TIGER", "PBATransformer")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def parse_model_overrides(spec: str | None) -> dict:
    """'k=v,k2=v2' -> dict with JSON-parsed values ('cross_attention_layers=[]'
    -> {'cross_attention_layers': []}); unknown keys fail fast."""
    if not spec:
        return {}
    out = {}
    # split on commas not inside [...] so list values survive
    for part in re.split(r",(?![^\[]*\])", spec):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in QwenFamilyConfig.field_names():
            raise ValueError(f"unknown model override {k!r}")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def make_model_config(backbone: str, data, base_model: str | None,
                      temperature: float, model_max_length: int,
                      dtype: str = "float32", **overrides) -> QwenFamilyConfig:
    """Derive the model config from the dataset geometry, mirroring the
    config mutation in the reference task (ref train_SMB_decoder.py:275-382:
    vocab resize, num_positions/num_experts/behavior_maps injection)."""
    corpus = data.corpus
    tc = data.builder.tc
    derived = dict(
        vocab_size=corpus.vocab.vocab_size,
        num_positions=tc,
        num_experts=tc + 1,
        num_behavior=len(corpus.behavior_names),
        behavior_base=corpus.vocab.behavior_base,
        model_max_length=model_max_length,
        temperature=temperature,
        dtype=dtype,
    )
    if base_model:
        file_cfg = QwenFamilyConfig.from_file(base_model).to_dict()
        file_cfg.update(derived)
        file_cfg.update(overrides)
        return build_config(backbone, **{k: v for k, v in file_cfg.items()
                                         if k in QwenFamilyConfig.field_names()})
    derived.update(overrides)
    return build_config(backbone, **derived)


def use_fused_ce(cfg: QwenFamilyConfig) -> bool:
    """The fused tied-head CE applies when the head is tied and `ce_impl`
    is not "jnp"."""
    return cfg.tie_word_embeddings and cfg.ce_impl != "jnp"


def make_loss_fn(model: QwenFamilyModel, cfg: QwenFamilyConfig | None = None,
                 deterministic: bool = True):
    """Returns loss_fn(batch, generator=None) -> (loss, {"denom": valid-target
    count}).

    `deterministic=False` is the training loss: dropout on, its seeds drawn
    from `generator` (a CPU `torch.Generator`), differentiable in the
    model's parameters. `deterministic=True` is the eval loss: dropout off,
    no grad. `batch` holds [B, S] `input_ids`, `attention_mask`, `labels`
    (and, per preset, `session_ids`, `actions`, `extended_session_ids`,
    `row_valid`), as tensors or numpy arrays; they move to the model's
    device."""
    cfg = cfg or model.cfg
    fused = use_fused_ce(cfg)

    def loss_fn(batch: dict, generator: torch.Generator | None = None):
        with torch.set_grad_enabled(not deterministic and torch.is_grad_enabled()):
            return _loss(batch, generator)

    def _loss(batch: dict, generator):
        trace.mark("inputs", model.device)
        batch = {k: to_device(v, model.device) for k, v in batch.items()}
        inputs = prepare_train_inputs(cfg, batch)
        # under a process group the dropout masks are the global batch's
        rows = batch["input_ids"].shape[0]
        ctx = model.mesh_ctx
        row0 = 0 if deterministic else (ctx.first_row(rows) if ctx is not None
                                         else distributed.first_row(rows))
        out = model(**inputs, route_mode="periodic", return_hidden=fused,
                    deterministic=deterministic, generator=generator, row0=row0)
        if fused:
            table = model.lm_table().to(cfg.torch_dtype)
            block = model.vocab_block()
            loss, denom = fused_causal_lm_loss_with_denom(
                out["hidden"], table, batch["labels"], cfg.temperature, batch.get("row_valid"),
                vocab_shard=None if block is None else (block[0], model.model_axis))
        else:
            loss, denom = causal_lm_loss_with_denom(
                out["logits"], batch["labels"], cfg.temperature, batch.get("row_valid"))
        return trace.boundary(loss, "head", None), {"denom": denom}

    return loss_fn


@TASKS.register("train_SMB_decoder")
class TrainSMBDecoder(Task):
    name = "train_SMB_decoder"
    help = "Train a session-wise multi-behavior generative decoder."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("training")
        g.add_argument("--epochs", type=int, default=200)
        g.add_argument("--batch_size", type=int, default=1024)
        g.add_argument("--micro_batch_size", type=int, default=0,
                       help="per-step batch; 0 = batch_size (grad-accum = batch/micro)")
        g.add_argument("--learning_rate", "--lr", type=float, default=5e-4)
        g.add_argument("--weight_decay", type=float, default=0.01)
        g.add_argument("--warmup_ratio", type=float, default=0.04)
        g.add_argument("--lr_scheduler_type", type=str, default="cosine")
        g.add_argument("--temperature", type=float, default=1.0)
        g.add_argument("--patience", type=int, default=20)
        g.add_argument("--only_train_response", action="store_true")
        g.add_argument("--model_max_length", type=int, default=1024)
        g.add_argument("--dtype", type=str, default="auto",
                       choices=["auto", "float32", "bfloat16"],
                       help="auto = bfloat16 on CUDA, float32 on the CPU")
        g.add_argument("--attention_impl", type=str, default="auto",
                       choices=["auto", "jnp", "pallas"],
                       help="auto (or pallas) = the fused kernels, jnp = the plain path")
        g.add_argument("--resume_from_checkpoint", action="store_true",
                       help="resume params/optimizer/epoch from output_dir")
        g.add_argument("--save_epochs", type=int, default=0,
                       help="periodic epoch snapshots (keep newest 2)")
        g.add_argument("--profile_dir", type=str, default=None,
                       help="write a torch.profiler trace of five steps here")
        g.add_argument("--n_layers", type=int, default=0, help="override num layers (0=preset)")
        g.add_argument("--hidden_size", type=int, default=0, help="override hidden size")
        g.add_argument("--gradient_checkpointing",
                       action=argparse.BooleanOptionalAction, default=None,
                       help="recompute each layer in backward (ref HF "
                            "TrainingArguments gradient_checkpointing); unset = "
                            "chosen from a memory estimate (train/memory.py)")
        g.add_argument("--remat_policy", type=str, default="attn",
                       choices=["full", "attn", "dots"],
                       help="with --gradient_checkpointing: what the backward keeps "
                            "(full: nothing; attn: the attention outputs; dots: the "
                            "dense products)")
        g.add_argument("--wandb_run_name", type=str, default=None,
                       help="run name in the metric stream (ref wandb name)")
        g.add_argument("--model_overrides", type=str, default=None,
                       help="comma-separated k=v QwenFamilyConfig overrides "
                            "(values JSON-parsed), applied after the preset")
        add_ref_compat_args(parser, "deepspeed")
        add_hf_train_args(parser)
        return parser

    def run(self, *, dataset, data_path, tasks, index_file, max_his_len, backbone,
            base_model, output_dir, seed, epochs, batch_size, micro_batch_size,
            learning_rate, weight_decay, warmup_ratio, lr_scheduler_type,
            temperature, patience, only_train_response, model_max_length, dtype,
            device="cuda", n_layers=0, hidden_size=0, attention_impl="auto",
            resume_from_checkpoint=False, save_epochs=0, profile_dir=None,
            wandb_run_name=None, gradient_checkpointing=None,
            remat_policy="attn", model_overrides=None, mesh_ctx=None, **extra):
        dev = task_device(device)
        data = load_smb_train(dataset, data_path, max_his_len, index_file, tasks)
        corpus, builder = data.corpus, data.builder

        hf = resolve_hf_train_args(extra, batch_size=batch_size,
                                   micro_batch_size=micro_batch_size, dtype=dtype)
        dtype = resolve_dtype(hf, dev)
        fit_kw = dict(epochs=epochs, patience=patience, seed=seed, learning_rate=learning_rate,
                      weight_decay=weight_decay, warmup_ratio=warmup_ratio,
                      lr_scheduler_type=lr_scheduler_type, output_dir=output_dir,
                      resume=resume_from_checkpoint,
                      run_name=wandb_run_name or f"{dataset}-{backbone}")
        if backbone in ENCDEC_BACKBONES:
            # enc-dec backbones on SMB data (ref train_SMB_decoder.py:194-240)
            if gradient_checkpointing:
                logger.warning(
                    "--gradient_checkpointing is a qwen-family option; the enc-dec "
                    "backbones train at GAMER context lengths without remat (flag ignored)")
            overrides = {}
            if n_layers:
                overrides.update(num_layers=n_layers, num_decoder_layers=n_layers)
            if hidden_size:
                overrides["d_model"] = hidden_size
            cfg = make_encdec_config(backbone, corpus, builder.tc, base_model, temperature,
                                     dtype, **overrides)
            return fit_encdec(self, cfg, corpus.vocab, data.train, data.valid, hf, dev, **fit_kw)

        overrides = {"attention_impl": attention_impl}
        if gradient_checkpointing:
            overrides["remat"] = True
            overrides["remat_policy"] = remat_policy
        if n_layers:
            overrides["num_hidden_layers"] = n_layers
        if hidden_size:
            overrides["hidden_size"] = hidden_size
        overrides.update(parse_model_overrides(model_overrides))
        cfg = make_model_config(backbone, data, base_model, temperature,
                                model_max_length, dtype, **overrides)
        ctx = mesh_ctx or MeshContext(device=dev)
        if ctx.n_model > 1:
            # pad the vocab table so it row-shards evenly on the model axis;
            # logits stay [.., vocab_size]
            cfg = cfg.replace(padded_vocab_size=pad_to_multiple(
                cfg.vocab_size, _lcm(128, ctx.n_model)))
        # one sequence length across train+valid: the kernels see one shape
        batcher = DecoderBatcher.for_examples(
            data.train + data.valid, pad_multiple=_lcm(builder.tc, 8),
            behavior_token_ids=corpus.vocab.behavior_token_ids,
            only_train_response=only_train_response)
        if gradient_checkpointing is None and not cfg.remat:
            # no flag given: pick remat from the geometry (off when it fits)
            cfg = cfg.replace(**auto_remat_overrides(cfg, hf["micro"] // ctx.n_data,
                                                     batcher.seq_len, dev))
        model = ctx.shard_params(QwenFamilyModel(cfg, device=dev, seed=seed))
        logger.info("model %s on %s: vocab=%d seq_len=%d train=%d valid=%d parameters %.2fM",
                    backbone, dev, cfg.vocab_size, batcher.seq_len, len(data.train),
                    len(data.valid), sum(p.numel() for p in model.parameters()) / 1e6)
        return fit_and_save(
            self, model, cfg, corpus.vocab, data.train, data.valid, batcher.seq_len, hf,
            only_train_response=only_train_response, save_epochs=save_epochs,
            profile_dir=profile_dir, **fit_kw)


def resolve_dtype(hf: dict, dev: torch.device) -> str:
    """The compute dtype of a training task: --bf16/--fp16/--dtype, or for
    "auto" bfloat16 on CUDA and float32 on the CPU."""
    if hf["dtype"] != "auto":
        return hf["dtype"]
    return "bfloat16" if dev.type == "cuda" else "float32"


def fit_and_save(task: Task, model: QwenFamilyModel, cfg: QwenFamilyConfig, vocab, train, valid,
                 seq_len: int, hf: dict, *, only_train_response: bool = False, **fit_kw) -> dict:
    """The training loop of the decoder tasks (`_fit`): the C++ example store
    feeding shuffled micro batches of `seq_len` tokens, the causal-LM loss;
    `config.json` gets family "decoder_only". Returns `Trainer.fit`'s result."""
    # the C++ example store collates each field in one call (numpy where no
    # compiler exists); each process stores its stride-shard of the examples
    from gamer_tpu_torch import native

    ctx = model.mesh_ctx or MeshContext(device=model.device)
    micro, seed = local_batch_size(hf["micro"], ctx), fit_kw["seed"]
    stores = [native.ExampleStore(distributed.shard_examples(ex, group=ctx.data_group),
                                  vocab.behavior_token_ids,
                                  only_train_response=only_train_response)
              for ex in (train, valid)]
    return _fit(task, model, cfg, vocab, len(train), hf,
                make_loss_fn(model, cfg, deterministic=False),
                make_loss_fn(model, cfg, deterministic=True),
                lambda epoch: stores[0].iterate(micro, seq_len, shuffle=True, seed=seed + epoch),
                lambda: stores[1].iterate(micro, seq_len), "decoder_only", **fit_kw)


def local_micro(micro: int, device) -> int:
    """The rows a process feeds each micro-step: `micro` (the global micro
    batch) over the process group, which must divide it."""
    return local_batch_size(micro, MeshContext(device=device))


def make_encdec_config(backbone: str, corpus, num_positions: int, base_model: str | None,
                       temperature: float, dtype: str = "float32", **overrides) -> EncDecConfig:
    """An enc-dec config at the dataset's geometry (ref train_SMB_decoder.py
    :194-240, train_decoder.py:240-312): vocab, `num_positions` tokens an
    item block, behaviors, then `overrides`, over `base_model`'s config.json
    when given."""
    derived = dict(vocab_size=corpus.vocab.vocab_size, num_positions=num_positions,
                   num_experts=num_positions + 1,
                   num_behavior=max(len(corpus.behavior_names), 0),
                   behavior_base=corpus.vocab.behavior_base, temperature=temperature,
                   dtype=dtype)
    derived.update(overrides)
    if base_model:
        file_cfg = EncDecConfig.from_file(base_model).to_dict()
        file_cfg.update(derived)
        derived = {k: v for k, v in file_cfg.items() if k in EncDecConfig.field_names()}
    return build_encdec_config(backbone, **derived)


def fit_encdec(task: Task, cfg: EncDecConfig, vocab, train, valid, hf: dict, dev,
               model: EncDecModel | None = None, **fit_kw) -> dict:
    """Trains TIGER/PBATransformer (seq2seq: history -> target block) with
    `_fit`: `EncDecBatcher` batches of shuffled examples, the enc-dec CE;
    `config.json` gets family "encdec". `model` defaults to a new one on
    `dev`, weights from the seed. Returns `Trainer.fit`'s result."""
    model = model or EncDecModel(cfg, device=dev, seed=fit_kw["seed"])
    batcher = EncDecBatcher.for_examples(train + valid, eos_id=EOS_ID)
    micro, seed = local_micro(hf["micro"], model.device), fit_kw["seed"]
    ltrain, lvalid = distributed.shard_examples(train), distributed.shard_examples(valid)
    logger.info("model %s on %s: vocab=%d enc_len=%d dec_len=%d train=%d valid=%d "
                "parameters %.2fM", cfg.extra.get("backbone"), dev, cfg.vocab_size,
                batcher.enc_len, batcher.dec_len, len(train), len(valid),
                sum(p.numel() for p in model.parameters()) / 1e6)
    return _fit(task, model, cfg, vocab, len(train), hf,
                encdec_loss_fn(model, cfg, deterministic=False),
                encdec_loss_fn(model, cfg, deterministic=True),
                lambda epoch: iterate_batches(ltrain, micro, batcher.collate, shuffle=True,
                                              seed=seed + epoch),
                lambda: iterate_batches(lvalid, micro, batcher.collate), "encdec", **fit_kw)


def _fit(task: Task, model, cfg, vocab, n_train: int, hf: dict, loss_fn, eval_loss_fn,
         train_batches, eval_batches, family: str, *, epochs: int, patience: int, seed: int,
         learning_rate: float, weight_decay: float, warmup_ratio: float,
         lr_scheduler_type: str, output_dir: str, resume: bool = False,
         run_name: str | None = None, save_epochs: int = 0,
         profile_dir: str | None = None) -> dict:
    """The training loop the generative tasks share: the optimizer and
    schedule of `hf` (`resolve_hf_train_args`), `Trainer` with early stopping
    on the valid loss (`eval_loss_fn`, dropout off) and the checkpoints in
    `output_dir`; then `config.json` (with `cfg.extra` and `family`) and
    `vocab.json`, which the test tasks read back."""
    micro, accum = hf["micro"], hf["accum"]
    opt_cfg = OptimizerConfig(
        optim=hf["optim"], learning_rate=learning_rate, weight_decay=weight_decay,
        warmup_ratio=warmup_ratio, lr_scheduler_type=lr_scheduler_type,
        total_steps=schedule_horizon(n_train, micro, accum, epochs))
    loop_cfg = TrainLoopConfig(epochs=epochs, patience=patience, seed=seed,
                               gradient_accumulation_steps=accum,
                               snapshot_every_epochs=save_epochs, resume=resume,
                               **hf["loop_kwargs"])
    writer = MetricWriter(os.path.join("runs", task.name), run_name=run_name,
                          config=getattr(task, "param_dict", {}))
    trainer = Trainer(loss_fn, model, opt_cfg, loop_cfg, output_dir=output_dir,
                      metric_writer=writer, eval_loss_fn=eval_loss_fn)
    if profile_dir:
        _profile(trainer, train_batches(0), profile_dir, model.device)
    result = trainer.fit(train_batches, eval_batches)

    cfg.extra["family"] = family
    if distributed.is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        cfg.save(output_dir)
        vocab.save(os.path.join(output_dir, "vocab.json"))
    distributed.barrier()
    logger.info("done: best valid loss %.4f after %d steps", result["best_metric"],
                result["steps"])
    return result


def _profile(trainer: Trainer, batches, profile_dir: str, dev: torch.device) -> None:
    """A torch.profiler trace of five training steps (they train), with the
    port's spans (`core/trace.py`) on for them: `data.collate`,
    `train.step`, `stage.wait` appear on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    was_on = trace.enabled()
    trace.enable()
    try:
        with profile(activities=acts) as prof:
            for i, batch in enumerate(batches):
                trainer.train_step(batch)
                if i >= 4:
                    break
            if dev.type == "cuda":
                torch.cuda.synchronize()
    finally:
        if not was_on:
            trace.disable()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    logger.info("profiler trace written to %s", profile_dir)
