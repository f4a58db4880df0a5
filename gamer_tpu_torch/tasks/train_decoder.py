"""train_decoder — single-behavior generative training.

The port's counterpart of `gamer_tpu/tasks/train_decoder.py` (ref:
SeqRec/tasks/train_decoder.py): the leave-two-out SeqRec data, the model
geometry derived from the dataset (`build_seq_model`), temperature CE,
AdamW and schedule, early stopping on the valid loss. The dtype, `--device`
and the training loop are those of the port's `train_SMB_decoder`
(`fit_and_save`): `--bf16` or, by default, bfloat16 on CUDA and float32 on
the CPU. The enc-dec backbones (TIGER, PBATransformer) train through the
same loop with their own batcher and loss (`fit_encdec`). Under a process
group each process trains on its stride-shard of the examples, as there.
"""

from __future__ import annotations

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.batching import DecoderBatcher
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.seq import SeqCorpus, SeqExampleBuilder
from gamer_tpu_torch.models.generative.encdec import EncDecModel
from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel, build_config
from gamer_tpu_torch.tasks.base import (
    Task, add_dataset_args, add_global_args, add_hf_train_args, add_ref_compat_args,
    resolve_hf_train_args, task_device)
from gamer_tpu_torch.tasks.test_decoder import seq_inter_type
from gamer_tpu_torch.tasks.train_smb_decoder import (
    ENCDEC_BACKBONES, _lcm, fit_and_save, fit_encdec, make_encdec_config, resolve_dtype)

logger = get_logger("tasks.train_decoder")


def build_seq_model(backbone: str, corpus: SeqCorpus, temperature: float,
                    model_max_length: int, dtype: str = "float32", device=None, seed: int = 0,
                    **overrides):
    """(model, cfg, family) of a backbone at the dataset's geometry (ref
    train_decoder.py:240-312): vocab, item length and behaviors from the
    corpus, then `overrides`; weights from `seed`. The enc-dec backbones give
    an `EncDecModel` and family "encdec", the rest a `QwenFamilyModel` and
    "decoder_only"."""
    if backbone in ENCDEC_BACKBONES:
        num_positions = overrides.pop("num_positions", corpus.sole_item_len)
        cfg = make_encdec_config(backbone, corpus, num_positions, None, temperature, dtype,
                                 **overrides)
        return EncDecModel(cfg, device=device, seed=seed), cfg, "encdec"
    derived = dict(
        vocab_size=corpus.vocab.vocab_size,
        num_positions=corpus.sole_item_len,
        num_experts=corpus.sole_item_len + 1,
        num_behavior=max(len(corpus.behavior_names), 0),
        behavior_base=corpus.vocab.behavior_base,
        temperature=temperature,
        dtype=dtype,
        model_max_length=model_max_length,
    )
    derived.update(overrides)
    cfg = build_config(backbone, **derived)
    return QwenFamilyModel(cfg, device=device, seed=seed), cfg, "decoder_only"


def layer_overrides(backbone: str, n_layers: int, hidden_size: int) -> dict:
    """--n_layers / --hidden_size in the backbone family's field names."""
    encdec = backbone in ENCDEC_BACKBONES
    out = {}
    if n_layers:
        out.update({"num_layers": n_layers, "num_decoder_layers": n_layers} if encdec
                   else {"num_hidden_layers": n_layers})
    if hidden_size:
        out["d_model" if encdec else "hidden_size"] = hidden_size
    return out


def fit_seq_model(task: Task, model, cfg, family: str, vocab, train, valid, hf: dict,
                  pad_multiple: int, **fit_kw) -> dict:
    """Trains a `build_seq_model` model on seq/MB examples: the decoder loop
    (`fit_and_save`, one sequence length for train and valid) or the enc-dec
    one (`fit_encdec`)."""
    if family == "encdec":
        return fit_encdec(task, cfg, vocab, train, valid, hf, model.device, model=model,
                          **fit_kw)
    seq_len = DecoderBatcher.for_examples(train + valid, pad_multiple=pad_multiple).seq_len
    return fit_and_save(task, model, cfg, vocab, train, valid, seq_len, hf, **fit_kw)


@TASKS.register("train_decoder")
class TrainDecoder(Task):
    name = "train_decoder"
    help = "Train a single-behavior generative decoder."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("training")
        g.add_argument("--inter_type", type=str, default=None)
        g.add_argument("--epochs", type=int, default=200)
        g.add_argument("--batch_size", type=int, default=256)
        g.add_argument("--learning_rate", "--lr", type=float, default=5e-4)
        g.add_argument("--weight_decay", type=float, default=0.01)
        g.add_argument("--warmup_ratio", type=float, default=0.04)
        g.add_argument("--temperature", type=float, default=1.0)
        g.add_argument("--patience", type=int, default=20)
        g.add_argument("--model_max_length", type=int, default=1024)
        g.add_argument("--n_layers", type=int, default=0)
        g.add_argument("--hidden_size", type=int, default=0)
        g.add_argument("--lr_scheduler_type", type=str, default="cosine")
        g.add_argument("--resume_from_checkpoint", action="store_true",
                       help="resume params/optimizer/epoch from output_dir")
        g.add_argument("--wandb_run_name", type=str, default=None,
                       help="run name in the metric stream (ref wandb name)")
        add_ref_compat_args(parser, "deepspeed")
        add_hf_train_args(parser)
        return parser

    def run(self, *, dataset, data_path, index_file, max_his_len, backbone, output_dir, seed,
            inter_type, epochs, batch_size, learning_rate, weight_decay, warmup_ratio,
            temperature, patience, model_max_length, tasks="seqrec", n_layers=0,
            hidden_size=0, lr_scheduler_type="cosine", resume_from_checkpoint=False,
            wandb_run_name=None, device="cuda", **extra):
        dev = task_device(device)
        hf = resolve_hf_train_args(extra, batch_size=batch_size)
        corpus = SeqCorpus(DataFiles(data_path, dataset), index_file, multi_behavior=False,
                           inter_type=seq_inter_type(tasks, inter_type))
        builder = SeqExampleBuilder(corpus, max_his_len)
        train, valid = builder.build("train"), builder.build("valid")
        logger.info("seq train=%d valid=%d", len(train), len(valid))

        model, cfg, family = build_seq_model(
            backbone, corpus, temperature, model_max_length, resolve_dtype(hf, dev), dev, seed,
            **layer_overrides(backbone, n_layers, hidden_size))
        return fit_seq_model(
            self, model, cfg, family, corpus.vocab, train, valid, hf,
            _lcm(corpus.sole_item_len, 8), epochs=epochs, patience=patience, seed=seed,
            learning_rate=learning_rate, weight_decay=weight_decay, warmup_ratio=warmup_ratio,
            lr_scheduler_type=lr_scheduler_type, output_dir=output_dir,
            resume=resume_from_checkpoint, run_name=wandb_run_name)
