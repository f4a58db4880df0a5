"""train_MB_decoder — multi-behavior (non-session) generative training.

The port's counterpart of `gamer_tpu/tasks/train_mb_decoder.py` (ref:
SeqRec/tasks/train_MB_decoder.py): the MB data with behavior tokens (and
`--filter_target`, which drops lower-level duplicates of the target from the
history, ref MB_dataset.py:107-110), ForDecoder augmentation, behavior
tokens masked from the loss. `config.json` records the token layout
(`behavior_first`, `explicit`). The dtype, `--device` and the training loop
are those of the port's `train_SMB_decoder` (`fit_and_save`; `fit_encdec`
for the enc-dec backbones, TIGER and PBATransformer), with their sharding
of the examples under a process group.
"""

from __future__ import annotations

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.seq import MBExampleBuilder, SeqCorpus
from gamer_tpu_torch.data.smb import TokenLayout
from gamer_tpu_torch.tasks.base import (
    Task, add_dataset_args, add_global_args, add_hf_train_args, add_ref_compat_args,
    resolve_hf_train_args, task_device)
from gamer_tpu_torch.tasks.train_decoder import build_seq_model, fit_seq_model, layer_overrides
from gamer_tpu_torch.tasks.train_smb_decoder import _lcm, resolve_dtype

logger = get_logger("tasks.train_mb_decoder")


def layout_for_mb_task(task: str) -> TokenLayout:
    t = task.lower()
    if t == "mb":
        return TokenLayout(explicit=False)
    if t.endswith("_back"):
        return TokenLayout(explicit=True, behavior_first=False)
    return TokenLayout(explicit=True, behavior_first=True)


def load_mb_train(dataset, data_path, max_his_len, index_file, tasks, filter_target):
    """ref loading_MB.py:18-69: mb | mb_explicit | mb_explicit_back |
    mb_explicit_decoder[_N]. Returns (corpus, layout, train, valid)."""
    task_list = tasks.split(",")
    corpus = SeqCorpus(DataFiles(data_path, dataset), index_file, multi_behavior=True)
    layout = layout_for_mb_task(task_list[0])
    train = []
    for task in task_list:
        t = task.lower()
        builder = MBExampleBuilder(corpus, layout, max_his_len, filter_target)
        if t in ("mb", "mb_explicit", "mb_explicit_back"):
            train.extend(builder.build("train"))
        elif t.startswith("mb_explicit_decoder"):
            augment = None if t == "mb_explicit_decoder" else int(t.split("_")[3])
            train.extend(builder.build_decoder_train(augment=augment))
        else:
            raise NotImplementedError(f"unknown MB train task {task!r}")
    valid = MBExampleBuilder(corpus, layout, max_his_len, filter_target).build("valid")
    return corpus, layout, train, valid


@TASKS.register("train_MB_decoder")
class TrainMBDecoder(Task):
    name = "train_MB_decoder"
    help = "Train a multi-behavior generative decoder."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("training")
        g.add_argument("--epochs", type=int, default=200)
        g.add_argument("--batch_size", type=int, default=256)
        g.add_argument("--learning_rate", "--lr", type=float, default=5e-4)
        g.add_argument("--weight_decay", type=float, default=0.01)
        g.add_argument("--warmup_ratio", type=float, default=0.04)
        g.add_argument("--temperature", type=float, default=1.0)
        g.add_argument("--patience", type=int, default=20)
        g.add_argument("--filter_target", action="store_true")
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

    def run(self, *, dataset, data_path, index_file, max_his_len, tasks, backbone,
            output_dir, seed, epochs, batch_size, learning_rate, weight_decay, warmup_ratio,
            temperature, patience, filter_target, model_max_length, n_layers=0,
            hidden_size=0, lr_scheduler_type="cosine", resume_from_checkpoint=False,
            wandb_run_name=None, device="cuda", **extra):
        dev = task_device(device)
        hf = resolve_hf_train_args(extra, batch_size=batch_size)
        corpus, layout, train, valid = load_mb_train(
            dataset, data_path, max_his_len, index_file, tasks, filter_target)
        logger.info("mb train=%d valid=%d", len(train), len(valid))
        tc = layout.token_count(corpus.sole_item_len)

        model, cfg, family = build_seq_model(
            backbone, corpus, temperature, model_max_length, resolve_dtype(hf, dev), dev, seed,
            num_positions=tc, num_experts=tc + 1,
            **layer_overrides(backbone, n_layers, hidden_size))
        cfg.extra["behavior_first"] = layout.behavior_first
        cfg.extra["explicit"] = layout.explicit
        return fit_seq_model(
            self, model, cfg, family, corpus.vocab, train, valid, hf, _lcm(tc, 8),
            epochs=epochs, patience=patience, seed=seed, learning_rate=learning_rate,
            weight_decay=weight_decay, warmup_ratio=warmup_ratio,
            lr_scheduler_type=lr_scheduler_type, output_dir=output_dir,
            resume=resume_from_checkpoint, run_name=wandb_run_name)
