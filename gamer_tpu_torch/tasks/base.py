"""Task base class + shared CLI argument groups.

The port's copy of `gamer_tpu/tasks/base.py`. It mirrors the reference's task
surface (ref: SeqRec/tasks/base.py:8-42, argument groups in
SeqRec/utils/parse.py:10-58) so scripts written against the reference CLI
translate directly. Argument capture for the metric stream is an explicit
`param_dict` recorded at invoke time.

One difference: the global `--device` (default "cuda") selects the device the
task runs on. The JAX package accepts it as an inert reference flag. There is
no silent CPU: without CUDA a task raises unless `--device cpu` is given.
`invoke` starts the process group when a rendezvous is configured
(`core/distributed.maybe_initialize`, as the JAX package's `main.py` does).
"""

from __future__ import annotations

import argparse
from typing import Any

import torch

from gamer_tpu_torch.core import distributed
from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.core.logging import get_logger, setup_logging

logger = get_logger("tasks")


class Task:
    """Subclass, set `name`, implement `add_args` + `run`."""

    name: str = ""
    help: str = ""

    @classmethod
    def add_parser(cls, sub_parsers) -> argparse.ArgumentParser:
        parser = sub_parsers.add_parser(cls.name, help=cls.help or cls.__doc__)
        cls.add_args(parser)
        return parser

    @classmethod
    def add_args(cls, parser: argparse.ArgumentParser) -> None:
        raise NotImplementedError

    def invoke(self, **args: Any) -> Any:
        # a configured rendezvous (core/distributed.py) starts the process
        # group first, so logging knows this process's rank
        distributed.maybe_initialize(device=args.get("device"))
        setup_logging(task=self.name)
        self.param_dict = {k: v for k, v in args.items() if not k.startswith("_")}
        logger.info("task %s args: %s", self.name, self.param_dict)
        for k in INERT_REF_FLAGS:
            if args.get(k) is not None:
                logger.warning(
                    "--%s is accepted for reference-CLI compatibility but has "
                    "no effect here", k)
        return self.run(**args)

    def run(self, **args: Any) -> Any:
        raise NotImplementedError


# reference flags that bind loader workers / GPU ids / deepspeed config —
# accepted so reference launch commands run unmodified; warned at invoke.
# (--device is a real flag here: `add_global_args`.)
INERT_REF_FLAGS = ("num_workers", "gpu_id", "deepspeed", "root")
_INERT_TYPES = {"num_workers": int, "gpu_id": int}


def add_ref_compat_args(parser: argparse.ArgumentParser,
                        *names: str) -> argparse.ArgumentParser:
    """Register inert reference flags (subset of INERT_REF_FLAGS) so the
    reference's launch commands are drop-in (ref e.g. RQVAE.py --device,
    tokenize.py --device, semantic_emb.py --gpu_id, train_*.py --deepspeed)."""
    g = parser.add_argument_group("reference-compat (accepted, no effect)")
    for n in names:
        g.add_argument(f"--{n}", type=_INERT_TYPES.get(n, str), default=None,
                       help="reference flag; no effect here")
    return parser


def add_global_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """ref utils/parse.py parse_global_args."""
    g = parser.add_argument_group("global")
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--backbone", type=str, default="Qwen3Multi")
    g.add_argument("--base_model", type=str, default=None,
                   help="model config dir (JSON); defaults to built-in preset")
    g.add_argument("--output_dir", type=str, default="./checkpoint")
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without CUDA) or cpu (the plain "
                        "PyTorch path, for tests)")
    return parser


def task_device(name: str | None) -> torch.device:
    """The device of `--device`: "cuda" requires CUDA (no silent CPU)."""
    return resolve_device(None if name in (None, "cuda") else name)


def add_hf_train_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference decoder trainers' HF-TrainingArguments surface
    (ref SeqRec/tasks/train_decoder.py:29-137, shared by train_MB_decoder and
    train_SMB_decoder): optimizer family, step-based logging/eval/save, the
    per-device-batch x accumulation batch spec, and the dtype switches."""
    g = parser.add_argument_group("hf-parity")
    g.add_argument("--optim", type=str, default="adamw_torch",
                   help="optimizer family (adamw/adam/sgd/adagrad/rmsprop; "
                        "'adamw_torch' = adamw)")
    g.add_argument("--logging_step", type=int, default=0,
                   help="metric-stream cadence in steps (0 = default 50)")
    g.add_argument("--save_and_eval_strategy", type=str, default="epoch",
                   choices=["epoch", "steps"])
    g.add_argument("--save_and_eval_steps", type=int, default=2000,
                   help="eval/save every N optimizer steps (steps strategy)")
    g.add_argument("--per_device_batch_size", type=int, default=0,
                   help="alias for --micro_batch_size (ref flag name)")
    g.add_argument("--gradient_accumulation_steps", type=int, default=0,
                   help="explicit accumulation; with --per_device_batch_size "
                        "this overrides the batch/micro derivation")
    g.add_argument("--bf16", action="store_true",
                   help="force bfloat16 compute (same as --dtype bfloat16)")
    g.add_argument("--fp16", action="store_true",
                   help="accepted for script parity; the kernels take no "
                        "fp16 — maps to bfloat16 with a warning")
    return parser


def resolve_hf_train_args(args: dict, *, batch_size: int,
                          micro_batch_size: int = 0,
                          dtype: str = "auto") -> dict:
    """Fold the HF-parity flags into (micro, accum, batch, dtype, loop kwargs).

    Batch spec precedence: the ref pair (--per_device_batch_size +
    --gradient_accumulation_steps) defines global batch = micro * accum when
    given; otherwise accum derives from --batch_size / --micro_batch_size.
    """
    micro = int(args.get("per_device_batch_size") or micro_batch_size or 0)
    accum = int(args.get("gradient_accumulation_steps") or 0)
    if micro and accum:
        batch_size = micro * accum
    elif micro:
        accum = max(batch_size // micro, 1)
    elif accum:
        micro = max(batch_size // accum, 1)
    else:
        micro = batch_size
        accum = 1
    if args.get("bf16"):
        if dtype not in ("auto", "bfloat16"):
            logger.warning("--bf16 overrides explicit --dtype %s -> bfloat16; "
                           "drop one of the flags to silence this", dtype)
        dtype = "bfloat16"
    if args.get("fp16"):
        if dtype not in ("auto", "bfloat16"):
            logger.warning("--fp16 overrides explicit --dtype %s -> bfloat16; "
                           "drop one of the flags to silence this", dtype)
        logger.warning("--fp16: the kernels take no fp16; using bfloat16")
        dtype = "bfloat16"
    loop_kwargs = {
        "eval_strategy": args.get("save_and_eval_strategy", "epoch"),
        "eval_every_steps": int(args.get("save_and_eval_steps") or 2000),
    }
    if args.get("logging_step"):
        loop_kwargs["log_every_steps"] = int(args["logging_step"])
    return {"micro": micro, "accum": accum, "batch_size": batch_size,
            "dtype": dtype, "optim": str(args.get("optim", "adamw_torch")),
            "loop_kwargs": loop_kwargs}


def add_dataset_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """ref utils/parse.py parse_dataset_args."""
    g = parser.add_argument_group("dataset")
    g.add_argument("--data_path", type=str, default="./data")
    g.add_argument("--dataset", type=str, default="Toy")
    g.add_argument("--tasks", type=str, default="smb_explicit_decoder_4")
    g.add_argument("--index_file", type=str, default=".index.json")
    g.add_argument("--max_his_len", type=int, default=20)
    return parser
