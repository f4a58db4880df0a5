"""CLI of the port: one subcommand per task.

    python -m gamer_tpu_torch train_SMB_decoder --dataset ... --data_path ... [--device cpu]

The counterpart of the JAX package's `main.py` for the tasks the port has
(`tasks/__init__.py`). Every task runs on CUDA unless `--device cpu` is
given, and raises without CUDA otherwise.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    """Parse `argv` (default: the command line) and run the task; returns
    the task's result."""
    from gamer_tpu_torch.tasks import task_list

    parser = argparse.ArgumentParser("gamer_tpu_torch",
                                     description="GAMER on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="task", required=True)
    for cls in task_list.values():
        cls.add_parser(sub)
    args = vars(parser.parse_args(argv))
    task_cls = task_list[args.pop("task")]
    return task_cls().invoke(**args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
