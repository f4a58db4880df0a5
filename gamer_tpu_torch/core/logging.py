"""Process-aware logging.

The port's copy of `gamer_tpu/core/logging.py`: per-task log files under
logs/<task>/<timestamp>.log and rank-0 filtering. The process index is the
rank in the process group (`core/distributed.py`) once one exists, else
PROCESS_INDEX or 0. The metric stream is written by `core/metrics.py`.
Loggers live under "gamer_tpu_torch".
"""

from __future__ import annotations

import logging
import os
import sys
import time

import torch.distributed as dist

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"
_configured = False


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("PROCESS_INDEX", 0))


def setup_logging(task: str | None = None, log_dir: str = "logs", level: int = logging.INFO) -> None:
    """Configure root logging once: stderr + optional per-task file, rank 0 only writes."""
    global _configured
    root = logging.getLogger("gamer_tpu_torch")
    if _configured:
        return
    root.setLevel(level)
    is_primary = process_index() == 0

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    if not is_primary:
        handler.setLevel(logging.WARNING)
    root.addHandler(handler)

    if task is not None and is_primary:
        path = os.path.join(log_dir, task)
        os.makedirs(path, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        fh = logging.FileHandler(os.path.join(path, f"{stamp}.log"))
        fh.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(fh)
    _configured = True


def get_logger(name: str = "gamer_tpu_torch") -> logging.Logger:
    if not name.startswith("gamer_tpu_torch"):
        name = f"gamer_tpu_torch.{name}"
    return logging.getLogger(name)
