"""Metric stream writer.

The port's copy of `gamer_tpu/core/metrics.py`: each run appends JSONL events
to `<run_dir>/metrics.jsonl` (and writes `run_config.json` once), which
downstream tooling can tail. Under a process group only process 0 writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

from gamer_tpu_torch.core.logging import process_index


class MetricWriter:
    def __init__(self, run_dir: str, run_name: str | None = None,
                 config: Mapping[str, Any] | None = None):
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self.active = process_index() == 0
        if not self.active:
            return
        os.makedirs(run_dir, exist_ok=True)
        if config is not None:
            with open(os.path.join(run_dir, "run_config.json"), "w") as f:
                json.dump({"run_name": run_name, **dict(config)}, f, indent=2, default=str)

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        if not self.active:
            return
        event = {"_time": time.time()}
        if step is not None:
            event["_step"] = int(step)
        for k, v in metrics.items():
            event[k] = _to_py(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")

    def close(self) -> None:
        pass


def _to_py(v: Any) -> Any:
    import numpy as np

    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v
