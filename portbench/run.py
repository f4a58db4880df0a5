#!/usr/bin/env python3
"""Runs one benchmark cell of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Loads the cell (`BENCHMARK.json` and the files
`portbench/harness/manifest.py` lists), makes its inputs and weights from
`--seed`, warms up every shape the cell uses, measures for `--seconds`
seconds, then checks what the timed path produced against the plain
reference under `portbench/reference/` and prints one JSON line last: the
cell's end-to-end metrics (`--trace 0`) or its per-layer metrics and the
trace's breakdown (`--trace 1`), `correct` and the numbers it compared,
each with its limit. Exits non-zero and prints no result without CUDA, on
fewer cards than the cell asks for, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the build caches of the libraries the port may use, at fixed paths in the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".portbench_cache", _sub)

from portbench.harness import manifest, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gamer_tpu")


class Context:
    """What a driver gets: the cell, its seed and window, the device, the
    spans recorder and the start of its set-up on the host clock (by default
    the process's start)."""

    def __init__(self, cell: dict, seed: int, seconds: float, traced: bool, device: str,
                 start: float | None = None):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.cfg, self.mix, self.device = cell["config_values"], cell["mix"], device
        self.t0 = self._last = T0 if start is None else start
        self.spans = trace.Spans(traced)
        self.timings: dict[str, float] = {}

    def mark(self, phase: str) -> None:
        """Host seconds since the last mark, kept under `phase`."""
        now = time.perf_counter()
        self.timings[phase] = round(now - self._last, 3)
        self._last = now

    def setup_done(self) -> float:
        """Ends set-up: its objects leave the collector's generations, so a
        collection in the window scans only what the window makes."""
        gc.collect()
        gc.freeze()
        self.mark("warm-up")
        return time.perf_counter() - self.t0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: dict, seed: int, seconds: float, traced: bool, device: str, bench: dict,
            start: float | None = None) -> dict:
    """Runs `cell` (`manifest.cell`) and returns the result line's object
    (the CUDA check is `main`'s)."""
    cell_name = cell["name"]
    ctx = Context(cell, seed, seconds, traced, device, start)
    out = manifest.driver(cell["mix"]["driver"]).run(ctx)
    limits = cell["limits"]
    checks = {}
    for name, value in out["checks"].items():
        checks[name] = {"value": value, "limit": limits[name]}
    correct = all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    correct = correct and set(checks) == set(limits)
    if traced:
        metrics = {}
        for m in manifest.per_layer(bench, cell_name):
            value = manifest.reader(m["name"]).read(out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, cell_name)}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if traced and out["run"].trace is not None:
        tr = out["run"].trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    print(f"host seconds by phase: {ctx.timings}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = manifest.benchmark()
    cell = manifest.cell(args.workload, bench)
    import torch

    # one host thread for PyTorch's own CPU work, and set-up's objects frozen
    # (`Context.setup_done`): without both, calls of the batch-128 search
    # stalled by up to 60 ms
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; nothing of JAX or the JAX package may run",
              file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30)
    print(f"card: {card.stdout.strip() or card.stderr.strip()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
