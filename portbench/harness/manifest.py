"""Finds what belongs to a cell by name, so that a cell, a configuration, a
traffic mix, a driver or a per-layer metric is added as files of its own:

  BENCHMARK.json                       the manifest (cells, metrics, bounds)
  portbench/workloads/<cell>.json      driver parameters of a cell: its
                                       check's sizes and the limits of `correct`
  portbench/configs/<config>.json      a model configuration as it is run
  portbench/traffic/mixes/<traffic>.json  a traffic mix: the generator's
                                       parameters and the driver that serves it
  portbench/drivers/<driver>.py        `run(ctx)`: set-up, window, check
  portbench/metrics/<metric>.py        a per-layer metric's reader, `read(run)`;
                                       else its family's, `<family>.py`
  portbench/kernels/<group>/*.txt      kernel-name patterns of a group, one
                                       per line; a group is their union
"""

from __future__ import annotations

import fnmatch
import glob
import importlib
import importlib.util
import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name: str) -> dict:
    return _json(os.path.join(BENCH, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH, "traffic", "mixes", f"{name}.json"))


def cell(name: str, bench: dict | None = None) -> dict:
    """A cell: its manifest entry, its own file, its config and traffic."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _json(os.path.join(BENCH, "workloads", f"{name}.json"))
    mix = traffic(entry["traffic"])
    return {**entry, **own, "config_values": config(entry["config"]), "mix": mix}


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str):
    """A per-layer metric's reader: `metrics/<metric>.py`, else its family's,
    `metrics/<metric up to its first dot>.py`."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(BENCH, "metrics", metric.split(".")[0] + ".py")
    name = os.path.basename(path)[:-3]
    return _load(path, "portbench_metric_" + re.sub(r"\W", "_", name))


def _listed(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _listed(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    a list that move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def patterns(group: str) -> list[str]:
    out = []
    for path in sorted(glob.glob(os.path.join(BENCH, "kernels", group, "*.txt"))):
        with open(path) as f:
            out += [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    return out


def groups() -> list[str]:
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(BENCH, "kernels", "*"))
                  if os.path.isdir(p))


def kernel_id(name: str) -> str:
    """The bare function name of a device operation's name."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def matches(name: str, pats: list[str]) -> bool:
    ident = kernel_id(name)
    return any(fnmatch.fnmatchcase(ident, p) for p in pats)
