"""The manifest and the files it names parse, and the harness finds a new
cell by its files alone."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_parse(cell):
    c = manifest.cell(cell, BENCH)
    assert c["config_values"]["vocab_size"] > 0
    assert c["mix"]["driver"] in ("train", "search")
    assert manifest.driver(c["mix"]["driver"]).run
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())
    e2e = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2 and manifest.per_layer(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load(metric):
    assert callable(manifest.reader(metric).read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_against_source(config):
    """Every key that differs from the shipped config is listed in `reduced`."""
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    ours = manifest.config(config)
    src = entry["source"].split("/s2s-models/")[1].split("/")[0]
    with open(os.path.join(manifest.ROOT, "config", "s2s-models", src, "config.json")) as f:
        shipped = json.load(f)
    changed = {k for k, v in shipped.items() if ours.get(k) != v}
    assert changed == set(entry["reduced"])


def test_kernel_groups():
    assert {"attn", "moe", "ce", "dropout", "optimizer", "shared"} <= set(manifest.groups())
    assert manifest.matches("void attn_fwd_tc_kernel<64, true>(Params)", manifest.patterns("attn"))
    assert not manifest.matches("ampere_bf16_s16816gemm_bf16_128x64", manifest.patterns("moe"))


def test_new_cell_is_found_by_its_files(tmp_path):
    """A copy with one more cell, added as files and a manifest entry only."""
    root = tmp_path / "co"
    shutil.copytree(manifest.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "qwen3multi.search.b64", "config": "qwen3multi",
                               "traffic": "search.b64", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen3multi.search.b128" in m.get("workloads", ()):
            m["workloads"].append("qwen3multi.search.b64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "portbench/traffic/mixes/search.b128.json").read_text())
    (root / "portbench/traffic/mixes/search.b64.json").write_text(json.dumps({**mix, "batch": 64}))
    shutil.copy(root / "portbench/workloads/qwen3multi.search.b128.json",
                root / "portbench/workloads/qwen3multi.search.b64.json")
    code = ("from portbench.harness import manifest as m; c = m.cell('qwen3multi.search.b64'); "
            "print(c['mix']['batch'], [x['name'] for x in m.per_layer(m.benchmark(), c['name'])])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("64 ") and "mfu.search" in out.stdout
