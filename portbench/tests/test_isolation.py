"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port: top-level module names compared whole
(the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench.harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "gamer_tpu"}


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(manifest.BENCH, "**", "*.py"),
                                               recursive=True)))
def test_sources_import_no_jax(path):
    names = _imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "gamer_tpu_torch" not in names


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": manifest.ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after("import portbench.reference.model, portbench.reference.train, "
                          "portbench.reference.search")
    assert "gamer_tpu_torch" not in mods and not mods & FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole tiny run of a training and a search cell, as `run.main`
    checks it once the window has closed."""
    mods = _modules_after(
        "from portbench import run\nfrom portbench.harness import manifest\n"
        "from portbench.tests import tiny\nb = manifest.benchmark()\n"
        "for c in ('qwen3multi.train.h100', 'qwen3multi.search.b128'):\n"
        "    run.execute(tiny.cell(c), 5, 0.2, True, 'cpu', b)\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()")
    assert "gamer_tpu_torch" in mods and not mods & FORBIDDEN
