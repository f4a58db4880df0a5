"""Chosen phases of a tree's `chip_smoke.py`, for a quick or A/B chip run.

    python3 scripts/smoke_phases.py <tree> <phase> [<phase> ...]   # on one GPU

Imports `chip_smoke.py` and `gamer_tpu_torch` from `<tree>` (a checkout,
e.g. a `git archive` of another commit unpacked into a git-ignored
directory), builds its kernel libraries and runs the named phases with the
launch counters and TF32 off as the script does: 2 (`kernel_phase`), 2b
(`backward_phase`), 2g (`grouped_moe_phase`), 2d (`dropout_phase`), 2e
(`optimizer_phase`), 2f (`qk_norm_rope_phase`), 3 (`eval_phase`), 4 (`search_phase`), 5
(`train_phase`), 7 (`task_phase`), 8 (`seq_phase`), 9 (`remat_phase`), 10
(`encdec_phase`), 11
(`multiprocess_phase`), 12 (`tokenizer_phase`), 13 (`rec_phase`), 14
(`model_axis_phase`), each where the tree has it. To
compare two commits on one card, run it for each tree in one call, in turns
(parent, change, change, parent). Raises (exit code != 0) if a phase fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree, phases = os.path.abspath(argv[0]), argv[1:]
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from gamer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"tree {argv[0]}: card {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    counters = cs.kernel_counters()
    dev = torch.device("cuda")
    step_ms = 0.0
    for phase in phases:
        t = time.perf_counter()
        if phase == "2":
            cs.kernel_phase(dev)
        elif phase == "2b":
            cs.backward_phase(dev)
        elif phase == "2g":
            cs.grouped_moe_phase(dev, card)
        elif phase == "2d":
            cs.dropout_phase(dev, card)
        elif phase == "2e":
            cs.optimizer_phase(dev, card)
        elif phase == "2f":
            cs.qk_norm_rope_phase(dev, card)
        elif phase == "3":
            cs.eval_phase(dev, counters, card)
        elif phase == "4":
            cs.search_phase(dev, counters, card)
        elif phase == "5":
            step_ms = cs.train_phase(dev, counters, card)["step_ms"]
        elif phase == "7":
            cs.task_phase(dev, counters, card, step_ms)
        elif phase == "8":
            cs.seq_phase(dev, counters, card)
        elif phase == "9":
            cs.remat_phase(dev, counters, card)
        elif phase == "10":
            cs.encdec_phase(dev, counters, card)
        elif phase == "11":
            cs.multiprocess_phase(dev, counters, card)
        elif phase == "12":
            cs.tokenizer_phase(dev, counters, card)
        elif phase == "13":
            cs.rec_phase(dev, counters, card)
        elif phase == "14":
            cs.model_axis_phase(dev, counters, card)
        else:
            raise ValueError(f"unknown phase {phase!r}; one of 2, 2b, 2g, 2d, 2e, 2f, 3, 4, 5, 7, 8, "
                             "9, 10, 11, 12, 13, 14")
        print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
