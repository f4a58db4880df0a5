"""Device time a traced micro-step in operations that match none of the
port's kernel groups (`portbench/kernels/*`): PyTorch's own kernels and
cuBLAS, in ms."""

from portbench.harness import manifest


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ours = [p for g in manifest.groups() for p in manifest.patterns(g)]
    return 1e3 * run.trace.group_s(ours, invert=True) / run.trace.steps
