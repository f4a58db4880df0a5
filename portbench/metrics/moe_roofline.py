"""Share of the roofline of the routed SwiGLU (kernels h and i): the bound
of its forward and backward work, one expert a token, at the traced
micro-steps' shapes (`harness/counts.moe_work`) over the device time of the
`moe` kernel group, in %."""

from portbench.harness import counts, manifest


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    t = run.trace.group_s(manifest.patterns("moe"))
    if t <= 0:
        return None
    bound = sum(counts.bound_s(*reversed(counts.moe_work(run.cfg, b)))
                for b in run.trace_batches)
    return 100.0 * bound / t
