"""Share of the roofline of the attention cores (kernels a and b): the
bound of their forward and backward work at the traced micro-steps' shapes
(`harness/counts.attention_work`) over the device time of the `attn`
kernel group, in %."""

from portbench.harness import counts, manifest


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    t = run.trace.group_s(manifest.patterns("attn"))
    if t <= 0:
        return None
    bound = sum(counts.bound_s(*reversed(counts.attention_work(run.cfg, b)))
                for b in run.trace_batches)
    return 100.0 * bound / t
