"""The card's idle share inside the traced steps, in %: 1 - the time in
which an operation ran / the steps' device time, each step from its first
operation's start to its last one's end (`harness/trace.Trace.step_idle`).
The gaps between a captured graph's kernels count as idle; the host's time
between steps, which the profiler lengthens, does not."""


def read(run):
    if run.trace is None:
        return None
    idle = run.trace.step_idle(run.step_span)
    return None if idle is None else 100.0 * idle
