"""Device time a traced step: every operation's time summed, in ms (for a
search call: the prefill and the decode steps)."""


def read(run):
    if run.trace is None:
        return None
    return 1e3 * sum(b - a for _, a, b in run.trace.ops) / 1e6 / run.trace.steps
