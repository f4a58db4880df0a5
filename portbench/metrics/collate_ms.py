"""Host time of the port's collation (`native.ExampleStore`) a micro-batch,
in ms: the mean of the window's `collate` spans (data plane)."""


def read(run):
    t = run.spans.get("collate")
    return 1e3 * sum(t) / len(t) if t else None
