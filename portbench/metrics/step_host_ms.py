"""Host time of a `Trainer.train_step` call until it returns, in ms: the
mean of the window's `train_step` spans (train loop, staging, graphs)."""


def read(run):
    t = run.spans.get("train_step")
    return 1e3 * sum(t) / len(t) if t else None
