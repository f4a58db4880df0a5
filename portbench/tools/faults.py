"""Faults planted in the port's timed path, for the tests that `correct`
comes out false under each, and for the readings its limits are set from
(`tools/readings.py`). A fault patches a class or factory of the port by a
`setattr(obj, attr, value)` it is given: pytest's `monkeypatch.setattr`,
or `patched`'s, which undoes it on leaving.

Training: the optimizer leaves the state unchanged; the loss covers half of
each micro-batch, the mean over the rest; the returned loss, a gradient or
an input token altered where it is produced. Search: half of the batch
searched and its answers repeated; a code or a score of the best beam
altered; valid beams, honestly scored, that are not the best (beams 21 to 40
of a 40-beam search in place of the first 20).
"""

from __future__ import annotations

import contextlib
import dataclasses


def _unchanged(setattr_):
    from gamer_tpu_torch.train.state import Optimizer

    setattr_(Optimizer, "apply", lambda self, grads: None)


def _half_batch(setattr_):
    import gamer_tpu_torch.tasks.train_smb_decoder as task

    make = task.make_loss_fn

    def halved(*args, **kwargs):
        loss_fn = make(*args, **kwargs)

        def half(batch, seeds):
            rows = batch["input_ids"].shape[0] // 2
            return loss_fn({k: v[:rows] for k, v in batch.items()}, seeds)
        return half

    setattr_(task, "make_loss_fn", halved)


def _loss_altered(setattr_):
    from gamer_tpu_torch.train.loop import Trainer

    step = Trainer.train_step
    setattr_(Trainer, "train_step", lambda self, batch: step(self, batch) * 1.1)


def _grad_altered(setattr_):
    from gamer_tpu_torch.train.state import Optimizer

    apply = Optimizer.apply
    setattr_(Optimizer, "apply", lambda self, grads: apply(
        self, {n: g * (1.5 if "q_proj" in n else 1.0) for n, g in grads.items()}))


def _token_altered(setattr_):
    from gamer_tpu_torch.train.loop import Trainer

    step = Trainer.train_step

    def altered(self, batch):
        batch = dict(batch, input_ids=batch["input_ids"].copy())
        batch["input_ids"][0, 1] += 1
        return step(self, batch)

    setattr_(Trainer, "train_step", altered)


def _search(wrap):
    """A fault that wraps the search object `make_beam_search_fn` returns:
    `wrap(make, model, trie, cfg)` returns the callable the window calls."""
    def plant(setattr_):
        import gamer_tpu_torch.decode.beam as beam

        make = beam.make_beam_search_fn
        setattr_(beam, "make_beam_search_fn",
                 lambda model, trie, cfg, *a, **k: wrap(lambda c: make(model, trie, c, *a, **k),
                                                        cfg))
    return plant


def _search_half(make, cfg):
    search = make(cfg)

    def half(batch, beh):
        rows = len(beh) // 2 or 1
        c, s = search({k: v[:rows] for k, v in batch.items()}, beh[:rows])
        reps = -(-len(beh) // rows)
        return c.repeat(reps, 1, 1)[:len(beh)], s.repeat(reps, 1)[:len(beh)]
    return half


def _search_code(make, cfg):
    search = make(cfg)

    def altered(batch, beh):
        c, s = search(batch, beh)
        c = c.clone()
        c[:, 0, -1] = (c[:, 0, -1] + 1) % 16
        return c, s
    return altered


def _search_score(make, cfg):
    search = make(cfg)

    def altered(batch, beh):
        c, s = search(batch, beh)
        s = s.clone()
        s[:, 0] += 0.5
        return c, s
    return altered


def _search_worse(make, cfg):
    K = cfg.num_beams
    search = make(dataclasses.replace(cfg, num_beams=2 * K))

    def worse(batch, beh):
        c, s = search(batch, beh)
        return c[:, K:], s[:, K:]
    return worse


TRAIN = {"state unchanged": _unchanged, "half the batch": _half_batch,
         "loss altered": _loss_altered, "gradient altered": _grad_altered,
         "token altered": _token_altered}
SEARCH = {"half the batch": _search(_search_half), "code altered": _search(_search_code),
          "score altered": _search(_search_score), "suboptimal beams": _search(_search_worse)}


def plant(driver: str, name: str, setattr_) -> None:
    (TRAIN if driver == "train" else SEARCH)[name](setattr_)


@contextlib.contextmanager
def patched(driver: str, name: str):
    undo = []

    def setattr_(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    plant(driver, name, setattr_)
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
