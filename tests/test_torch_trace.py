"""The port's tracing module (`gamer_tpu_torch/core/trace.py`) on the CPU:
nothing recorded while it is off, a training step bit for bit the same
with device marks on and off, the marked sections of a step against its
host time, the gap arithmetic and span attribution on made-up timelines and
on a loop with a host sleep, a graph's marks read at its next replay, and
`GraphCache.run` keys that differ by `marking()` alone. The marks' event
nodes inside captured graphs exist only on the card (`scripts/trace_port.py`)."""

import time

import pytest
import torch

from gamer_tpu_torch.core import graphs, trace
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
from gamer_tpu_torch.train import loop as TL
from gamer_tpu_torch.train import state as TS
from tests.test_torch_qwen_family import make_batch, tiny_kwargs


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.set_marking(False)
    trace.reset()
    yield
    trace.disable()
    trace.set_marking(False)
    trace.reset()


def _trainer(backbone: str = "Qwen3Multi", impl: str = "jnp"):
    cfg = TQ.build_config(backbone, **tiny_kwargs(impl, dropout_rate=0.2))
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=0)
    trainer = TL.Trainer(make_loss_fn(model, deterministic=False), model,
                         TS.OptimizerConfig(learning_rate=3e-3, warmup_steps=1, total_steps=4),
                         TL.TrainLoopConfig(seed=0))
    return cfg, model, trainer


def test_off_records_nothing():
    assert not trace.enabled() and not trace.marking()
    x = torch.ones(3, requires_grad=True)
    assert trace.span("a") is trace.span("b") is trace.step("c", "cpu")
    with trace.span("a"), trace.step("c", "cpu"):
        trace.mark("m", "cpu")
        assert trace.boundary(x, "a", "b") is x
    trace.set_marking(True)  # marks need tracing on as well
    trace.mark("m", "cpu")
    assert trace.boundary(x, "a", "b") is x
    assert trace.snapshot() == {"spans": {}, "steps": {}, "sections": {}, "counters": {}}


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_marks_leave_the_training_step_bit_identical(impl):
    """Loss and every gradient of a training forward and backward (dropout
    0.2) with marks on equal those with marks off, bit for bit."""
    cfg, model, _ = _trainer(impl=impl)
    batch = make_batch(cfg, B=2)
    loss_fn = make_loss_fn(model, deterministic=False)

    def run():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(batch, torch.Generator().manual_seed(3))
        loss.backward()
        return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    loss0, grads0 = run()
    trace.enable()
    trace.set_marking(True)
    loss1, grads1 = run()
    assert trace.snapshot()["counters"] == {}  # no step: the marks fall in no section
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(grads0[n], grads1[n]) for n in grads0)


@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3MoeAction"])
def test_marked_sections_sum_to_the_step(backbone):
    """Two marked `Trainer` steps on the CPU: the sections plus `unmarked`
    sum to the steps' host time within 5%, each of self_attn, mlp and head
    is there forward and backward (cross_attn only where the model has it),
    and the step ran eagerly (counted as such)."""
    cfg, _, trainer = _trainer(backbone)
    batches = [make_batch(cfg, B=2, seed=s) for s in (0, 1)]
    trace.enable()
    trace.set_marking(True)
    for b in batches:
        trainer.train_step(b)
    snap = trace.snapshot()
    sec = snap["sections"]["train.step"]
    assert sec["steps"] == 2
    ms = sec["ms"]
    for name in ("self_attn", "mlp", "head", "embed"):
        assert ms[name] > 0 and ms[name + ".bwd"] > 0, (name, ms)
    assert ms["inputs"] > 0 and ms["update"] > 0 and trace.UNMARKED in ms
    assert ("cross_attn" in ms) == bool(cfg.cross_attention_layers)
    assert sum(ms.values()) == pytest.approx(snap["spans"]["train.step"]["mean_ms"], rel=0.05)
    assert snap["counters"]["graph.eager.training step"] == 2
    assert "training step: 0 captured, 0 replayed, " in trace.graph_summary()


def test_gaps_and_attribution_on_a_made_up_timeline():
    # three steps of one owner: gaps of 20 (host in "data.collate") and 0
    # (the card was still busy: the next step's start came before the end)
    steps = [(0, 100), (120, 200), (190, 300)]
    spans = [("train.step", 0, 50, 0), ("data.collate", 101, 119, 0),
             ("outer", 100, 125, 0), ("train.step", 119, 150, 0)]
    got = trace.gaps(steps, spans)
    assert got["share"] == pytest.approx(20 / 300)
    assert got["ms"] == pytest.approx(20e-6)
    assert got["by_span"] == {"data.collate": pytest.approx(20e-6)}
    # a gap no span covers
    got = trace.gaps([(0, 10), (30, 40)], [("x", 0, 10, 0)])
    assert got["by_span"] == {trace.OUTSIDE: pytest.approx(20e-6)} and got["share"] == 0.5
    assert trace.gaps([], [])["share"] == 0.0


def test_sections_on_a_made_up_timeline():
    # step 1: staging 0-10 unmarked, a 10-40, a.bwd 40-60, update 60-90,
    # closing mark at 90 -> unmarked to 100; step 2 has no marks
    marks = [(10, "a"), (40, "a.bwd"), (60, "update"), (90, trace.UNMARKED)]
    n, ns = trace.sections([(0, 100), (200, 300)], marks)
    assert n == 1
    assert ns == {trace.UNMARKED: 20, "a": 30, "a.bwd": 20, "update": 30}


def test_a_host_sleep_between_steps_reads_as_a_gap():
    trace.enable()
    with trace.step("loop", "cpu"):
        pass
    with trace.span("sleep"):
        time.sleep(0.01)
    with trace.step("loop", "cpu"):
        pass
    snap = trace.snapshot()
    got, slept = snap["steps"]["loop"], snap["spans"]["sleep"]["mean_ms"]
    assert got["n"] == 2 and slept >= 10
    # the gap is the sleep (however long the OS made it) and two calls' overhead
    assert slept <= got["gaps"]["ms"] < slept + 5
    assert list(got["gaps"]["by_span"]) == ["sleep"]
    assert got["gaps"]["share"] > 0.9


def test_spans_nest_and_keep_their_own_time():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            time.sleep(0.004)
    spans = trace.snapshot()["spans"]
    assert spans["outer"]["mean_ms"] >= spans["inner"]["mean_ms"] >= 4
    assert spans["outer"]["own_mean_ms"] < 1


def test_spans_show_on_an_active_profiler():
    """Under `torch.profiler` a span is also a `record_function` range of
    its name; without one it is not."""
    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("data.collate"):
            torch.ones(4).sum()
    assert "data.collate" in {e.name for e in prof.events()}
    assert trace.snapshot()["spans"]["data.collate"]["n"] == 1


class _Event:
    """A stand-in for a timing event: its time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


class _Graph:
    def __init__(self, marks=(), times=()):
        self.replays, self.marks, self.times = 0, marks, times

    def replay(self):
        if self.times:
            for (_, event), t in zip(self.marks, self.times[self.replays]):
                event.ms = t  # each replay rewrites its event nodes
        self.replays += 1


def test_a_graphs_marks_are_read_before_its_next_replay():
    trace.enable()
    trace._S.anchor = (_Event(0.0), 0)
    marks = [("a", _Event(0.0)), (trace.UNMARKED, _Event(0.0))]
    graph = _Graph(marks, [(1.0, 3.0), (11.0, 14.0)])
    trace.replay(graph, marks)
    trace.replay(graph, marks)
    trace._S.steps["g"] = [(0, 0, 0, 4_000_000), (0, 0, 10_000_000, 15_000_000)]
    snap = trace.snapshot()
    # step 1: unmarked 0-1, a 1-3, unmarked 3-4; step 2: 10-11, 11-14, 14-15
    assert snap["sections"]["g"] == {"steps": 2, "ms": {"a": 2.5, trace.UNMARKED: 2.0}}


def test_graph_keys_differ_by_marking_alone():
    """`GraphCache.run` looks a key up with `marking()`: the unmarked key
    replays the unmarked graph, the marked key its own graph, each counted
    as a replay."""
    cache = graphs.GraphCache("cpu", "probe")
    plain, marked = _Graph(), _Graph()
    cache._graphs[("k", False)] = (plain, torch.zeros(1), None, [])
    cache._graphs[("k", True)] = (marked, torch.ones(1), None, [])
    assert torch.equal(cache.run("k", None), torch.zeros(1))
    trace.enable()
    assert torch.equal(cache.run("k", None), torch.zeros(1))  # tracing alone marks nothing
    trace.set_marking(True)
    assert torch.equal(cache.run("k", None), torch.ones(1))
    assert (plain.replays, marked.replays) == (2, 1)
    assert trace.counter("graph.replay.probe") == 3
