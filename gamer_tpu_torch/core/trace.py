"""The port's spans, counters and device marks, on one clock.

Tracing is process-wide, like the logging setup, and off by default:
`enable()` turns it on, `disable()` off, `reset()` forgets what was
recorded, `snapshot()` reads it. While it is off
nothing is recorded: `span` and `step` return one shared no-op context
object (no generator, no allocation, no clock read), and `mark` and
`boundary` return at once.

- `span(name)`: a host span on `time.perf_counter_ns`. Spans nest (a
  stack); each also records its own time, less that of the spans nested in
  it. While a `torch.profiler` is active a span is also a
  `record_function` range, so a profile shows the port's spans on the
  profiler's own timeline.
- `step(owner, device)`: a span that, on the card, also records a timing
  event on the current stream at entry and at exit: the card's side of a
  call, from its first staging copy to its last output. The gaps between
  an owner's consecutive steps are the card's idle time between calls.
- `mark(label, device)`: a device mark, "from here on in stream order, the
  section `label`", placed only while `marking()` is on. On the card it is
  a timing event; recorded during a stream capture it is created with
  `external=True`, so it becomes an event-record node of the graph and
  every replay times its sections again without Python (`replay`). On the
  CPU it is a `perf_counter_ns` reading, exact there because CPU ops are
  synchronous.
- `boundary(x, before, after)`: the identity on a tensor between two
  sections of a differentiable forward. It marks `after` in the forward
  and, when the gradient reaches it, `before + ".bwd"` in the backward, so
  each section's backward lies between two marks in stream order too.
  Nothing is marked in a forward without grad, nor while a checkpointed
  stage is recomputed inside the backward.
- `count(name, n)`: counters, always on and never reset (`counter`,
  `counters` read their totals): `launch.<kernel>` (a, b, h, i, j, k, K1,
  K2, L1, L2, N1, N2), `graph.<capture|replay|eager>.<owner>` and
  `all_reduce.<flat|model>`.

One clock: `enable()` and `reset()` synchronize the card, record an anchor
event and read the host clock; a device event `e` is placed on the host
clock at `anchor_host + anchor.elapsed_time(e)`. Events are read only by
`snapshot()`, and a graph's marks just before that graph replays again
(each replay rewrites them): nothing synchronizes on the hot path.

`snapshot()` gives, by name, each span's count and mean time (its own time
too); by owner, its steps' host and device times, the gaps between them
(`gap_share`: their sum over the span from the first step's start to the
last one's end) and, for each gap, the innermost host span open while the
card sat idle; by owner, the marked steps' sections in device ms a step
(what lies outside every section is `unmarked`); and each counter's change
since the last `reset`.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

UNMARKED = "unmarked"
OUTSIDE = "outside spans"


class _State:
    def __init__(self):
        self.on = False
        self.marking = False
        self.counters: dict[str, int] = {}
        self.base: dict[str, int] = {}  # the counters at the last reset
        self.stack: list[list] = []  # open spans: [name, start, nested ns, record_function]
        self.clear()

    def clear(self) -> None:
        self.spans: list[tuple] = []  # (name, start, end, own ns)
        self.steps: dict[str, list] = defaultdict(list)  # owner: [(host a, host b, dev a, dev b)]
        self.marks: list[tuple] = []  # (label, ns or event)
        self.pending: dict[int, list] = {}  # a graph's marks, replayed and not yet read
        self.capture: list | None = None  # marks recorded by the capture under way
        self.anchor: tuple | None = None  # (event, host ns)


_S = _State()


def enabled() -> bool:
    return _S.on


def enable() -> None:
    _S.on = True
    _anchor()


def disable() -> None:
    _S.on = False


def reset() -> None:
    """Forgets every span, step and mark, takes the counters' totals as the
    base of `snapshot`'s, and anchors the clocks again."""
    _S.clear()
    _S.base = dict(_S.counters)
    if _S.on:
        _anchor()


def marking() -> bool:
    """Whether device marks are placed: tracing on and `set_marking(True)`."""
    return _S.on and _S.marking


def set_marking(on: bool) -> None:
    _S.marking = bool(on)


def _anchor() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        _S.anchor = (event, time.perf_counter_ns())


# ------------------------------------------------------------------ counters

def count(name: str, n: int = 1) -> None:
    _S.counters[name] = _S.counters.get(name, 0) + n


def counter(name: str) -> int:
    return _S.counters.get(name, 0)


def counters(prefix: str = "") -> dict[str, int]:
    """The counters whose names start with `prefix`, by the rest of their name."""
    return {k[len(prefix):]: v for k, v in _S.counters.items() if k.startswith(prefix)}


def graph_counts() -> dict[str, dict[str, int]]:
    """{owner: {"captured", "replayed", "eager"}} of the graph counters."""
    out: dict[str, dict[str, int]] = {}
    for what, key in (("capture", "captured"), ("replay", "replayed"), ("eager", "eager")):
        for owner, n in counters(f"graph.{what}.").items():
            out.setdefault(owner, {"captured": 0, "replayed": 0, "eager": 0})[key] = n
    return out


def graph_summary() -> str:
    """One line of `graph_counts`: "<owner>: c captured, r replayed, e eager; ..."."""
    return "; ".join(f"{owner}: {c['captured']} captured, {c['replayed']} replayed, "
                     f"{c['eager']} eager" for owner, c in sorted(graph_counts().items()))


# --------------------------------------------------------------------- spans

class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        _S.stack.append([self.name, time.perf_counter_ns(), 0, rf])
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        name, start, nested, rf = _S.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        if _S.stack:
            _S.stack[-1][2] += end - start
        _S.spans.append((name, start, end, end - start - nested))
        return False


def span(name: str):
    """A host span `name` (a context manager); the shared no-op when off."""
    return _Span(name) if _S.on else _NOOP


class _Step(_Span):
    __slots__ = ("cuda", "device", "start")

    def __init__(self, owner: str, device):
        super().__init__(owner)
        self.device = device
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        super().__enter__()
        self.start = self._now()
        return self

    def __exit__(self, *exc):
        end = self._now()
        host_start = _S.stack[-1][1]
        super().__exit__(*exc)
        _S.steps[self.name].append((host_start, _S.spans[-1][2], self.start, end))
        return False

    def _now(self):
        if not self.cuda:
            return time.perf_counter_ns()
        if _S.anchor is None:
            _anchor()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event


def step(owner: str, device):
    """A span `owner` that is also one step of `owner` on `device`'s clock
    (a timing event at entry and at exit on the card); the shared no-op
    when off."""
    return _Step(owner, device) if _S.on else _NOOP


# --------------------------------------------------------------------- marks

def mark(label: str, device, grad_only: bool = False) -> None:
    """From here on in stream order, the section `label` (while
    `marking()`; with `grad_only`, in a forward with grad only)."""
    if _S.on and _S.marking and (not grad_only or torch.is_grad_enabled()):
        _place(label, device)


def _place(label: str, device) -> None:
    if torch.device(device).type != "cuda":
        _S.marks.append((label, time.perf_counter_ns()))
        return
    stream = torch.cuda.current_stream(device)
    if torch.cuda.is_current_stream_capturing():
        if _S.capture is not None:  # a node of the graph, read at each replay
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record(stream)
            _S.capture.append((label, event))
        return
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    _S.marks.append((label, event))


class _Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, before, after):
        ctx.before, ctx.device = before, x.device
        if after is not None and torch._C._current_graph_task_id() == -1:
            _place(after, x.device)  # not a checkpointed stage's recompute
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.before is not None and _S.on and _S.marking:
            _place(ctx.before + ".bwd", ctx.device)
        return grad, None, None


def boundary(x: torch.Tensor, before: str | None, after: str | None) -> torch.Tensor:
    """`x`, between the sections `before` and `after` of a forward with
    grad: marks `after` here and `before + ".bwd"` where the backward
    reaches here (either None: no such mark). `x` itself while not
    `marking()` or without grad."""
    if not (_S.on and _S.marking) or not torch.is_grad_enabled():
        return x
    return _Boundary.apply(x, before, after)


def begin_capture() -> None:
    """Marks placed from here to `end_capture` become the capture's."""
    _S.capture = [] if marking() else None


def end_capture() -> list:
    """The marks of the capture begun by `begin_capture`."""
    marks, _S.capture = _S.capture or [], None
    return marks


def replay(graph, marks: list) -> None:
    """`graph.replay()`. A graph captured with `marks` has its previous
    replay's marks read first (each replay rewrites them)."""
    if marks:
        prev = _S.pending.pop(id(marks), None)
        if prev is not None:
            _read_replay(prev)
    graph.replay()
    if marks and _S.on:
        _S.pending[id(marks)] = marks


def _read_replay(marks: list) -> None:
    marks[-1][1].synchronize()
    _S.marks.extend((label, _host_ns(event)) for label, event in marks)


def _host_ns(t) -> int:
    """A time on the host clock: an ns reading as it is, a device event
    placed by the anchor."""
    if isinstance(t, int):
        return t
    event, host = _S.anchor
    return host + round(event.elapsed_time(t) * 1e6)


# ------------------------------------------------------------------ readings

def gaps(steps: list[tuple[int, int]], spans: list[tuple]) -> dict:
    """The gaps between consecutive steps [(start, end)] of one owner: each
    `max(0, start[n+1] - end[n])`, attributed to the innermost host span
    [(name, start, end, ...)] open at its middle (`OUTSIDE` if none).
    Returns {"share": their sum over last end - first start, "ms": their
    sum, "by_span": {span: ms}}."""
    total, by_span = 0, defaultdict(int)
    for (_, end), (start, _) in zip(steps, steps[1:]):
        gap = max(0, start - end)
        if gap:
            total += gap
            by_span[_innermost(spans, end + gap // 2)] += gap
    window = steps[-1][1] - steps[0][0] if steps else 0
    return {"share": total / window if window > 0 else 0.0, "ms": total / 1e6,
            "by_span": {k: v / 1e6 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])}}


def _innermost(spans: list[tuple], t: int) -> str:
    best = None
    for s in spans:
        if s[1] <= t < s[2] and (best is None or s[1] >= best[1]):
            best = s
    return best[0] if best is not None else OUTSIDE


def sections(steps: list[tuple[int, int]], marks: list[tuple[int, str]]) -> tuple[int, dict]:
    """The device time of the steps [(start, end)] by section: in each step
    that holds marks [(time, label)] (sorted), each interval between two
    consecutive marks belongs to the earlier one's label, the interval
    before the first mark and after a mark `UNMARKED` to `UNMARKED`, the
    last mark's to its label up to the step's end. Returns (marked steps,
    {label: ns summed over them})."""
    times = [t for t, _ in marks]
    n, out = 0, defaultdict(int)
    for start, end in steps:
        lo, hi = bisect.bisect_left(times, start), bisect.bisect_right(times, end)
        if lo == hi:
            continue
        n += 1
        points = [(start, UNMARKED)] + marks[lo:hi] + [(end, None)]
        for (a, label), (b, _) in zip(points, points[1:]):
            out[label] += b - a
    return n, dict(out)


def snapshot() -> dict:
    """What was recorded since the last `reset` (see the module's doc)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for marks in list(_S.pending.values()):
        _read_replay(marks)
    _S.pending.clear()
    _S.marks = [(label, _host_ns(t)) for label, t in _S.marks]
    for owner, steps in _S.steps.items():
        _S.steps[owner] = [(a, b, _host_ns(c), _host_ns(d)) for a, b, c, d in steps]
    marks = sorted((t, label) for label, t in _S.marks)

    by_name: dict[str, list] = defaultdict(list)
    for name, a, b, own in _S.spans:
        by_name[name].append((b - a, own))
    spans = {name: {"n": len(v), "mean_ms": sum(d for d, _ in v) / len(v) / 1e6,
                    "own_mean_ms": sum(o for _, o in v) / len(v) / 1e6}
             for name, v in by_name.items()}
    steps, marked = {}, {}
    for owner, recs in _S.steps.items():
        dev = [(c, d) for _, _, c, d in recs]
        steps[owner] = {"n": len(recs),
                        "host_mean_ms": sum(b - a for a, b, _, _ in recs) / len(recs) / 1e6,
                        "device_mean_ms": sum(d - c for c, d in dev) / len(recs) / 1e6,
                        "gaps": gaps(dev, _S.spans)}
        n, ns = sections(dev, marks)
        if n:
            marked[owner] = {"steps": n, "ms": {k: v / n / 1e6 for k, v in sorted(ns.items())}}
    moved = {k: v - _S.base.get(k, 0) for k, v in _S.counters.items()}
    return {"spans": spans, "steps": steps, "sections": marked,
            "counters": {k: v for k, v in moved.items() if v}}
