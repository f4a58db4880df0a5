"""Spans on the host and the device trace of a run.

`Spans` times the benchmark's own calls into the program's layers
(`collate`, `train_step`, `search`) on the host clock; inside a
profiled segment each span is also a `record_function` range, so the trace
can say what the host was doing while the card sat idle. `profiled` runs a
segment under `torch.profiler` (CPU and CUDA activities, CUPTI) and returns
its device operations and spans on one timeline, in microseconds.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

from portbench.harness import manifest

PREFIX = "portbench."


class Spans:
    def __init__(self, on: bool):
        self.on = on
        self.labels = False
        self.times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        label = (torch.profiler.record_function(PREFIX + name) if self.labels
                 else contextlib.nullcontext())
        t = time.perf_counter()
        with label:
            yield
        self.times[name].append(time.perf_counter() - t)


class Trace:
    """The device operations [(name, start, end)] and host spans [(name,
    start, end)] of a profiled segment, in microseconds, and its window:
    from the first operation's start to the last one's end."""

    def __init__(self, ops, spans, steps: int):
        self.ops, self.spans, self.steps = ops, spans, steps
        self.t0, self.t1 = min(o[1] for o in ops), max(o[2] for o in ops)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """Merged intervals in which an operation ran, inside the window."""
        out = []
        for _, a, b in sorted((o for o in self.ops), key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def step_idle(self, label: str) -> float | None:
        """The share of the traced steps' device time in which the card ran
        nothing: a step is the operations that start between the start of
        one host span `label` and the next, and its device time runs from
        its first operation's start to its last one's end. So the gaps
        between the kernels of a captured graph count as idle, and the host's
        time between steps, which the profiler lengthens, does not."""
        starts = sorted(a for n, a, _ in self.spans if n == label)
        if not starts:
            return None
        steps: dict[int, list] = defaultdict(list)
        for _, a, b in self.ops:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0:
                steps[i].append((a, b))
        span = busy = 0.0
        for ops in steps.values():
            ops.sort()
            span += max(b for _, b in ops) - ops[0][0]
            end = ops[0][0]
            for a, b in ops:
                busy += max(0.0, b - max(a, end))
                end = max(end, b)
        return 1.0 - busy / span if span > 0 else None

    def group_s(self, pats: list[str], invert: bool = False) -> float:
        """Seconds of device time in operations whose name matches `pats`
        (with `invert`, matches none of them)."""
        return sum(b - a for name, a, b in self.ops
                   if manifest.matches(name, pats) != invert) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for name, a, b in self.ops:
            by_name[manifest.kernel_id(name) or name] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        busy = self.busy()
        edges = [(self.t0, self.t0)] + busy + [(self.t1, self.t1)]
        for (_, end), (start, _) in zip(edges, edges[1:]):
            if start > end:
                gaps.append((self._host_at(end), (start - end) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span open at time `t`."""
        open_ = [s for s in self.spans if s[1] <= t < s[2]]
        return max(open_, key=lambda s: s[1])[0] if open_ else "outside spans"


def profiled(spans: Spans, segment, steps: int) -> Trace:
    """Runs `segment()` (the benchmark's calls of `steps` steps) under the
    profiler, to a synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    spans.labels = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        segment()
        torch.cuda.synchronize()
    spans.labels = False
    ops, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:  # the spans' own device-side ranges left out
            if end > start and not e.name.startswith(PREFIX):
                ops.append((e.name, start, end))
        elif e.name.startswith(PREFIX):
            host.append((e.name[len(PREFIX):], start, end))
    if not ops:
        raise RuntimeError("the profiler recorded no device operation")
    return Trace(ops, host, steps)
