"""Timers and the trace reader.

``StageTimer`` is a frozen copy of the port's ``chip_smoke.py:
CudaStageTimer``: a stage timer the program calls around each stage of an
eager dispatch (``ops/mser.py: stage_scope``), CUDA events on each side.

``trace_stretch`` runs a closed loop of dispatches under ``torch.profiler``
and reduces the device's kernels and copies to busy time, time by
operation, and idle gaps labelled by what the host was doing then (the
benchmark's own ``record_function`` spans around each dispatch and collect).
On an H100 the profiler drops records of a trace now and then, and never
adds one (the port's notes): busy time is then a lower bound, and an idle
share an upper one.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimer:
    """``with timer("name"):`` brackets a stage with CUDA events."""

    def __init__(self):
        self.events = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events[name].append((start, end))

    def per_batch_ms(self, batches: int) -> dict[str, float]:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / batches
                for k, v in self.events.items()}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def trace_stretch(loop) -> dict:
    """Profile ``loop(span)`` (it runs the dispatches, wrapping each
    dispatch and collect in ``span(name)``) and reduce its trace.

    -> {busy_s, window_s, ops: {name: seconds}, gaps: [(label, seconds)]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def span(name):
        return record_function(f"bench.{name}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop(span)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev, host = [], []
    for e in events:
        if e.name.startswith("bench."):  # the spans, and their copies on the card's timeline
            if e.device_type != DeviceType.CUDA:
                host.append(e)
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            dev.append(e)
    if not host:
        return {"busy_s": 0.0, "window_s": wall, "ops": {}, "gaps": []}
    lo = min(e.time_range.start for e in host)
    hi = max(e.time_range.end for e in host)
    busy = _union([(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in dev
                   if e.time_range.end > lo and e.time_range.start < hi])
    ops: dict[str, float] = defaultdict(float)
    for e in dev:
        ops[e.name] += e.time_range.elapsed_us() * 1e-6
    spans = sorted((e.time_range.start, e.time_range.end, e.name[6:]) for e in host)
    gaps: dict[str, list[float]] = defaultdict(list)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = next((n for s, t, n in spans if s <= mid <= t), "loop")
        gaps[label].append((b - a) * 1e-6)
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (hi - lo) * 1e-6,
            "ops": dict(ops),
            "gaps": sorted(((f"idle during {k} ({len(v)} gaps, longest {max(v) * 1e3:.4f} ms)",
                             sum(v)) for k, v in gaps.items()), key=lambda x: -x[1])}
