"""Per-stage wall-clock timers for the CLIs, and profiler traces.

The port's copy of ``StageProfiler`` from
``opencv_traffic_sign_detector_tpu/utils/profiling.py``.  Where a stage's
time must include the card's work, the caller synchronises
(``torch.cuda.synchronize``) inside the stage.  :func:`profiler_trace` is
the counterpart of the reference's ``xla_trace``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict


@dataclasses.dataclass
class StageStat:
    calls: int = 0
    total_s: float = 0.0
    items: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0

    @property
    def items_per_s(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else 0.0


class StageProfiler:
    """Accumulates wall-clock per named stage; prints a summary table."""

    def __init__(self) -> None:
        self.stages: "OrderedDict[str, StageStat]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        stat = self.stages.setdefault(name, StageStat())
        t0 = time.perf_counter()
        try:
            yield
        finally:
            stat.calls += 1
            stat.total_s += time.perf_counter() - t0
            stat.items += items

    def summary(self) -> str:
        lines = [f"{'stage':<28}{'calls':>7}{'total s':>10}{'mean s':>10}"
                 f"{'items/s':>12}"]
        for name, s in self.stages.items():
            rate = f"{s.items_per_s:.2f}" if s.items else "-"
            lines.append(
                f"{name:<28}{s.calls:>7}{s.total_s:>10.3f}{s.mean_s:>10.4f}"
                f"{rate:>12}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    visible, of the card into ``log_dir`` (a ``*.pt.trace.json`` file that
    TensorBoard's profiler plugin and chrome://tracing read) when
    ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
