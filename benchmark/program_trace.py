"""What the tracer-fed per-layer metrics read: the program's own tracer
(``opencv_traffic_sign_detector_tpu_torch/runtime/trace.py``), which keeps
each batch's host spans, its device stamps mapped onto the host's clock and
its counters.  The readers take the batches whose dispatch began inside the
run's window (``[run.t_start, run.t_end]``, the untraced window of a
``--trace 1`` run) and whose stamps came back from a card, and give a mean a
batch.  A program without the tracer, a CPU run or a fake program leaves
nothing to read, and every reader then returns None.
"""

from __future__ import annotations


def window(run) -> list | None:
    """The window's batches with stamps from a card, in dispatch order, or
    None where there are none."""
    try:
        from opencv_traffic_sign_detector_tpu_torch.runtime.trace import TRACER
    except ImportError:
        return None
    found = [b for b in TRACER.window(run.t_start, run.t_end)
             if b.devices and all(d.device.startswith("cuda") for d in b.devices)]
    return found or None


def replayed(run) -> list | None:
    """The window's batches (:func:`window`) that replayed a graph."""
    found = [b for b in window(run) or [] if b.span_ns("replay") is not None]
    return found or None


def mean_ms(values) -> float | None:
    """The mean of the values that are not None, nanoseconds to ms."""
    values = [v for v in values if v is not None]
    return 1e-6 * sum(values) / len(values) if values else None


def stage_ns(batch, *names: str) -> float | None:
    """``batch``'s nanoseconds in the stages ``names`` together, the mean
    over its cards (a shard each); None where no card stamped any of them."""
    per = [sum(d.stages_ns[n] for n in names if n in d.stages_ns) for d in batch.devices
           if any(n in d.stages_ns for n in names)]
    return sum(per) / len(per) if per else None


def stages_ms(run, *names: str) -> float | None:
    """The replayed batches' mean ms in the stages ``names`` together."""
    batches = replayed(run)
    return None if batches is None else mean_ms(stage_ns(b, *names) for b in batches)
