"""Milliseconds a batch of the ``sweep`` stage (the downscale, the polarity
stack and the fused sweep K3) inside the replayed graph: the device stamps
of each of its ``stage_scope`` entries, summed a batch, over the window's
replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "sweep")
