"""Milliseconds a batch of the ``classify`` stage (grow, crops, the two
dedup passes, the mean-mask scores) inside the replayed graph: its device
stamps, over the window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "classify")
