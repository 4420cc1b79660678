"""Milliseconds a batch of ``classify.dedup`` (the histogram and the
coordinates dedup passes) inside the replayed graph: its device stamps,
over the window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "classify.dedup")
