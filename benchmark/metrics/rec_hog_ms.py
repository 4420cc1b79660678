"""Milliseconds a batch of ``rec.hog`` (the crops' gray and their HOG
descriptors) inside the replayed graph: its device stamps, over the
window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "rec.hog")
