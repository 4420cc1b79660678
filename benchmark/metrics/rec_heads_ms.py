"""Milliseconds a batch of ``rec.heads`` (the six LDA heads' product, their
sigmoids, the arbitration and the compaction) inside the replayed graph:
its device stamps, over the window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "rec.heads")
