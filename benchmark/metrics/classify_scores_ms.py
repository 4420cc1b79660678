"""Milliseconds a batch of ``classify.scores`` (``mask_correlation_classify``
and ``compact_first``) inside the replayed graph: its device stamps, over
the window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "classify.scores")
