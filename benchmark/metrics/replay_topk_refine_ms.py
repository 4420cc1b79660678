"""Milliseconds a batch of the ``topk`` and ``refine`` stages together (the
pooled top-k, the seed floods K4) inside the replayed graph: their device
stamps, over the window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "topk", "refine")
