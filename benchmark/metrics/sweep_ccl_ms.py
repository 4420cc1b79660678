"""Milliseconds a batch of ``sweep.ccl`` (each level's propagation in the
level-by-level sweep: K5's roll passes and the pointer jumps) inside the
replayed graph, within ``sweep``: its device stamps, over the window's
replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "sweep.ccl")
