"""Milliseconds a batch of the ``preprocess`` stage (gray, CLAHE, blur,
gamma) inside the replayed graph: the device stamps at that
``stage_scope``'s entry and exit, read from the program's tracer, over the
window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "preprocess")
