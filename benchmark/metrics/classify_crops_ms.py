"""Milliseconds a batch of ``classify.crops`` (``filter_and_grow_boxes`` and
``crop_and_resize``, the crop gather) inside the replayed graph: its device
stamps, over the window's replayed batches."""

from benchmark.program_trace import stages_ms

KIND, UNIT = "per_layer", "ms"


def read(run):
    return stages_ms(run, "classify.crops")
