"""Graphs captured during the window: the program's counter ``captured``
on each batch dispatched inside it (a capture there, after an eviction or
at a new key, would otherwise show only as a slow batch)."""

from benchmark.program_trace import window

KIND, UNIT = "per_layer", "captures"


def read(run):
    batches = window(run)
    return None if batches is None else sum(b.captured for b in batches)
