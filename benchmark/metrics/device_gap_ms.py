"""Milliseconds a batch the card spends between one batch's graph-end stamp
and the next batch's ``h2d`` stamp (the records' and stamps' copies back,
and any wait for the host to enqueue), read from the program's tracer over
each pair of consecutive batches of the window, a card at a time."""

from benchmark.program_trace import mean_ms, window

KIND, UNIT = "per_layer", "ms"


def read(run):
    batches = window(run)
    if batches is None:
        return None
    return mean_ms(db.h2d_ns - da.end_ns
                   for a, b in zip(batches, batches[1:]) if b.id == a.id + 1
                   for da, db in zip(a.devices, b.devices) if da.end_ns is not None)
