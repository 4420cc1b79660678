"""Milliseconds a batch from the ``h2d`` stamp, enqueued just before the
frames' copy into the graph's static input, to the graph's first stamp (the
copy and the graph's launch), read from the program's tracer over the
window's replayed batches."""

from benchmark.program_trace import mean_ms, replayed

KIND, UNIT = "per_layer", "ms"


def read(run):
    batches = replayed(run)
    if batches is None:
        return None
    return mean_ms(sum(d.first_ns - d.h2d_ns for d in b.devices) / len(b.devices)
                   for b in batches if all(d.first_ns is not None for d in b.devices))
