"""The host's milliseconds a batch in the span ``replay`` (``CapturedFn``
on a hit: the stamp and the copy into the static input enqueued, the graph
launched, the stamps' copy back enqueued), read from the program's tracer
over the window's replayed batches."""

from benchmark.program_trace import mean_ms, replayed

KIND, UNIT = "per_layer", "ms"


def read(run):
    batches = replayed(run)
    return None if batches is None else mean_ms(b.span_ns("replay") for b in batches)
