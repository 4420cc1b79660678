"""The host's milliseconds a batch in the span ``pin`` (``pinned``: the
frames made contiguous and pinned before their copy), read from the
program's tracer over the window's batches."""

from benchmark.program_trace import mean_ms, window

KIND, UNIT = "per_layer", "ms"


def read(run):
    batches = window(run)
    return None if batches is None else mean_ms(b.span_ns("pin") for b in batches)
