"""Seconds from the start of the process to the window: the imports, the
card, the kernels loaded (or built, on a checkout's first run), the frames
drawn, the weights, the graph captured and the warm-up batches."""

KIND, UNIT = "end_to_end", "s"


def read(run):
    return run.setup_s
