"""The host's milliseconds in a dispatch call, over the window's dispatches
(pinning the frames, enqueueing the copy, the graph replay and the copy
back), in the cells where a batch's delay is an end-to-end metric."""

KIND, UNIT = "per_layer", "ms"


def read(run):
    return run.dispatch_ms
