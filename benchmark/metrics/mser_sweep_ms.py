"""CUDA-event milliseconds a batch of the program's ``sweep`` stage (the
downscale, the polarity stack and the fused sweep K3), eager dispatches."""

KIND, UNIT = "per_layer", "ms"


def read(run):
    return (run.stages or {}).get("sweep")
