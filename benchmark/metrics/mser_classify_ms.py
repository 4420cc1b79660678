"""CUDA-event milliseconds a batch of the program's ``classify`` stage
(grow, crops, the two dedup passes, the mean-mask scores), eager
dispatches."""

KIND, UNIT = "per_layer", "ms"


def read(run):
    return (run.stages or {}).get("classify")
