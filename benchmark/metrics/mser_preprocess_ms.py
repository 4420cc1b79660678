"""CUDA-event milliseconds a batch of the program's ``preprocess`` stage
(gray, CLAHE, blur, gamma), eager dispatches under the stage timer."""

KIND, UNIT = "per_layer", "ms"


def read(run):
    return (run.stages or {}).get("preprocess")
