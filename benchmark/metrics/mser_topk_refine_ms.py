"""CUDA-event milliseconds a batch of the program's ``topk`` and ``refine``
stages together (the pooled top-k, the seed floods K4), eager dispatches."""

KIND, UNIT = "per_layer", "ms"


def read(run):
    st = run.stages or {}
    if "topk" not in st or "refine" not in st:
        return None
    return st["topk"] + st["refine"]
