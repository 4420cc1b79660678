"""Keys the level sweep's candidate select kept a frame and level: the
program's counter ``topk_kept`` (``runtime/trace.py``; counted on the card
by ``csrc/level_topk.cu``'s merge, the keys its compaction kept over a
batch's levels and frames), summed over the window's batches and divided
by their frames and the configuration's levels.  A program without the
counter leaves nothing to read, and so does a CPU run."""

from benchmark.program_trace import window
from benchmark.reference.recognition import Params, levels

KIND, UNIT = "per_layer", "keys"


def read(run):
    if run.family != "recognition":
        return None
    batches = [b for b in window(run) or [] if getattr(b, "topk_kept", None) is not None]
    if not batches:
        return None
    _, _, n_levels = levels(Params.from_config(run.config))
    return sum(b.topk_kept for b in batches) / (len(batches) * run.frames_per_batch * n_levels)
