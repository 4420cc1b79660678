"""The recognition cell's yardstick: K5's call at the level sweep
(``csrc/prop_rolls.cu``), its bytes and operations counted from shapes
alone, with the peaks of ``counts.py``.

Each count is a lower bound on the work of the algorithm, so a share of the
roofline cannot pass 100%.
"""

from __future__ import annotations

from .counts import PEAK_HBM_BYTES, PEAK_MINMAX_ISSUE
from .reference.recognition import Params, levels

# The fewest min instructions a pixel takes in one masked pass: the least of
# its own key and its 4 neighbours' (int32: two 3-input minima).
K5_MIN_A_PASS = 2
# Bytes a pixel moves at least once a call: its int32 key in, its bool mask
# in, its int32 key out.
K5_BYTES_A_PIXEL = 4 + 1 + 4


def k5_shape(config: dict, traffic: dict) -> dict:
    """K5's calls in a batch of the full-resolution level sweep: planes (a
    frame's two polarities), their padded rows and columns, the passes of
    one call and the calls a batch (a level's two rounds of roll passes,
    one call each, where a pointer jump follows each round; else one call
    of both rounds)."""
    _, _, n_levels = levels(Params.from_config(config))
    jumps = config["ccl_jumps"] > 0
    return {"planes": traffic["batch"] * 2, "h": traffic["height"] + 2,
            "w": traffic["width"] + 2,
            "passes": config["ccl_iters"] * (1 if jumps else 2),
            "calls": n_levels * (2 if jumps else 1)}


def k5_bytes(s: dict) -> int:
    return s["planes"] * s["h"] * s["w"] * K5_BYTES_A_PIXEL


def k5_ops(s: dict) -> int:
    """The passes alone, in the fewest min instructions they can take: the
    mask's select and the pointer jumps are left out."""
    return s["planes"] * s["h"] * s["w"] * s["passes"] * K5_MIN_A_PASS


def k5_bound_s(config: dict, traffic: dict) -> tuple[float, str]:
    """(least seconds of one K5 call, the bound that binds: bytes or ops)."""
    s = k5_shape(config, traffic)
    by_bytes = k5_bytes(s) / PEAK_HBM_BYTES
    by_ops = k5_ops(s) / PEAK_MINMAX_ISSUE
    return (by_ops, "ops") if by_ops >= by_bytes else (by_bytes, "bytes")
