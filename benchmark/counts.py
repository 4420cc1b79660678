"""The yardstick's arithmetic: published peaks, and the operations and bytes
of a kernel, counted from shapes alone.

Nothing here reads what a kernel issues, so a redesigned kernel is held to
the same count.  Each count is a lower bound on the work of the algorithm
(never more than it needs), so a share of a roofline cannot pass 100%.
"""

from __future__ import annotations

import dataclasses

from .reference.mser import Params, level_count, plan_halo, sweep_plan

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
PEAK_HBM_BYTES = 3.35e12
# Integer minimum and maximum instructions a second: 64 an SM a clock at
# compute capability 9.0 (the CUDA C++ Programming Guide's table of
# arithmetic instruction throughput: 32-bit integer compare, minimum,
# maximum), x 132 SMs x the 1.98 GHz boost clock.
PEAK_MINMAX_ISSUE = 132 * 64 * 1.98e9
# The fewest such instructions a pixel takes in one Jacobi pass: the least
# of its own key and its 4 neighbours' (int32: two 3-input minima), and the
# least (ymin, xmin) and largest (ymax, xmax) of the same five boxes, each
# pair of 16-bit coordinates packed in a word (two 3-input packed minima,
# two maxima).
K3_MINMAX_A_PASS = 6


def k3_shape(config: dict, traffic: dict) -> dict:
    """The fused sweep's call for a batch: windows (n, r, w), the core rows
    written, and the levels and Jacobi passes of each."""
    p = Params.from_config(config)
    ds = max(1, p.downscale)
    h, w = traffic["height"] // ds + 2, traffic["width"] // ds + 2  # the 255 border
    sub = dataclasses.replace(p, max_area=max(p.max_area // (ds * ds), 1))
    n_strips, core, halo = sweep_plan(h, w, p.topk_pool, plan_halo(sub))
    pool = max(1, p.topk_pool)
    _, _, levels = level_count(p)
    return {"n": traffic["batch"] * 2 * n_strips, "r": core + 2 * halo,
            "w": -(-w // pool) * pool, "core": core, "levels": levels,
            "passes": 2 * p.ccl_iters}


def k3_bytes(s: dict) -> int:
    """Each input window byte read once, each int32 of the map written once."""
    return s["n"] * s["r"] * s["w"] + 4 * s["n"] * s["core"] * s["w"]


def k3_ops(s: dict) -> int:
    """The propagation alone, in the fewest min/max instructions it can
    take: every pass, every pixel of every window, at every level.  The
    mask, the anchors, the stability and the emit are left out."""
    return s["n"] * s["r"] * s["w"] * s["levels"] * s["passes"] * K3_MINMAX_A_PASS


def k3_bound_s(config: dict, traffic: dict) -> tuple[float, str]:
    """(least seconds of one K3 call, the bound that binds: bytes or ops)."""
    s = k3_shape(config, traffic)
    by_bytes = k3_bytes(s) / PEAK_HBM_BYTES
    by_ops = k3_ops(s) / PEAK_MINMAX_ISSUE
    return (by_ops, "ops") if by_ops >= by_bytes else (by_bytes, "bytes")
