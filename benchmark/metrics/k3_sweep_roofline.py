"""The fused sweep K3's share of its roofline: the least time of one call
(``counts.k3_bound_s``: its bytes once over the HBM rate, or its
propagation's operations over the 32-bit lane rate, whichever is longer),
over the kernel's device time a call in the traced stretch (every
``sweep_tile_kernel`` launch, over the batches)."""

from benchmark.counts import k3_bound_s

KIND, UNIT = "per_layer", "%"
KERNEL = "sweep_tile_kernel"


def read(run):
    if run.family != "mser" or not run.trace:
        return None
    spent = sum(s for name, s in run.trace["ops"].items() if KERNEL in name)
    if spent <= 0:
        return None
    bound, _ = k3_bound_s(run.config, run.traffic)
    return 100.0 * bound / (spent / run.trace["batches"])
