"""K5's share of its roofline at the recognition cell's level sweep: the
least time of one call (``counts_rec.k5_bound_s``: its bytes once over the
HBM rate, or its passes' min operations over the 32-bit lane rate,
whichever is longer), over the kernel's device time a call in the traced
stretch (every launch of one of K5's forms, over the batches and the calls
a batch)."""

from benchmark.counts_rec import k5_bound_s, k5_shape

KIND, UNIT = "per_layer", "%"
KERNELS = ("rolls_tile_kernel", "rolls_window_kernel", "rolls_resident_kernel",
           "rolls_mask_kernel")


def read(run):
    if run.family != "recognition" or not run.trace:
        return None
    spent = sum(s for name, s in run.trace["ops"].items() if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    calls = k5_shape(run.config, run.traffic)["calls"] * run.trace["batches"]
    bound, _ = k5_bound_s(run.config, run.traffic)
    return 100.0 * bound / (spent / calls)
