"""The share of the traced stretch (a closed loop of replayed dispatches
under ``torch.profiler``) in which no kernel and no copy ran on the card
(the MSER cells)."""

KIND, UNIT = "per_layer", "%"


def read(run):
    return run.idle_share
