"""The 95th percentile, over every frame completed in the window, of the
time from the start of its batch's dispatch to the return of that batch's
collect (every frame of a batch shares its batch's time)."""

import numpy as np

KIND, UNIT = "end_to_end", "ms"


def read(run):
    done = run.completed
    if not done:
        return None
    lat = np.repeat([b.t_done - b.t_dispatch for b in done], run.frames_per_batch)
    return 1e3 * float(np.percentile(lat, 95))
