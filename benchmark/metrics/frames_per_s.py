"""Frames whose records ``collect`` returned inside the window, over the
seconds from the window's first dispatch to the last of those returns
(the MSER cells)."""

KIND, UNIT = "end_to_end", "frames/s"


def read(run):
    return run.frames_per_s
