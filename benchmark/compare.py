"""The comparisons that decide ``correct``: the program's records of a frame
against the plain reference's.

A record is ``(x1, y1, x2, y2, type, score)`` as the program's ``collect``
returns it.  The harness hands over every frame it collected as
``{(pool batch, frame, records): times seen}``: a frame the program answered
alike each time it came round is judged once and counts as often as it came.
Each function returns the numbers a configuration's ``limits`` hold and the
frames (with their repeats) past a limit; a run is correct when every
number is at most its limit.
"""

from __future__ import annotations


def mser_numbers(frames: dict, refs: dict) -> tuple[dict, int]:
    """``frames_differing``: frames whose records are not exactly the
    reference's (boxes, types, scores and order)."""
    bad = sum(n for (k, i, got), n in frames.items() if list(got) != list(refs[k][i]))
    return {"frames_differing": bad}, bad
