"""A run whose timed path is broken underneath comes out not correct.

The harness runs on the CPU at a small size with the card check skipped
(``device="cpu"``), the program wrapped so that one of the faults a
detection cell can have is planted where the answers are produced: an
answer altered (a score halved, or another type), or half of the batch left out.  (A
step that returns its state unchanged and the exchange between chips do
not exist in these cells: no cell trains, none spans chips.)"""

import pytest

from benchmark import harness

CELLS = {
    "mser_tuned.gtsdb_b32": ("gtsdb_b32", {"height": 400, "width": 680}),
}


def _altered_score(frames):
    out = [list(f) for f in frames]
    i = next(i for i, f in enumerate(out) if f)
    x1, y1, x2, y2, t, s = out[i][0]
    out[i][0] = (x1, y1, x2, y2, t, s / 2)
    return out


def _altered_type(frames):
    out = [list(f) for f in frames]
    i = next(i for i, f in enumerate(out) if f)
    x1, y1, x2, y2, t, s = out[i][0]
    out[i][0] = (x1, y1, x2, y2, t % 6 + 1, s)
    return out


def _half_left_out(frames):
    half = len(frames) // 2
    return [list(f) for f in frames[:half]] + [[] for _ in frames[half:]]


FAULTS = {"altered_score": _altered_score, "altered_type": _altered_type,
          "half_left_out": _half_left_out}


def _faulty(fault):
    def build(config, mix, device):
        prog = harness.driver(config["family"]).Program(config, mix, device)
        collect = prog.collect
        prog.collect = lambda handle: fault(collect(handle))
        return prog

    return build


def _run(name, program=None):
    traffic, kw = CELLS[name]
    mix = {**harness.load("traffic", traffic), "batch": 2, "pool_batches": 1, **kw}
    return harness.run_cell(name, 2**31 + 11, 0.05, False, 0.0, device="cpu", traffic=mix,
                            program=program)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_planted_fault_makes_the_run_not_correct(name, fault):
    out = _run(name, _faulty(FAULTS[fault]))
    assert not out["correct"] and out["failed"] > 0, out["checks"]
