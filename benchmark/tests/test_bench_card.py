"""On a card: the program passes each cell's limits and the control fails
one of them (``control.py``; the full readings the limits were set from
are in PERF.md).  Skips without a card."""

import pytest

from benchmark import harness
from benchmark.control import readings


@pytest.mark.card
@pytest.mark.parametrize("name", harness.workloads())
def test_the_control_fails_and_the_program_passes(card, name):
    limits = harness.cell(name)["config_data"]["limits"]
    out = readings(name, [2**31 + 101, 2**31 + 102], [2**31 + 103], 1.0, device=card)
    for r in out["program"]:
        assert all(r["numbers"][k] <= v for k, v in limits.items()), r
    for r in out["control"]:
        assert any(r["numbers"][k] > v for k, v in limits.items()), r
