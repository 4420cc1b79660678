"""The readers of the program's tracer (``program_trace.py`` and the
per-layer metrics that use it) on synthetic batches: each returns None
where the tracer holds no batch of the window, or only stamps from the CPU,
and the mean a batch of a window built by hand otherwise."""

import types

import pytest

from benchmark import harness
from opencv_traffic_sign_detector_tpu_torch.runtime import trace

READERS = harness.readers("per_layer")
NEW = ["replay_preprocess_ms", "replay_sweep_ms", "replay_topk_refine_ms",
       "replay_classify_ms", "classify_crops_ms", "classify_dedup_ms", "classify_scores_ms",
       "replay_h2d_ms", "device_gap_ms", "host_pin_ms", "host_replay_ms", "window_captures"]
MS = 1_000_000


def _batch(tracer, start_ms, stages, h2d, first, end, call="replay", pin=(0, 5),
           device="cuda:0", captured=False):
    """A batch dispatched at ``start_ms``: its dispatch span with ``pin`` and
    ``call`` spans (ms after the start), its stamps (ms), its counters."""
    with tracer.dispatch() as b:
        pass
    s = start_ms * MS
    b.spans = [trace.Span("dispatch", s, s + 8 * MS, None, b.id),
               trace.Span("pin", s + pin[0] * MS, s + pin[1] * MS, 0, b.id),
               trace.Span(call, s + 5 * MS, s + 7 * MS, 0, b.id)]
    b.devices = [trace.DeviceTimes(device, (start_ms + h2d) * MS, (start_ms + first) * MS,
                                   (start_ms + end) * MS, {k: v * MS for k, v in stages.items()},
                                   {})]
    b.captured = captured
    return b


@pytest.fixture
def tracer(monkeypatch):
    t = trace.Tracer()
    monkeypatch.setattr(trace, "TRACER", t)
    return t


def _run(t0_ms, t1_ms):
    return types.SimpleNamespace(t_start=t0_ms / 1e3, t_end=t1_ms / 1e3)


STAGES = [{"preprocess": 3, "sweep": 14, "topk": 0.5, "refine": 0.5, "classify": 17,
           "classify.crops": 11, "classify.dedup": 4, "classify.scores": 2},
          {"preprocess": 5, "sweep": 16, "topk": 1.5, "refine": 0.5, "classify": 19,
           "classify.crops": 13, "classify.dedup": 4, "classify.scores": 2}]
WANT = {"replay_preprocess_ms": 4, "replay_sweep_ms": 15, "replay_topk_refine_ms": 1.5,
        "replay_classify_ms": 18, "classify_crops_ms": 12, "classify_dedup_ms": 4,
        "classify_scores_ms": 2, "replay_h2d_ms": 2.5, "device_gap_ms": 1.5,
        "host_pin_ms": 6, "host_replay_ms": 2, "window_captures": 1}


def _window(tracer):
    """Before the window a capture; in it a capture then two replays; after
    it one more replay."""
    _batch(tracer, 0, STAGES[0], 1, 3, 40, call="capture", captured=True)
    _batch(tracer, 1000, STAGES[0], 1, 4, 40, call="capture", captured=True, pin=(0, 8))
    _batch(tracer, 1040, STAGES[0], 1, 3, 40, pin=(1, 5))   # its gap after the capture: 1 ms
    _batch(tracer, 1082, STAGES[1], 0, 3, 42, pin=(1, 7))   # 1080 - 1082: 2 ms
    _batch(tracer, 3000, STAGES[1], 9, 9, 9)


def test_every_new_reader_is_listed_for_both_cells():
    b = harness.json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in b["per_layer"]}
    cells = set(harness.workloads())
    for name in NEW:
        assert name in READERS and set(listed[name]["workloads"]) == cells
        assert listed[name]["source"] == ("program_counter" if name == "window_captures"
                                          else "program_span")


@pytest.mark.parametrize("name", NEW)
def test_a_reader_returns_none_without_tracer_records(name, tracer):
    assert READERS[name].read(_run(0, 20_000)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_returns_none_on_stamps_from_the_cpu(name, tracer):
    for i in range(3):
        _batch(tracer, 1000 + 50 * i, STAGES[0], 1, 3, 40, device="cpu")
    assert READERS[name].read(_run(0, 20_000)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_gives_the_mean_a_batch_of_the_window(name, tracer):
    _window(tracer)
    assert READERS[name].read(_run(1000, 2000)) == pytest.approx(WANT[name])
