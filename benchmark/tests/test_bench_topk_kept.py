"""The reader of the candidate select's counter (``topk_kept_per_level``)
on synthetic batches: None without the counter (a program that lacks it,
or the detection family), the window's mean a frame and level with it."""

import json
import types

import pytest

from benchmark import harness
from opencv_traffic_sign_detector_tpu_torch.runtime import trace

READER = harness.readers("per_layer")["topk_kept_per_level"]
CONFIG = json.loads((harness.ROOT / "configs" / "rec_mser_hog_lda.json").read_text())  # 39 levels


@pytest.fixture
def tracer(monkeypatch):
    t = trace.Tracer()
    monkeypatch.setattr(trace, "TRACER", t)
    return t


def _batch(tracer, start_ms, kept, device="cuda:0"):
    with tracer.dispatch() as b:
        pass
    b.spans[0].start_ns = start_ms * 1_000_000
    b.devices = [trace.DeviceTimes(device, 0, 0, 0, {}, {})]
    b.topk_kept = kept
    return b


def _run(family="recognition"):
    return types.SimpleNamespace(t_start=1.0, t_end=2.0, family=family, config=CONFIG,
                                 frames_per_batch=8)


def test_the_mean_a_frame_and_level_of_the_windows_batches(tracer):
    _batch(tracer, 500, 10_000)       # before the window
    _batch(tracer, 1000, 8 * 39 * 12)
    _batch(tracer, 1500, 8 * 39 * 20)
    _batch(tracer, 3000, 1)           # after it
    assert READER.read(_run()) == pytest.approx(16)


def test_none_without_the_counter_on_the_cpu_or_outside_recognition(tracer):
    _batch(tracer, 1200, None)
    assert READER.read(_run()) is None
    _batch(tracer, 1300, 39 * 8, device="cpu")
    assert READER.read(_run()) is None
    _batch(tracer, 1400, 39 * 8)
    assert READER.read(_run("mser")) is None
    assert READER.read(_run()) == pytest.approx(1)
