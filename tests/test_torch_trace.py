"""The port's tracer (``runtime/trace.py``) on the CPU.

``DetectionPipeline`` runs the tuned MSER path on small synthetic frames,
through its card path on the CPU (``CapturedFn.EAGER_DEVICES`` emptied, a
stand-in capture step that calls the function again at each replay), where
a stamp is the host's clock: each batch's spans nest under ``dispatch`` and
``collect`` with one batch id, every stage of ``detect_batch`` is stamped
in order, a capture and its replays carry their counters, the tracer off
records nothing and answers alike and keys its graphs apart, and the spans
open ``tsd.*`` ranges under a running ``torch.profiler``.  The ring, the
stamps' resolution onto the host's clock and the gap labels are checked on
synthetic data.  On a card ``chip_smoke.py`` phase 5b holds the stamp
kernel and a replay's stamps against the host's spans and the profiler.
"""

import contextlib
import json
import types

import pytest
import torch

import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.detector as tdet
import opencv_traffic_sign_detector_tpu_torch.models.mean_masks as tmm
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames
from opencv_traffic_sign_detector_tpu_torch.runtime import graphs, trace

torch.set_num_threads(1)

CFG = tcfg.PipelineConfig(
    mser=tcfg.MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                         downscale=2, max_regions=128, ccl_iters=2, ccl_jumps=0,
                         level_step=9, refine_scan_passes=2),
    batch_size=2)
NAMES = ["a.jpg", "b.jpg"]
DISPATCH = {"pin", "to_host"}
# the stages of the tuned path in order of entry: the downscale, the
# polarity stack and K3 each enter sweep
ENTERED = ["preprocess", "sweep", "sweep", "sweep", "topk", "refine", "classify",
           "classify.crops", "classify.dedup", "classify.scores"]


class StandIn:
    """A capture step that runs the function (the warm-up), records the
    capture, and calls the function again at each replay."""

    def __init__(self):
        self.captures, self.replays = 0, 0

    def __call__(self, fn, device, x, consts):
        self.captures += 1

        def replay(y):
            self.replays += 1
            return fn(y, *consts)

        return fn(x, *consts), types.SimpleNamespace(replay=replay)


def _pipeline():
    return tdet.DetectionPipeline(CFG, tmm.MeanMaskTemplates.load("artifacts/mean_masks.npz"),
                                  device="cpu")


@pytest.fixture(scope="module")
def frames():
    return make_frames(2, 160, 160, seed=22), make_frames(2, 160, 160, seed=23)


@pytest.fixture(scope="module")
def card_path():
    """The dispatches' card path on the CPU, the process's tracer emptied."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs.CapturedFn, "EAGER_DEVICES", ())
        trace.TRACER.reset()
        yield


@pytest.fixture(scope="module")
def run(card_path, frames):
    """A capture and a replay in flight together, then one more replay."""
    pipe = _pipeline()
    step = pipe._detect.graphs._capture = StandIn()
    first, second = frames
    h0, h1 = pipe.dispatch(first), pipe.dispatch(second)
    records = [pipe.collect(h0, NAMES), pipe.collect(h1, NAMES)]
    h2 = pipe.dispatch(first)
    records.append(pipe.collect(h2, NAMES))
    return types.SimpleNamespace(pipe=pipe, step=step, handles=[h0, h1, h2], records=records,
                                 batches=list(trace.TRACER.batches))


def _children(batch, root: str) -> dict:
    (i,) = [k for k, s in enumerate(batch.spans) if s.name == root and s.parent is None]
    return {s.name: s for s in batch.spans if s.parent == i}, batch.spans[i]


def test_a_dispatch_and_collect_record_their_spans_under_one_batch(run):
    assert [b.id for b in run.batches] == [h[2].id for h in run.handles]
    assert len({b.id for b in run.batches}) == 3  # two in flight keep their ids apart
    for b, call in zip(run.batches, ("capture", "replay", "replay")):
        assert all(s.batch == b.id for s in b.spans)
        kids, dispatch = _children(b, "dispatch")
        assert set(kids) == DISPATCH | {call}
        done, collect = _children(b, "collect")
        assert set(done) == {"wait", "unpack"}
        assert dispatch.end_ns <= collect.start_ns
        for parent, inner in ((dispatch, kids), (collect, done)):
            for s in inner.values():
                assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert kids["pin"].end_ns <= kids[call].start_ns <= kids[call].end_ns
        assert kids[call].end_ns <= kids["to_host"].start_ns
    assert run.step.captures == 1 and run.step.replays == 2


def test_a_capture_and_its_replays_carry_their_counters(run):
    capture, *replays = run.batches
    assert capture.captured and capture.held_bytes is not None
    assert not any(b.captured for b in replays)
    assert all(b.held_bytes is None for b in replays)
    assert all(b.launches == 0 for b in run.batches)  # the CPU launches no kernel


def test_every_stage_of_detect_batch_is_stamped_in_order_and_nested(run):
    ((key, (_, _, stamps)),) = run.pipe._detect.graphs._entries.items()
    assert key[-1] is True
    assert stamps.marks[0] == ("h2d", trace.POINT) and stamps.marks[-1] == ("end", trace.POINT)
    assert [n for n, kind in stamps.marks if kind == trace.ENTER] == ENTERED
    inside = []
    for name, kind in stamps.marks[1:-1]:
        if kind == trace.ENTER:
            inside.append(name)
        else:
            assert kind == trace.EXIT and inside.pop() == name
        if name.startswith("classify."):
            assert inside[:1] == ["classify"]
    assert inside == []
    for b in run.batches:
        (d,) = b.devices
        assert set(d.stages_ns) == set(ENTERED) and d.device == "cpu"
        assert d.h2d_ns <= d.first_ns == d.opened_ns["preprocess"] <= d.end_ns
        assert sum(v for k, v in d.stages_ns.items() if "." not in k) <= d.end_ns - d.first_ns
        assert sum(v for k, v in d.stages_ns.items() if k.startswith("classify.")) <= \
            d.stages_ns["classify"]
        kids, _ = _children(b, "dispatch")
        call = kids.get("replay") or kids["capture"]
        assert call.start_ns <= d.h2d_ns and d.end_ns <= call.end_ns


def test_the_tracer_off_records_nothing_and_answers_alike(run, frames):
    trace.enable(False)
    try:
        kept = len(trace.TRACER.batches)
        held = set(run.pipe._detect.graphs.entries())
        handle = run.pipe.dispatch(frames[0])
        records = run.pipe.collect(handle, NAMES)
    finally:
        trace.enable(True)
    assert handle[2] is None and len(trace.TRACER.batches) == kept
    assert records == run.records[0] == run.records[2]
    # a capture of its own, keyed apart from the traced one
    (new,) = set(run.pipe._detect.graphs.entries()) - held
    (old,) = held
    assert new[:-1] == old[:-1] and (old[-1], new[-1]) == (True, False)
    assert run.pipe._detect.graphs._entries[new][2] is None


def test_a_timers_eager_dispatch_stamps_as_the_replay_does(run, frames):
    timed = []

    def timer(name):
        timed.append(name)
        return contextlib.nullcontext()

    run.pipe.timer = timer
    try:
        handle = run.pipe.dispatch(frames[0])
        assert run.pipe.collect(handle, NAMES) == run.records[0]
    finally:
        run.pipe.timer = None
    assert timed == ENTERED  # the timer still sees every stage
    batch = handle[2]
    kids, _ = _children(batch, "dispatch")
    assert set(kids) == DISPATCH | {"eager"} and not batch.captured
    (d,) = batch.devices
    assert set(d.stages_ns) == set(ENTERED) and d.end_ns is not None


def test_spans_open_tsd_ranges_under_a_running_profiler(run, frames):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            run.pipe.collect(run.pipe.dispatch(frames[1]), NAMES)
    ev = {e.name: e for e in prof.events()
          if e.name == "outer" or e.name.startswith("tsd.")}
    assert set(ev) == {"outer"} | {f"tsd.{n}" for n in DISPATCH | {"dispatch", "replay",
                                                                   "collect", "wait", "unpack"}}

    def within(inner, outer):
        return (ev[outer].time_range.start <= ev[inner].time_range.start
                and ev[inner].time_range.end <= ev[outer].time_range.end)

    assert all(within(n, "outer") for n in ev if n != "outer")
    assert all(within(f"tsd.{n}", "tsd.dispatch") for n in DISPATCH | {"replay"})
    assert within("tsd.wait", "tsd.collect") and within("tsd.unpack", "tsd.collect")


def test_the_graph_key_differs_with_the_tracer_on_and_off(monkeypatch):
    monkeypatch.setattr(graphs.CapturedFn, "EAGER_DEVICES", ())
    step = StandIn()
    g = graphs.CapturedFn(lambda x: x + 1, capture=step)
    x = torch.arange(4)
    tracer = trace.Tracer()
    monkeypatch.setattr(graphs, "TRACER", tracer)
    g("cpu", x, key="cfg")               # outside a batch: untraced
    with tracer.dispatch():
        g("cpu", x, key="cfg")           # inside one: traced, a capture of its own
        g("cpu", x, key="cfg")           # and its replay
    g("cpu", x, key="cfg")               # untraced again: the first graph's replay
    keys = list(g.entries())
    assert [k[-1] for k in keys] == [False, True] and keys[0][:-1] == keys[1][:-1]
    assert step.captures == 2 and step.replays == 2
    tracer.enabled = False
    with tracer.dispatch() as batch:     # off: no batch, untraced
        g("cpu", x, key="cfg")
    assert batch is None and step.captures == 2 and len(tracer.batches) == 1


def test_the_ring_stays_bounded():
    tracer = trace.Tracer(ring=4)
    for _ in range(10):
        with tracer.dispatch():
            with tracer.span("pin"):
                pass
    assert [b.id for b in tracer.batches] == [6, 7, 8, 9]
    assert all([s.name for s in b.spans] == ["dispatch", "pin"] for b in tracer.batches)


def test_spans_outside_a_batch_record_nothing():
    tracer = trace.Tracer()
    with tracer.span("pin"), tracer.collect(None):
        assert not tracer.tracing()
    tracer.record(None, captured=True)
    assert len(tracer.batches) == 0


def test_a_batch_adds_the_counters_of_its_shards():
    tracer = trace.Tracer()
    with tracer.dispatch() as batch:
        tracer.record(None, launches=4, captured=True, held_bytes=100)
        tracer.record(None, launches=4)
    assert (batch.launches, batch.captured, batch.held_bytes) == (8, True, 100)


def test_stamps_stop_at_the_end_of_their_buffer():
    stamps = trace.Stamps(torch.device("cpu"))
    for _ in range(trace.SLOTS + 5):
        stamps.mark("sweep", trace.ENTER)
    assert len(stamps.marks) == trace.SLOTS
    values = stamps.buf.tolist()
    assert values[1:] == sorted(values[1:]) and values[1] > 0


def _batch(tracer, device, values, marks, clock=None):
    with tracer.dispatch() as batch:
        pass
    if clock is not None:
        tracer.clocks[device] = clock
    batch.pending.append((device, torch.tensor(values, dtype=torch.int64), tuple(marks)))
    tracer.resolve(batch)
    return batch


def test_resolve_maps_a_cards_stamps_onto_the_host_clock_and_sums_repeated_stages():
    tracer = trace.Tracer()
    E, X, P = trace.ENTER, trace.EXIT, trace.POINT
    marks = [("h2d", P), ("sweep", E), ("sweep", X), ("topk", E), ("topk", X), ("sweep", E),
             ("sweep", X), ("classify", E), ("classify.crops", E), ("classify.crops", X),
             ("classify", X), ("end", P)]
    values = [100, 110, 150, 150, 160, 161, 201, 202, 203, 250, 260, 261]
    b = _batch(tracer, torch.device("cuda", 0), values, marks, clock=(1000, 3))
    (d,) = b.devices
    assert d.device == "cuda:0" and b.pending == []
    assert (d.h2d_ns, d.first_ns, d.end_ns) == (1100, 1110, 1261)
    assert d.stages_ns == {"sweep": 40 + 40, "topk": 10, "classify": 58, "classify.crops": 47}
    assert d.opened_ns == {"sweep": 1110, "topk": 1150, "classify": 1202,
                           "classify.crops": 1203}
    snap = tracer.snapshot()
    assert snap["clocks"] == {"cuda:0": {"offset_ns": 1000, "error_ns": 3}}
    assert json.loads(json.dumps(snap))["batches"][0]["devices"][0]["end_ns"] == 1261


def test_the_snapshot_leaves_out_batches_still_in_flight():
    tracer = trace.Tracer()
    with tracer.dispatch() as waiting:
        pass
    waiting.pending.append((torch.device("cpu"), torch.zeros(1, dtype=torch.int64), ()))
    done = _batch(tracer, torch.device("cpu"), [5, 6, 9], [("h2d", 0), ("x", 1), ("x", -1)])
    assert [b["id"] for b in tracer.snapshot()["batches"]] == [done.id]
    assert "pending" not in tracer.snapshot()["batches"][0]


def test_the_window_selects_by_the_dispatch_start():
    tracer = trace.Tracer()
    for start in (1_000_000_000, 2_000_000_000, 3_000_000_000):
        with tracer.dispatch() as b:
            pass
        b.spans[0].start_ns = start
    assert [b.spans[0].start_ns for b in tracer.window(1.5, 3.0)] == [2e9, 3e9]


def _span(name, start, end, parent, batch):
    return trace.Span(name, start, end, parent, batch)


def test_label_gaps_names_the_innermost_host_span_at_each_gaps_midpoint():
    def batch(i, spans, h2d, end):
        b = trace.Batch(i, spans=[_span(n, s, e, p, i) for n, s, e, p in spans])
        b.devices = [trace.DeviceTimes("cuda:0", h2d, h2d + 1, end, {}, {})]
        return b

    b0 = batch(0, [("dispatch", 0, 10, None), ("pin", 1, 8, 0),
                   ("collect", 40, 100, None), ("wait", 41, 90, 2), ("unpack", 90, 99, 2)],
               h2d=9, end=50)
    # the card ends batch 0 at 50 and starts batch 1 at 70: midpoint 60, in batch 0's wait
    b1 = batch(1, [("dispatch", 20, 30, None), ("pin", 21, 28, 0),
                   ("collect", 115, 125, None), ("wait", 116, 120, 2)], h2d=70, end=110)
    # 110 to 150: midpoint 130, after every span of both batches -> outside; then batch 2's
    # dispatch, its pin over 200: 190 to 210
    b2 = batch(2, [("dispatch", 195, 260, None), ("pin", 196, 240, 0),
                   ("replay", 241, 250, 0)], h2d=150, end=190)
    b3 = batch(3, [("dispatch", 270, 280, None)], h2d=210, end=300)
    b5 = batch(5, [("dispatch", 400, 410, None)], h2d=400, end=500)   # after a gap in ids
    gaps = trace.label_gaps([b3, b1, b0, b2, b5])
    assert gaps == [("wait", 50, 70), ("outside", 110, 150), ("pin", 190, 210)]
    # a midpoint past its last-begun span's end goes to the parent that covers it
    b2.spans[1].end_ns = 199
    assert trace.label_gaps([b2, b3])[0][0] == "dispatch"
