"""The CUDA-graph dispatch helper (``runtime/graphs.py``) on the CPU.

The CPU cannot capture a graph, so these tests hold what it can show: on
the CPU the helper calls the function each time and never captures; off the
CPU it keeps one entry a device, shape, dtype, key and set of constants,
which a stand-in capture step (injected into the helper) makes here on the
``meta`` device; a capture step that raises propagates with no eager retry;
a replay copies its input into the static buffer and adds the launches its
capture recorded.  On a card ``chip_smoke.py`` holds every replayed dispatch
equal to the eager one, bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from opencv_traffic_sign_detector_tpu_torch.models import detector as tdet
from opencv_traffic_sign_detector_tpu_torch.ops import clahe_cuda
from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as tmesh
from opencv_traffic_sign_detector_tpu_torch.runtime import build, graphs

torch.set_num_threads(1)

META = torch.device("meta")


class StandIn:
    """A capture step that records its calls and replays by calling the
    function: (the warm-up's outputs, an entry whose ``replay`` calls it)."""

    def __init__(self):
        self.captures = []
        self.replays = 0

    def __call__(self, fn, device, x, consts):
        self.captures.append((device, tuple(x.shape), x.dtype))

        def replay(y):
            self.replays += 1
            return fn(y, *consts)

        return fn(x, *consts), types.SimpleNamespace(replay=replay)


def _counting(fn):
    calls = []

    def wrapped(x, *consts):
        calls.append(tuple(x.shape))
        return fn(x, *consts)

    return wrapped, calls


def test_cpu_calls_the_function_each_time_and_never_captures():
    step = StandIn()
    fn, calls = _counting(lambda x, c: x * 2 + c)
    g = graphs.CapturedFn(fn, capture=step)
    x, c = torch.arange(6.0).reshape(2, 3), torch.ones(3)
    for _ in range(3):
        assert torch.equal(g("cpu", x, c, key="cfg"), x * 2 + 1)
    assert calls == [(2, 3)] * 3
    assert step.captures == [] and g.entries() == {}


def test_eager_off_the_cpu_calls_the_function_and_never_captures():
    step = StandIn()
    fn, calls = _counting(lambda x: x + 1)
    g = graphs.CapturedFn(fn, capture=step)
    for _ in range(2):
        g(META, torch.empty(4, 2, device=META), eager=True)
    assert len(calls) == 2 and step.captures == [] and g.entries() == {}


def test_the_same_key_reuses_its_entry():
    step = StandIn()
    fn, calls = _counting(lambda x, c: x + c)
    g = graphs.CapturedFn(fn, capture=step)
    c = torch.empty(3, device=META)
    for _ in range(4):
        out = g(META, torch.empty(2, 3, device=META), c, key="cfg")
        assert out.shape == (2, 3)
    assert step.captures == [(META, (2, 3), torch.float32)]
    assert step.replays == 3  # the first call returns the warm-up's outputs
    assert len(g.entries()) == 1


@pytest.mark.parametrize("change", ["shape", "dtype", "key", "consts", "device"])
def test_a_new_shape_dtype_key_or_constant_makes_a_new_entry(change):
    step = StandIn()
    g = graphs.CapturedFn(lambda x, c: x + c, capture=step)
    c = torch.empty(3, device=META)
    g(META, torch.empty(2, 3, device=META), c, key="a")
    args = {"shape": (torch.empty(5, 3, device=META), c, "a"),
            "dtype": (torch.empty(2, 3, device=META, dtype=torch.float64), c, "a"),
            "key": (torch.empty(2, 3, device=META), c, "b"),
            "consts": (torch.empty(2, 3, device=META), torch.empty(3, device=META), "a"),
            "device": (torch.empty(2, 3, device=META), c, "a")}[change]
    dev = torch.device("meta", 0) if change == "device" else META
    g(dev, args[0], args[1], key=args[2])
    assert len(step.captures) == 2 and step.replays == 0
    # the constants are held by identity: a changed set replaces the entry
    assert len(g.entries()) == (1 if change == "consts" else 2)


def test_a_failed_capture_propagates_with_no_eager_retry():
    fn, calls = _counting(lambda x: x + 1)

    def refusing(fn_, device, x, consts):
        raise graphs.GraphCaptureError("refused at ops/x.py:1")

    g = graphs.CapturedFn(fn, capture=refusing)
    for _ in range(2):  # no entry is kept: each call tries the capture again
        with pytest.raises(graphs.GraphCaptureError, match="refused"):
            g(META, torch.empty(2, device=META))
    assert calls == [] and g.entries() == {}


def test_capture_graph_refuses_a_device_that_is_not_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.capture_graph(lambda x: x, torch.device("cpu"), torch.zeros(2), ())


def test_refusing_site_names_the_ops_line_through_a_chained_error():
    try:
        try:
            clahe_cuda.tile_histograms(np.zeros((1, 8, 8), np.uint8))
        except TypeError as inner:
            raise RuntimeError("capture ended with an error") from inner
    except RuntimeError as e:
        site = graphs.refusing_site(e)
    # the op's own line, not the loader's check (runtime/) that raised
    assert site.startswith("opencv_traffic_sign_detector_tpu_torch/ops/clahe_cuda.py:")
    assert "TypeError" in site and "expected a tensor" in site
    assert graphs.refusing_site(ValueError("no traceback")) == "no frame of the package"


def test_recording_launches_keeps_a_capture_out_of_the_counts():
    build.reset_launch_counts()
    build.count_launch("clahe_apply")
    with build.recording_launches() as rec:
        build.count_launch("level_sweep")
        build.count_launch("level_sweep")
    build.count_launch("flood_bbox")
    counts = build.launch_counts()
    assert rec["level_sweep"] == 2 and sum(rec.values()) == 2
    assert counts["clahe_apply"] == 1 and counts["flood_bbox"] == 1
    assert counts["level_sweep"] == 0
    build.add_launches(rec)
    build.add_launches(rec)
    assert build.launch_counts()["level_sweep"] == 4
    build.reset_launch_counts()


def test_a_replay_writes_the_static_input_and_adds_its_launches():
    build.reset_launch_counts()
    replayed = []
    static = torch.zeros(2, 3, dtype=torch.uint8)
    entry = graphs.Captured(graph=types.SimpleNamespace(replay=lambda: replayed.append(1)),
                            static=static, outputs=("out",),
                            launches={"tile_luts": 1, "clahe_apply": 1}, pool_bytes=0)
    x = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    assert entry.replay(x) == ("out",)
    assert torch.equal(static, x) and replayed == [1]
    counts = build.launch_counts()
    assert counts["tile_luts"] == 1 and counts["clahe_apply"] == 1
    build.reset_launch_counts()


def test_host_shards_split_as_shard_batch_on_the_cpu():
    mesh = tmesh.data_mesh(4, device="cpu")
    x = np.arange(8 * 3, dtype=np.uint8).reshape(8, 3)
    host = tmesh.host_shards(mesh, x)
    dev = tmesh.shard_batch(mesh, x)
    assert len(host) == 4 and all(torch.equal(a, b) for a, b in zip(host, dev))
    assert not any(h.is_pinned() for h in host)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.host_shards(mesh, x[:7])


def test_pinned_leaves_frames_for_the_cpu_as_they_are():
    t = torch.zeros(2, 3, dtype=torch.uint8)
    assert tdet.pinned(t, "cpu") is t
    a = np.zeros((2, 3), np.uint8)
    assert torch.equal(tdet.pinned(a, "cpu"), torch.from_numpy(a))
    assert torch.equal(tdet.upload(a, "cpu"), torch.from_numpy(a))


def test_sharded_detect_fn_passes_key_and_eager_to_the_helper():
    mesh = tmesh.data_mesh(2, device="cpu")
    seen = []

    def detect(frames, red, blue):
        seen.append(frames.shape[0])
        return frames.sum(dim=(1, 2)) + red.sum() + blue.sum()

    run = tmesh.sharded_detect_fn(mesh, detect)
    x = torch.arange(4 * 2 * 2, dtype=torch.float32).reshape(4, 2, 2)
    red, blue = torch.ones(3), torch.zeros(3)
    outs = run(tmesh.host_shards(mesh, x), red, blue, key="cfg", eager=False)
    want = x.sum(dim=(1, 2)) + 3
    assert torch.equal(torch.cat(outs), want) and seen == [2, 2]
    assert isinstance(run.graphs, graphs.CapturedFn) and run.graphs.entries() == {}


def test_two_shards_on_one_device_keep_a_graph_each():
    mesh = tmesh.Mesh((META, META))
    run = tmesh.sharded_detect_fn(mesh, lambda frames, red, blue: frames + red + blue)
    step = run.graphs._capture = StandIn()
    shards = [torch.empty(2, 3, device=META) for _ in range(2)]
    red, blue = torch.empty(3, device=META), torch.empty(3, device=META)
    for _ in range(3):
        outs = run(shards, red, blue, key="cfg")
        assert len(outs) == 2
    # one capture a shard, then a replay a shard a call: no shard reads the
    # other's outputs
    assert len(step.captures) == 2 and step.replays == 4
    assert sorted(k[3] for k in run.graphs.entries()) == [(0, "cfg"), (1, "cfg")]
