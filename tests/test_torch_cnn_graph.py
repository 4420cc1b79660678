"""The CNN inference dispatches as CUDA graphs (``models/cnn_detector.py:
CNNDetector.dispatch``/``dispatch_yuv``, ``models/rec_pipeline.py:
RecognitionPipeline``'s CNN branch) on the CPU.

The CPU cannot capture a graph, so these tests let the dispatches take
their card path on the CPU (``CapturedFn.EAGER_DEVICES`` emptied) with a
stand-in capture step that runs the function once (the warm-up) and calls
it again at each replay, and hold what that shows:

* (a) each route, float and int8, is captured once a key and replayed after
  that, with the eager dispatch's outputs;
* (b) another shape, layout, ``upscale``, threshold or set of weights (by
  identity) makes a new entry, on a ``copy.copy`` of a detector too, which
  shares its ``CapturedFn``;
* (c) the second call of every route body, and of the recognition body,
  makes no tensor from host data and reads no scalar back (``HostReads``);
* (d) a refused capture propagates with no eager run;
* (e) an input of three planes replays through ``Captured`` and keys its
  ``CapturedFn`` entry by every plane's shape and dtype;
* (f) the recognition CNN branch captures one function that runs the
  detector's forward inside it, and the detector captures nothing;
* (g) that captured function's output on the CPU agrees with the JAX
  package's jitted ``recognize_batch_cnn`` on seeded synthetic frames,
  within the recognition parity bound of
  ``tests/test_torch_rec_pipeline.py``: the same valid slots and classes,
  boxes within 1 px, scores within 1e-5 where the box is the same.

On a card ``chip_smoke.py`` (phases 8, 13 and 17e) holds every replay equal
to the eager dispatch bit for bit.
"""

import copy
import dataclasses
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_graph import HostReads

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.rec_pipeline as jrp
import opencv_traffic_sign_detector_tpu.models.recognizer as jrec
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_quant as tcq
import opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline as trp
import opencv_traffic_sign_detector_tpu_torch.models.recognizer as trec
from opencv_traffic_sign_detector_tpu.config import PipelineConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import (
    bgr_to_yuv420,
    make_frames,
    make_labelled_frames,
)
from opencv_traffic_sign_detector_tpu_torch.ops.yuv import patchify_yuv_planes
from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {"float": os.path.join(REPO, "artifacts", "cnn_detector", "params.npz"),
         "int8": os.path.join(REPO, "artifacts", "cnn_detector", "params_int8.npz")}
CLF = os.path.join(REPO, "artifacts", "sign_classifier_r5_cnn")
HW = (96, 160)
# route: (upscale, input, Route.name, Route.yuv)
ROUTES = {
    "bgr": (1.0, "bgr", "native", False),
    "patches8": (1.0, "patches8", "native", False),
    "fused": (1.6, "bgr", "fused", False),
    "two_stage": (1.3, "bgr", "upscaled", False),
    "downscale": (0.9, "bgr", "upscaled", False),
    "yuv_patches": (1.0, "yuv420p", "yuv_patches", False),
    "yuv_tight": (1.0, "yuv420", "native", True),
    "yuv_fused": (1.6, "yuv420", "fused", True),
    "yuv_two_stage": (1.3, "yuv420", "upscaled", True),
}


@pytest.fixture(scope="module")
def inputs():
    frames = make_frames(2, *HW, seed=41)
    planes = bgr_to_yuv420(frames)
    b, h, w, _ = frames.shape
    patches = frames.reshape(b, h // 8, 8, w // 8, 24).transpose(0, 1, 3, 2, 4).reshape(
        b, h // 8, w // 8, 192)
    return {"bgr": frames, "patches8": np.ascontiguousarray(patches), "yuv420": planes,
            "yuv420p": patchify_yuv_planes(*planes)}


@pytest.fixture
def card_path(monkeypatch):
    """The dispatches' card path on the CPU."""
    monkeypatch.setattr(graphs.CapturedFn, "EAGER_DEVICES", ())


class StandIn:
    """A capture step that runs the function once (the warm-up), records the
    capture, and calls the function again at each replay; ``capturing`` is
    true while it runs the warm-up."""

    def __init__(self):
        self.captures, self.replays, self.capturing = [], 0, False

    def __call__(self, fn, device, x, consts):
        self.captures.append((device, graphs._signature(x)))
        self.capturing = True
        try:
            first = fn(x, *consts)
        finally:
            self.capturing = False

        def replay(y):
            self.replays += 1
            return fn(y, *consts)

        return first, types.SimpleNamespace(replay=replay)


def _dispatch(det, x):
    return det.dispatch_yuv(*x) if isinstance(x, tuple) else det.dispatch(x)


def _eager(det, x):
    """``det``'s dispatch of ``x`` run eagerly, through a copy of ``det``."""
    eager = copy.copy(det)
    eager.eager = True
    return _dispatch(eager, x)


def _equal(a, b) -> bool:
    return all(torch.equal(s, t) for s, t in zip(a, b, strict=True))


def _detector(kind: str, upscale: float = 1.0):
    return tcq.load_detector(CKPTS[kind], upscale=upscale, device="cpu")


# ---------------------------------------------------------------------------
# (a) one capture a key, then replays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_each_route_is_captured_once_then_replayed(kind, route, inputs, card_path):
    upscale, fmt, name, yuv = ROUTES[route]
    det = _detector(kind, upscale)
    step = det.graphs._capture = StandIn()
    want = _eager(det, inputs[fmt])
    assert step.captures == []
    for _ in range(3):
        assert _equal(_dispatch(det, inputs[fmt]), want)
    assert len(step.captures) == 1 and step.replays == 2
    (key,) = det.graphs.entries()
    route_key = key[3]
    assert (route_key.name, route_key.yuv, route_key.upscale) == (name, yuv, upscale)
    assert route_key.net is det.net and route_key.thresh == det.cfg.score_threshold
    # the graph's constants are the net's tensors: its parameters, or the q arrays
    consts = det.graphs._entries[key][0]
    assert consts and all(a is b for a, b in zip(consts, tcd.net_tensors(det.net), strict=True))
    if kind == "int8":
        assert all(any(c is t for c in consts) for t in det.q.values())


def test_the_cpu_never_captures(inputs):
    det = _detector("float")
    step = det.graphs._capture = StandIn()
    for _ in range(2):
        det.dispatch(inputs["bgr"])
    assert step.captures == [] and det.graphs.entries() == {}


def test_the_eager_attribute_never_captures(inputs, card_path, monkeypatch):
    det = _detector("float")
    step = det.graphs._capture = StandIn()
    det.eager = True
    det.dispatch(inputs["bgr"])
    monkeypatch.setattr(tcd.CNNDetector, "eager", True)
    other = _detector("float")
    other.graphs._capture = step
    other.dispatch_yuv(*inputs["yuv420"])
    assert step.captures == [] and det.graphs.entries() == other.graphs.entries() == {}


# ---------------------------------------------------------------------------
# (b) what makes a new entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change", ["shape", "layout", "upscale", "threshold", "weights",
                                    "another net"])
def test_a_new_shape_layout_upscale_threshold_or_weights_makes_a_new_entry(change, inputs,
                                                                           card_path):
    det = _detector("float")
    step = det.graphs._capture = StandIn()
    base = det.dispatch(inputs["bgr"])
    base = tuple(t.clone() for t in base)   # a caller that keeps outputs clones them
    other, x = det, inputs["bgr"]
    if change == "shape":
        x = inputs["bgr"][:1]
    elif change == "layout":
        x = inputs["patches8"]
    elif change == "upscale":
        other = copy.copy(det)
        other.upscale = 1.6
    elif change == "threshold":
        other = copy.copy(det)
        other.cfg = dataclasses.replace(det.cfg, score_threshold=0.1)
    elif change == "weights":
        conv = det.net.Conv_1
        conv.weight = torch.nn.Parameter(conv.weight.detach().clone(), requires_grad=False)
    else:
        other = _detector("float")
        other.graphs = det.graphs
    assert other.graphs is det.graphs      # a copy shares its detector's CapturedFn
    got = other.dispatch(x)
    assert len(step.captures) == 2 and step.replays == 0
    assert _equal(got, _eager(other, x))
    # the weights are held by identity: the new set replaces the entry
    assert len(det.graphs.entries()) == (1 if change == "weights" else 2)
    # the first detector still replays its own graph, with its own outputs
    assert _equal(det.dispatch(inputs["bgr"]), base) and step.replays == 1
    if change == "upscale":
        assert not _equal(got, base)


# ---------------------------------------------------------------------------
# (c) no host read in a route body's second call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_a_route_body_reads_nothing_from_the_host(kind, route, inputs):
    upscale, fmt, _, _ = ROUTES[route]
    det = _detector(kind, upscale)
    x = inputs[fmt]
    x = tuple(map(torch.from_numpy, x)) if isinstance(x, tuple) else torch.from_numpy(x)
    r = det.route(x)
    tensors = tcd.net_tensors(det.net)
    with torch.inference_mode():
        tcd.run_route(r, x, *tensors)        # makes the resident constants
        rec = HostReads()
        with rec:
            tcd.run_route(r, x, *tensors)
    assert dict(rec.sites) == {}


def test_the_recognition_body_reads_nothing_from_the_host():
    pipe, x = _recognition("float")
    consts = (*pipe._arrays, *tcd.net_tensors(pipe.cnn.net))
    with torch.inference_mode():
        pipe._recognize_cnn_packed(x, *consts)
        rec = HostReads()
        with rec:
            pipe._recognize_cnn_packed(x, *consts)
    assert dict(rec.sites) == {}


# ---------------------------------------------------------------------------
# (d) a refused capture
# ---------------------------------------------------------------------------


def test_a_refused_capture_propagates_with_no_eager_run(inputs, card_path, monkeypatch):
    det = _detector("float")
    calls = []
    real = tcd._detect
    monkeypatch.setattr(tcd, "_detect", lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def refusing(fn, device, x, consts):
        raise graphs.GraphCaptureError("capturing refused at models/cnn_detector.py:1")

    det.graphs._capture = refusing
    for _ in range(2):  # no entry is kept: each call tries the capture again
        with pytest.raises(graphs.GraphCaptureError, match="refused"):
            det.dispatch(inputs["bgr"])
    assert calls == [] and det.graphs.entries() == {}


# ---------------------------------------------------------------------------
# (e) three planes through one graph
# ---------------------------------------------------------------------------


def test_three_planes_replay_through_captured():
    replayed = []
    static = tuple(torch.zeros(s, dtype=torch.uint8) for s in ((2, 4, 4), (2, 2, 2), (2, 2, 2)))
    entry = graphs.Captured(graph=types.SimpleNamespace(replay=lambda: replayed.append(1)),
                            static=static, outputs=("out",), launches={}, pool_bytes=0)
    planes = tuple(torch.full(s.shape, i + 1, dtype=torch.uint8) for i, s in enumerate(static))
    assert entry.replay(planes) == ("out",)
    assert replayed == [1] and all(torch.equal(s, p) for s, p in zip(static, planes))
    with pytest.raises(ValueError):
        entry.replay(planes[:2])


def test_three_planes_key_an_entry_by_every_shape_and_dtype(inputs, card_path):
    det = _detector("float")
    step = det.graphs._capture = StandIn()
    y, cb, cr = inputs["yuv420"]
    for _ in range(2):
        det.dispatch_yuv(y, cb, cr)
    ((device, shapes, dtypes, route, traced),) = det.graphs.entries()
    assert not traced  # no batch of the tracer is open
    assert shapes == (y.shape, cb.shape, cr.shape) and dtypes == (torch.uint8,) * 3
    assert step.captures[0][1] == (shapes, dtypes) and step.replays == 1
    det.dispatch_yuv(y[:1], cb[:1], cr[:1])   # other shapes: another entry
    assert len(det.graphs.entries()) == 2


# ---------------------------------------------------------------------------
# (f)-(g) recognition with CNN proposals: one graph of the whole function
# ---------------------------------------------------------------------------


def _t(cfg):
    """The same config from the port's own config module."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, PipelineConfig):
        fields["mser"] = _t(cfg.mser)
    return getattr(tcfg, type(cfg).__name__)(**fields)


REC_CFG = PipelineConfig(batch_size=2)


def _recognition(kind: str):
    det = _detector(kind)
    det.cfg = dataclasses.replace(det.cfg, score_threshold=0.1)
    pipe = trp.RecognitionPipeline(cfg=_t(REC_CFG), classifier=trec.SignClassifier.load(CLF),
                                   cnn=det)
    frames, _ = make_labelled_frames(2, 192, 192, seed=8, signs_per_frame=4)
    return pipe, torch.from_numpy(frames)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_recognition_captures_one_function_holding_the_forward(kind, card_path, monkeypatch):
    pipe, x = _recognition(kind)
    step = pipe._recognize_cnn._capture = StandIn()
    nested = pipe.cnn.graphs._capture = StandIn()
    inside = []
    real = tcd._detect
    monkeypatch.setattr(tcd, "_detect",
                        lambda *a, **kw: inside.append(step.capturing) or real(*a, **kw))
    want = trp._pack(*trp.recognize_batch_cnn(x, pipe.cnn, pipe._arrays, *pipe._spec()))
    inside.clear()
    names = ["a.jpg", "b.jpg"]
    for _ in range(3):
        out, done, _ = pipe.dispatch(x.numpy())
        assert done is None and torch.equal(out, want)
    # the forward ran inside the capture (the warm-up) and at each replay
    assert inside == [True, False, False]
    assert len(step.captures) == 1 and step.replays == 2
    assert nested.captures == [] and pipe.cnn.graphs.entries() == {}
    assert pipe._recognize.entries() == {}
    (key,) = pipe._recognize_cnn.entries()
    assert key[3] == (pipe._spec(), pipe.cnn.route(x))
    consts = pipe._recognize_cnn._entries[key][0]
    assert len(consts) == len(pipe._arrays) + len(tcd.net_tensors(pipe.cnn.net))
    # another threshold on the detector: another graph
    pipe.cnn.cfg = dataclasses.replace(pipe.cnn.cfg, score_threshold=0.2)
    pipe.recognize_frames(x.numpy(), names)
    assert len(step.captures) == 2 and len(pipe._recognize_cnn.entries()) == 2


def test_the_captured_recognition_agrees_with_the_reference_jit():
    pipe, x = _recognition("float")
    jdet = jcd.CNNDetector.load(CKPTS["float"])
    jdet.cfg = dataclasses.replace(jdet.cfg, score_threshold=0.1)
    jpipe = jrp.RecognitionPipeline(cfg=REC_CFG, classifier=jrec.SignClassifier.load(CLF),
                                    cnn=jdet)
    want = [np.asarray(a) for a in jrp.recognize_batch_cnn(
        jnp.asarray(x.numpy()), jdet.params, jpipe._arrays, jdet.cfg, REC_CFG,
        jpipe.classifier.config.features, jpipe._kind, jpipe.classifier.config.knn_neighbors)]
    with torch.inference_mode():
        got = pipe._recognize_cnn.fn(x, *pipe._arrays, *tcd.net_tensors(pipe.cnn.net)).numpy()
    boxes, labels, scores, valid = want
    assert valid.any(), "the reference recognized nothing; pick another seed"
    assert np.array_equal(got[..., 6] > 0.5, valid)
    assert np.array_equal(got[..., 4][valid].astype(np.int64), labels[valid])
    gap = np.abs(got[..., :4][valid] - boxes[valid]).max(axis=-1)
    assert gap.max() <= 1
    same = gap == 0
    assert np.abs(got[..., 5][valid][same] - scores[valid][same]).max(initial=0.0) <= 1e-5
