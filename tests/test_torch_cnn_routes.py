"""PyTorch port vs the JAX reference: every route of ``CNNDetector`` and
``QuantCNNDetector`` through dispatch/dispatch_yuv and collect.

Synthetic 96x160 frames (and their 4:2:0 planes, made with numpy) go
through the same route of both packages with the shipped checkpoints.  A
spy on the port's route function shows which route ran.  Tolerance: the
collected detections agree (same class, corners within 1 px, scores within
0.05, the reference's own cross-path bound), except those within 0.05 of
the score threshold: bf16 convs round after sums taken in other orders,
and the int8 path's fused stem is bf16.
"""

import os

import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_quant as jcq
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_quant as tcq
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import bgr_to_yuv420, make_frames
from opencv_traffic_sign_detector_tpu_torch.ops.yuv import patchify_yuv_planes

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {"float": os.path.join(REPO, "artifacts", "cnn_detector", "params.npz"),
         "int8": os.path.join(REPO, "artifacts", "cnn_detector", "params_int8.npz")}
HW = (96, 160)
# route: (upscale, input, the port's route function that must run)
ROUTES = {
    "bgr": (1.0, "bgr", "_detect"),
    "patches8": (1.0, "patches8", "_detect"),
    "fused": (1.6, "bgr", "_detect_fused_upscaled"),
    "two_stage": (1.3, "bgr", "_detect_upscaled"),
    "downscale": (0.9, "bgr", "_detect_upscaled"),
    "yuv_patches": (1.0, "yuv420p", "_detect_yuv_patches"),
    "yuv_tight": (1.0, "yuv420", "_detect"),
    "yuv_fused": (1.6, "yuv420", "_detect_fused_upscaled"),
    "yuv_two_stage": (1.3, "yuv420", "_detect_upscaled"),
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


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tcd, name)

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(tcd, name, spy)
    return calls


def _run(det, x, names):
    out = det.dispatch_yuv(*x) if isinstance(x, tuple) else det.dispatch(x)
    return det.collect(out, names, HW)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_route_matches_reference(kind, route, inputs, monkeypatch):
    upscale, fmt, fn = ROUTES[route]
    jdet = jcq.load_detector(CKPTS[kind], upscale=upscale)
    tdet = tcq.load_detector(CKPTS[kind], upscale=upscale, device="cpu")
    assert type(tdet).__name__ == type(jdet).__name__
    names = ["a.jpg", "b.jpg"]
    want = _run(jdet, inputs[fmt], names)
    calls = _spy(monkeypatch, fn)
    got = _run(tdet, inputs[fmt], names)
    assert len(calls) == 1, f"{route} did not take {fn}"
    if fn == "_detect_fused_upscaled":
        plan = calls[0][-1]
        assert (plan.t, plan.a) == (8, 5)
    thr = tdet.cfg.score_threshold
    assert want, "the reference detected nothing; pick another seed"
    assert not tcd.unmatched_detections(want, got, 0.05, thr)
    if fmt == "patches8":   # the same frames as bgr: identical outputs
        bgr = tdet.dispatch(inputs["bgr"])
        for a, b in zip(tdet.dispatch(inputs["patches8"]), bgr):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_dispatch_1412_takes_fused_plan_24_17(kind, monkeypatch):
    det = tcq.load_detector(CKPTS[kind], upscale=1.412, device="cpu")
    calls = _spy(monkeypatch, "_detect_fused_upscaled")
    out = det.dispatch(np.zeros((1, 160, 160, 3), np.uint8))
    assert out[0].shape == (1, det.cfg.max_detections, 4)
    assert (calls[0][-1].t, calls[0][-1].a) == (24, 17)


@pytest.mark.parametrize("case", ["patches8_upscale", "yuvp_upscale", "yuvp_slim"])
def test_routes_reject_patchified_input_where_the_reference_does(case, inputs):
    if case == "yuvp_slim":
        det = tcd.CNNDetector(tcd.SignCenterNet(tcd.CNNDetectorConfig(arch="slim")))
        with pytest.raises(ValueError, match="patchified yuv planes"):
            det.dispatch_yuv(*inputs["yuv420p"])
        return
    det = tcq.load_detector(CKPTS["float"], upscale=1.6, device="cpu")
    with pytest.raises(ValueError):
        if case == "patches8_upscale":
            det.dispatch(inputs["patches8"])
        else:
            det.dispatch_yuv(*inputs["yuv420p"])
