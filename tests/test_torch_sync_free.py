"""The MSER and recognition dispatches make no tensor from host data once
their constants exist.

On a card, ``torch.tensor(value, device=card)`` and
``torch.from_numpy(a).to(card)`` copy from pageable host memory, and that
copy ends in ``cudaStreamSynchronize``: the host waits for the card inside
the batch.  Every such constant of the port comes from
``ops/resident.py``, made at the first call and shared after it.  The
pattern is visible on the CPU too: ``torch.tensor``, ``torch.as_tensor``
and ``torch.from_numpy`` each dispatch ``aten.lift_fresh``, which a
``TorchDispatchMode`` records.  So the second call of each dispatch, and
of each op that makes a constant, must record no such op.  On the card
``chip_smoke.py`` holds the same windows free of host syncs with
``torch.cuda.set_sync_debug_mode``.
"""

import collections
import dataclasses
import math
import os
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import opencv_traffic_sign_detector_tpu_torch.config as tcfg
from opencv_traffic_sign_detector_tpu_torch.constants import ASPECT_MAX, ASPECT_MIN, DETECT_GROW
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames
from opencv_traffic_sign_detector_tpu_torch.eval import device_stats
from opencv_traffic_sign_detector_tpu_torch.models import detector as tdet
from opencv_traffic_sign_detector_tpu_torch.models import mean_masks as tmm
from opencv_traffic_sign_detector_tpu_torch.models import rec_pipeline as trp
from opencv_traffic_sign_detector_tpu_torch.models import recognizer as trec
from opencv_traffic_sign_detector_tpu_torch.ops import clahe, clahe_cuda, color, geometry, hog
from opencv_traffic_sign_detector_tpu_torch.ops import mser_cuda, prop_cuda, resize
from opencv_traffic_sign_detector_tpu_torch.ops import resident as res
from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as tmesh

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "opencv_traffic_sign_detector_tpu_torch"
BASE = tcfg.MSERConfig.from_string("MSER_7_200_2000_1")
# main_detection.py's tuned point and its --pixel_area_stability mode
TUNED = dataclasses.replace(BASE, downscale=2, ccl_iters=2, level_step=9, ccl_jumps=0,
                            max_regions=128)
PIXEL_AREA = dataclasses.replace(BASE, max_regions=128, downscale=2, fused_sweep=False)


class HostTensors(TorchDispatchMode):
    """Records where a tensor is made from host data (``aten.lift_fresh``):
    the port's innermost frame of each such call."""

    def __init__(self):
        super().__init__()
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.lift_fresh:
            ours = [f for f in traceback.extract_stack() if PKG in f.filename] or [None]
            here = ours[-1]
            self.sites["?" if here is None
                       else f"{os.path.relpath(here.filename, REPO)}:{here.lineno}"] += 1
        return func(*args, **(kwargs or {}))


def _second_call_sites(fn) -> dict:
    """``fn()`` once to make its constants, then the host tensors its
    second call makes."""
    fn()
    rec = HostTensors()
    with rec:
        fn()
    return dict(rec.sites)


def test_recorder_sees_each_host_constructor():
    """The mode sees the pattern: each constructor from host data counts."""
    rec = HostTensors()
    with rec:
        torch.tensor(1.0)
        torch.as_tensor(np.zeros(3, np.float32))
        torch.from_numpy(np.zeros(3, np.float32))
    assert sum(rec.sites.values()) == 3


@pytest.fixture(scope="module")
def templates():
    return tmm.templates_to_torch(tmm.MeanMaskTemplates.load(
        os.path.join(REPO, "artifacts", "mean_masks.npz")), "cpu")


@pytest.mark.parametrize("mser", [TUNED, PIXEL_AREA], ids=["tuned", "pixel_area"])
def test_detect_batch_second_call_makes_no_host_tensor(mser, templates):
    frames = torch.from_numpy(make_frames(2, 256, 256, seed=0))
    cfg = tcfg.PipelineConfig(mser=mser, batch_size=2)
    assert _second_call_sites(lambda: tdet.detect_batch(frames, *templates, cfg)) == {}


def test_recognize_batch_second_call_makes_no_host_tensor():
    """HOG features through the shipped LDA heads, MSER proposals at
    ``main_recognition.py``'s defaults."""
    clf = trec.SignClassifier.load(os.path.join(REPO, "artifacts", "sign_classifier_r5_cnn"))
    cfg = tcfg.PipelineConfig(mser=BASE, batch_size=1)
    arrays = trp.RecognitionPipeline(cfg=cfg, classifier=clf, device="cpu")._arrays
    frames = torch.from_numpy(make_frames(1, 160, 160, seed=1))
    assert _second_call_sites(
        lambda: trp.recognize_batch(frames, arrays, cfg, "HOG", "LDABAYES")) == {}


def _gen(seed=0):
    return np.random.default_rng(seed)


def _op_hsv():
    x = torch.from_numpy(_gen(1).integers(0, 256, (2, 9, 9, 3), dtype=np.uint8))
    return lambda: color.bgr_to_hsv(x)


def _op_gamma(gamma):
    x = torch.from_numpy(_gen(2).integers(0, 256, (2, 16, 16), dtype=np.uint8))
    return lambda: color.gamma_correct(x, gamma)


def _op_grow():
    b = torch.from_numpy(_gen(3).integers(1, 60, (2, 8, 4)).astype(np.int32))
    v = torch.ones((2, 8), dtype=torch.bool)
    return lambda: geometry.filter_and_grow_boxes(b, v, DETECT_GROW)


def _op_crop():
    img = torch.from_numpy(_gen(4).integers(0, 256, (1, 200, 200, 3), dtype=np.uint8))
    boxes = torch.tensor([[[3, 4, 50, 60], [10, 10, 30, 25]]], dtype=torch.int32)
    return lambda: resize.crop_and_resize(img, boxes, 25)


def _op_resize_batch():
    x = torch.from_numpy(_gen(5).integers(0, 256, (3, 40, 30), dtype=np.uint8))
    return lambda: resize.resize_batch(x, 32)


def _op_luts():
    hist = torch.from_numpy(_gen(6).integers(0, 9, (2, 8, 8, 256)).astype(np.int32))
    return lambda: clahe._tile_luts(hist, 100)


def _op_clahe_apply():
    x = torch.from_numpy(_gen(7).integers(0, 256, (2, 32, 48), dtype=np.uint8))
    luts = torch.from_numpy(_gen(8).integers(0, 256, (2, 8, 8, 256), dtype=np.uint8))
    return lambda: clahe_cuda.clahe_apply(x, luts)


def _op_score(templates):
    m = torch.from_numpy((_gen(9).random((2, 5, 625)) > 0.5).astype(np.float32))
    return lambda: tmm._score_color(m, templates[0])


def _op_hog():
    x = torch.from_numpy(_gen(10).integers(0, 256, (4, 32, 32), dtype=np.uint8))
    return lambda: hog.hog_descriptors(x)


def _op_sweep_plain():
    win = torch.from_numpy(_gen(11).integers(0, 256, (2, 12, 16), dtype=np.uint8))
    p = mser_cuda.SweepParams.from_config(dataclasses.replace(TUNED, downscale=1), 1)
    return lambda: list(mser_cuda._sweep_levels_plain(win, p, 4))


def _op_windows():
    planes = torch.from_numpy(_gen(12).integers(0, 256, (2, 40, 40), dtype=np.uint8))
    cand = torch.tensor([[0, 2, 3, 8, 8, 200], [1, 0, 0, 5, 5, 90]], dtype=torch.int32)
    return lambda: prop_cuda.candidate_windows(planes, cand, 16, 16)


def _op_heads():
    probs = torch.from_numpy(_gen(13).random((6, 7, 2)).astype(np.float32))
    return lambda: (trec.arbitrate_lda_heads(probs, 0.5),
                    trec.arbitrate_lda_heads(probs, 0.5, 0.1))


def _op_knn():
    g = _gen(14)
    f = lambda *s: torch.from_numpy(g.normal(size=s).astype(np.float32))  # noqa: E731
    arrays = (f(8), f(8, 3), f(20, 3), torch.from_numpy(g.integers(0, 7, 20)), torch.arange(7))
    feats = f(5, 8)
    return lambda: trp.classify_crops_knn(feats, *arrays, 4)


def _op_rec_grow():
    b = torch.from_numpy(_gen(15).uniform(0, 90, (2, 6, 4)).astype(np.float32))
    v = torch.ones((2, 6), dtype=torch.bool)
    return lambda: trp.grow_boxes_xyxy(b, v, 1.15, (100, 120))


def _op_stats():
    g = _gen(16)
    det = torch.from_numpy(g.integers(0, 80, (2, 6, 4)).astype(np.int32))
    gt = torch.from_numpy(g.integers(0, 80, (2, 3, 4)).astype(np.int32))
    dv = torch.ones((2, 6), dtype=torch.bool)
    types, gtt = torch.ones((2, 6), dtype=torch.int32), torch.ones((2, 3), dtype=torch.int32)
    return lambda: device_stats.frame_type_counts(det, types, dv, gt, gtt)


OPS = {
    "color.bgr_to_hsv": _op_hsv,
    "color.gamma_correct": lambda: _op_gamma(2.0),
    "color.gamma_correct lut": lambda: _op_gamma(1.5),
    "geometry.filter_and_grow_boxes": _op_grow,
    "resize.crop_and_resize": _op_crop,
    "resize.resize_batch": _op_resize_batch,
    "clahe._tile_luts": _op_luts,
    "clahe_cuda.clahe_apply plain": _op_clahe_apply,
    "hog.hog_descriptors": _op_hog,
    "mser_cuda._sweep_levels_plain": _op_sweep_plain,
    "prop_cuda.candidate_windows": _op_windows,
    "recognizer.arbitrate_lda_heads": _op_heads,
    "rec_pipeline.classify_crops_knn": _op_knn,
    "rec_pipeline.grow_boxes_xyxy": _op_rec_grow,
    "device_stats.frame_type_counts": _op_stats,
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_second_call_makes_no_host_tensor(name):
    assert _second_call_sites(OPS[name]()) == {}


def test_mean_mask_score_second_call_makes_no_host_tensor(templates):
    assert _second_call_sites(_op_score(templates)) == {}


# The constants of the repaired sites, each as its site rounds it to f32
CONSTANTS = {
    "color one": 1.0,
    "color zero": 0.0,
    "color hsv s": float(255 << color._HSV_SHIFT),
    "color hsv h": float(180 << color._HSV_SHIFT) / 6.0,
    "color gamma": 255.0,
    "geometry aspect min": ASPECT_MIN,
    "geometry aspect max": ASPECT_MAX,
    "geometry grow": DETECT_GROW - 1.0,
    "geometry half": 0.5,
    "resize reciprocal": float(np.float32(1.0) / np.float32(25)),
    "clahe lut scale": 255.0 / 12750,
    "mean_masks hundredth": float(np.float32(1.0) / np.float32(100.0)),
    "mser max variation": BASE.max_variation,
    "mser min diversity": BASE.min_diversity,
    "mser inf": float("inf"),
    "mser 253": 253.0,
    "mser_cuda area cap": 65535.0,
    "hog bins": hog._NB / (2.0 * math.pi),
    "hog hys": 36 * 0.1,
    "hog eps": 1e-3,
    "recognizer -inf": float("-inf"),
    "rec_pipeline vote": 1.0 / 4,
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_constant_is_resident(name):
    """``ops/resident.py: const_f32``: one tensor a value and device, with
    the value and dtype that ``torch.tensor(v, dtype=float32)`` gives."""
    v = CONSTANTS[name]
    got = res.const_f32(v, "cpu")
    assert got is res.const_f32(v, torch.device("cpu"))
    assert got is res.resident(res.scalar, v, torch.float32, device="cpu")
    want = torch.tensor(v, dtype=torch.float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


ARRAYS = {
    "hog spatial weights": (lambda: res.resident(hog._spatial_weights, device="cpu"),
                            lambda: torch.from_numpy(hog._spatial_weights())),
    "resize_batch box": (lambda: res.resident(resize._whole_box, 30, 40, device="cpu"),
                         lambda: torch.tensor([0, 0, 30, 40], dtype=torch.int32)),
    "gamma lut": (lambda: res.resident(color.gamma_lut, 1.5, device="cpu"),
                  lambda: torch.from_numpy(color.gamma_lut(1.5))),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_array_is_resident(name):
    made, want = ARRAYS[name]
    got = made()
    assert got is made()
    assert got.dtype == want().dtype and torch.equal(got, want())


def test_clahe_coords_are_resident():
    """The plain K2's coordinate tables: the same tensors at each call,
    equal to the tables built from ``_interp_coords``."""
    got = clahe_cuda._coords(32, 48, 8, torch.device("cpu"))
    assert all(a is b for a, b in zip(got, clahe_cuda._coords(32, 48, 8, torch.device("cpu"))))
    ty1, ty2, ya = clahe._interp_coords(32, 8, 4)
    tx1, tx2, xa = clahe._interp_coords(48, 8, 6)
    want = [torch.from_numpy(a).to(d) for a, d in [
        (ty1, torch.int32), (ty2, torch.int32), (ya, torch.float32),
        (tx1, torch.int32), (tx2, torch.int32), (xa, torch.float32)]]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_resident_made_under_inference_mode_is_a_normal_tensor():
    """A constant first made inside ``inference_mode`` (the recognition
    dispatch) serves later autograd-recorded code too."""
    with torch.inference_mode():
        c = res.const_f32(0.123456, "cpu")
    assert not c.is_inference()
    x = torch.ones(3, requires_grad=True)
    (x * c).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), c.item()))


def test_replicas_copy_once_per_device():
    """The sharded dispatches copy the templates and classifier arrays to a
    shard's device at the first batch and reuse the copies; new tensors are
    copied anew."""
    on = tmesh._replicas()
    meta = torch.device("meta")
    a, b = torch.ones(3), torch.zeros(2)
    first = on(meta, (a, b))
    assert all(t.device == meta for t in first)
    assert all(x is y for x, y in zip(first, on(meta, (a, b))))
    again = on(meta, (a, torch.zeros(2)))
    assert again[0] is not first[0] and again[1] is not first[1]
    cpu = on(torch.device("cpu"), (a, b))
    assert cpu[0] is a and cpu[1] is b
