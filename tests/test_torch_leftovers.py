"""PyTorch port vs the JAX reference: the public functions that no pipeline
path of the port calls but that the JAX package exports.

Connected-component labelling (``ops/ccl.py``: the scatter-min hook with
pointer jumps, the segmented-scan form and the area lookup), the batched
``mser_regions``, one-frame detection and recognition, box midpoints,
whole-image resizes, the checkpoint's arch tag and the two-stage CNN
route's upscale.  Inputs are made with numpy from a seed; every comparison
is exact unless a test states its tolerance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.detector as jdet
import opencv_traffic_sign_detector_tpu.models.mean_masks as jmm
import opencv_traffic_sign_detector_tpu.models.rec_pipeline as jrp
import opencv_traffic_sign_detector_tpu.models.recognizer as jrec
import opencv_traffic_sign_detector_tpu.ops.ccl as jccl
import opencv_traffic_sign_detector_tpu.ops.geometry as jgeo
import opencv_traffic_sign_detector_tpu.ops.mser as jmser
import opencv_traffic_sign_detector_tpu.ops.preprocess as jpre
import opencv_traffic_sign_detector_tpu.ops.resize as jres
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.detector as tdet
import opencv_traffic_sign_detector_tpu_torch.models.mean_masks as tmm
import opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline as trp
import opencv_traffic_sign_detector_tpu_torch.ops.ccl as tccl
import opencv_traffic_sign_detector_tpu_torch.ops.geometry as tgeo
import opencv_traffic_sign_detector_tpu_torch.ops.mser as tmser
import opencv_traffic_sign_detector_tpu_torch.ops.resize as tres
from opencv_traffic_sign_detector_tpu.config import MSERConfig, PipelineConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLF = os.path.join(REPO, "artifacts", "sign_classifier_r5_cnn")
TUNED = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                   downscale=2, max_regions=128, ccl_iters=2, ccl_jumps=0,
                   level_step=9, refine_scan_passes=2)


def _t(cfg):
    """The same config from the port's own config module."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, PipelineConfig):
        fields["mser"] = _t(cfg.mser)
    return getattr(tcfg, type(cfg).__name__)(**fields)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _blobs(seed: int, h: int = 40, w: int = 56, density: float = 0.55) -> np.ndarray:
    """A bool mask of random blobs and serpentines: noise, thresholded
    after a 3x3 box mean."""
    rng = np.random.default_rng(seed)
    x = rng.random((h + 2, w + 2))
    mean = sum(x[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)) / 9
    return mean < np.quantile(mean, density)


# --- ops/ccl.py ------------------------------------------------------------------

@pytest.mark.parametrize("seed,iters,warm", [(0, 8, False), (1, 2, False), (2, 8, True),
                                             (3, 1, True)])
def test_label_components_equal(seed, iters, warm):
    mask = _blobs(seed)
    init = None
    if warm:  # labels of a subset mask, as the level sweep warm-starts
        init = np.array(jccl.label_components(jnp.asarray(mask & _blobs(seed + 10)), 8))
    want = np.asarray(jccl.label_components(
        jnp.asarray(mask), iters, None if init is None else jnp.asarray(init)))
    got = tccl.label_components(torch.from_numpy(mask), iters,
                                None if init is None else torch.from_numpy(init))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,iters,warm", [(4, 4, False), (5, 1, False), (6, 3, True)])
def test_label_components_scan_equal(seed, iters, warm):
    mask = _blobs(seed, 33, 47)
    init = np.array(jccl.label_components(jnp.asarray(mask & _blobs(seed + 10, 33, 47))))
    args = (iters, init if warm else None)
    want = np.asarray(jccl.label_components_scan(
        jnp.asarray(mask), iters, jnp.asarray(init) if warm else None))
    got = tccl.label_components_scan(torch.from_numpy(mask), args[0],
                                     torch.from_numpy(init) if warm else None)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [65535, 7])
def test_component_areas_equal(cap):
    labels = np.array(jccl.label_components(jnp.asarray(_blobs(7)), 12))
    want = np.asarray(jccl.component_areas(jnp.asarray(labels), cap))
    got = tccl.component_areas(torch.from_numpy(labels), cap)
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(got.numpy(), want)


# --- ops/geometry.py, ops/resize.py ---------------------------------------------

def test_mean_coords_equal():
    rng = np.random.default_rng(8)
    a = rng.integers(-50, 1400, (64, 4)).astype(np.int32)
    b = rng.integers(-50, 1400, (64, 4)).astype(np.int32)
    want = np.asarray(jgeo.mean_coords(jnp.asarray(a), jnp.asarray(b)))
    got = tgeo.mean_coords(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,out", [((3, 40, 52, 3), 25), ((2, 200, 236, 3), 64),
                                       ((4, 30, 30), 40), ((2, 196, 210), 25)],
                         ids=["gather-bgr", "window-bgr", "gather-gray", "window-gray"])
def test_resize_batch_equal(shape, out):
    images = np.random.default_rng(9).integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(jres.resize_batch(jnp.asarray(images), out))
    got = tres.resize_batch(torch.from_numpy(images), out)
    np.testing.assert_array_equal(got.numpy(), want)


# --- ops/mser.py ----------------------------------------------------------------

def test_mser_regions_batch_equal(interpret):
    gray = np.array(jpre.enhance_contrast(jnp.asarray(make_frames(2, 96, 128, seed=12))))
    want = [np.asarray(x) for x in jmser.mser_regions_batch(jnp.asarray(gray), TUNED)]
    got = tmser.mser_regions_batch(torch.from_numpy(gray), _t(TUNED))
    assert want[1].sum() > 0, "no proposals to compare; pick another seed"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# --- one frame through detection and recognition --------------------------------

def test_detect_frame_matches_reference(interpret):
    """Against the reference's ``detect_frame`` under jit, as its
    ``detect_batch`` runs it: types equal, boxes IoU 1 (equal), scores
    within 1e-6 (tests/test_torch_detector.py's bound)."""
    templates = jmm.MeanMaskTemplates.load(os.path.join(REPO, "artifacts", "mean_masks.npz"))
    frame = make_frames(1, 256, 256, seed=21)[0]
    cfg = PipelineConfig(mser=TUNED, batch_size=1)
    want = [np.asarray(x) for x in jax.jit(jdet.detect_frame, static_argnames="cfg")(
        jnp.asarray(frame), jnp.asarray(templates.red), jnp.asarray(templates.blue), cfg=cfg)]
    red, blue = tmm.templates_to_torch(templates, "cpu")
    got = [x.numpy() for x in tdet.detect_frame(torch.from_numpy(frame), red, blue, _t(cfg))]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert want[3].sum() > 0, "the reference detected nothing; pick another seed"
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[0][got[3]], want[0][want[3]])
    np.testing.assert_array_equal(got[1][got[3]], want[1][want[3]])
    np.testing.assert_allclose(got[2][got[3]], want[2][want[3]], atol=1e-6)


def test_recognize_frame_matches_reference(interpret):
    """Against the reference's ``recognize_frame`` under jit, with the
    shipped HOG_LDA_LDABAYES heads: boxes and labels equal, scores within
    1e-5 (tests/test_torch_rec_pipeline.py's bound)."""
    clf = jrec.SignClassifier.load(CLF)
    frame = make_frames(1, 192, 192, seed=8)[0]
    cfg = PipelineConfig(mser=MSERConfig(), batch_size=1)
    arrays = jrp._stack_heads(clf)
    feats = clf.config.features
    want = [np.asarray(x) for x in jax.jit(
        jrp.recognize_frame, static_argnames=("cfg", "features", "clf_kind"))(
        jnp.asarray(frame), tuple(jnp.asarray(a) for a in arrays), cfg=cfg, features=feats,
        clf_kind="LDABAYES")]
    got = [x.numpy() for x in trp.recognize_frame(
        torch.from_numpy(frame), tuple(torch.from_numpy(a) for a in arrays), _t(cfg), feats,
        "LDABAYES")]
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[0][got[3]], want[0][want[3]])
    np.testing.assert_array_equal(got[1][got[3]], want[1][want[3]])
    np.testing.assert_allclose(got[2][got[3]], want[2][want[3]], atol=1e-5)


# --- models/cnn_detector.py -----------------------------------------------------

def test_saved_arch_equal(tmp_path):
    untagged = str(tmp_path / "untagged.npz")
    np.savez(untagged, w=np.zeros(3, np.float32))
    paths = [os.path.join(REPO, "artifacts", "cnn_detector", n)
             for n in ("params.npz", "params_slim.npz", "params_v3.npz")] + [untagged]
    got = [tcd.saved_arch(p) for p in paths]
    assert got == [jcd.saved_arch(p) for p in paths]
    assert got[-1] is None and any(a is not None for a in got)


@pytest.mark.parametrize("thw", [(24, 40), (36, 52), (20, 20)])
def test_upscale_frames_within_one_count(thw):
    """The upscale's f32 products sum in another order than XLA's: values
    within one count, at most 0.2% of them off (a .5 that rounds the other
    way), the bound of tests/test_torch_yuv_upscale.py."""
    frames = np.random.default_rng(10).integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    want = np.asarray(jcd.upscale_frames(jnp.asarray(frames), *thw))
    got = tcd.upscale_frames(torch.from_numpy(frames), *thw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 0.002, (diff != 0).mean()
