"""PyTorch port vs the JAX reference: batched recognition inference.

``RecognitionPipeline`` with the shipped ``artifacts/sign_classifier_r5_cnn/``
(HOG_LDA_LDABAYES) runs on a synthetic GTSDB-style frame of 192x192 through
both packages, from MSER proposals (the recognizer's default config,
384 regions; the reference's Pallas refine through the interpreter) and from
the CNN detector's low-threshold boxes.  MSER records must be equal (boxes
and classes exact, scores within 1e-5); CNN records agree within the CNN
parity bound (boxes within 1 px, scores within 1e-5 where the box is the
same) because the detector's bf16 boxes may move a grown crop by a pixel.
The pieces -- the fused LDA heads, the KNN vote, the box growth and the
stacked heads -- are held against the reference on seeded inputs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.rec_pipeline as jrp
import opencv_traffic_sign_detector_tpu.models.recognizer as jrec
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline as trp
import opencv_traffic_sign_detector_tpu_torch.models.recognizer as trec
from opencv_traffic_sign_detector_tpu.config import ClassifierConfig, MSERConfig, PipelineConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_gt_dir

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLF = os.path.join(REPO, "artifacts", "sign_classifier_r5_cnn")
CNN_PARAMS = os.path.join(REPO, "artifacts", "cnn_detector", "params.npz")


def _t(cfg):
    """The same config from the port's own config module."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, PipelineConfig):
        fields["mser"] = _t(cfg.mser)
    return getattr(tcfg, type(cfg).__name__)(**fields)


def _features(seed: int, per: int = 30, d: int = 24) -> dict[int, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for c in range(7):
        center = np.zeros(d)
        if c > 0:
            center[c] = 5.0
        out[c] = (center + rng.normal(0, 0.7, (per, d))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("recpipe") / "test")
    write_gt_dir(d, 1, 192, 192, seed=8, signs_per_frame=4)
    return d


def _rows(dets):
    return [(d.filename, d.x1, d.y1, d.x2, d.y2, d.class_id) for d in dets]


def test_mser_records_equal(frames_dir, monkeypatch):
    cfg = PipelineConfig(mser=MSERConfig(), batch_size=1)
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    want = jrp.RecognitionPipeline(cfg=cfg, classifier=jrec.SignClassifier.load(CLF)
                                   ).run_directory(frames_dir)
    jax.clear_caches()
    got = trp.RecognitionPipeline(cfg=_t(cfg), classifier=trec.SignClassifier.load(CLF),
                                  device="cpu").run_directory(frames_dir)
    assert want, "the reference recognized nothing; pick another seed"
    assert _rows(got) == _rows(want)
    np.testing.assert_allclose([d.score for d in got], [d.score for d in want], atol=1e-5)


def test_cnn_records_agree(frames_dir):
    cfg = PipelineConfig(batch_size=1)
    jdet = jcd.CNNDetector.load(CNN_PARAMS)
    jdet.cfg = dataclasses.replace(jdet.cfg, score_threshold=0.1)
    tdet = tcd.CNNDetector.load(CNN_PARAMS, device="cpu")
    tdet.cfg = dataclasses.replace(tdet.cfg, score_threshold=0.1)
    want = jrp.RecognitionPipeline(cfg=cfg, classifier=jrec.SignClassifier.load(CLF),
                                   cnn=jdet).run_directory(frames_dir)
    got = trp.RecognitionPipeline(cfg=_t(cfg), classifier=trec.SignClassifier.load(CLF),
                                  cnn=tdet).run_directory(frames_dir)
    assert want, "the reference recognized nothing; pick another seed"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.filename, g.class_id) == (w.filename, w.class_id)
        assert max(abs(g.x1 - w.x1), abs(g.y1 - w.y1), abs(g.x2 - w.x2), abs(g.y2 - w.y2)) <= 1
        if (g.x1, g.y1, g.x2, g.y2) == (w.x1, w.y1, w.x2, w.y2):
            assert abs(g.score - w.score) <= 1e-5


@pytest.mark.parametrize("margin", [0.0, 0.1])
def test_classify_crops_lda_equal(margin):
    feats = _features(1)
    clf = jrec.fit_classifier(feats, ClassifierConfig.from_string("HOG_LDA_LDABAYES"))
    X = np.concatenate([feats[c][:10] for c in range(7)])
    coefs, ints = jrp._stack_heads(clf)
    tcoefs, tints = trp._stack_heads(clf)
    np.testing.assert_array_equal(tcoefs, coefs)
    want = [np.asarray(x) for x in jrp.classify_crops_lda(X, coefs, ints, 0.5, margin)]
    got = [x.numpy() for x in trp.classify_crops_lda(
        torch.from_numpy(X), torch.from_numpy(tcoefs), torch.from_numpy(tints), 0.5, margin)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)


@pytest.mark.parametrize("k", [3, 4])
def test_classify_crops_knn_equal(k):
    feats = _features(2)
    clf = jrec.fit_classifier(feats, ClassifierConfig.from_string("HOG_LDA_KNN"))
    X = np.concatenate([feats[c][:8] for c in range(7)])
    arrays = (clf.reducer.xbar.astype(np.float32), clf.reducer.scalings.astype(np.float32),
              clf.knn.train_x.astype(np.float32), clf.knn.train_y.astype(np.int32),
              clf.knn.classes.astype(np.int32))
    want = [np.asarray(x) for x in jax.jit(jrp.classify_crops_knn, static_argnums=6)(
        jnp.asarray(X), *arrays, k)]
    got = [x.numpy() for x in trp.classify_crops_knn(
        torch.from_numpy(X), *(torch.from_numpy(a) for a in arrays), k)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_grow_boxes_xyxy_equal():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-20, 200, (2, 64, 2)).astype(np.float32)
    wh = rng.uniform(0, 90, (2, 64, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    valid = rng.random((2, 64)) < 0.8
    fn = jax.jit(jax.vmap(lambda b, v: jrp.grow_boxes_xyxy(b, v, 1.15, (180, 200))))
    want = [np.asarray(x) for x in fn(jnp.asarray(boxes), jnp.asarray(valid))]
    got = [x.numpy() for x in trp.grow_boxes_xyxy(torch.from_numpy(boxes),
                                                  torch.from_numpy(valid), 1.15, (180, 200))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
