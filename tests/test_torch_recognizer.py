"""PyTorch port vs the JAX reference: the práctica-2 recognizer.

The same numpy-seeded features, crops and synthetic GTSDB-style frames
(``data/synthetic.py: write_gt_dir``, 2 frames of 192x192 with signs of all
six super-types) go through both packages' ``models/lda.py``,
``models/knn.py`` and ``models/recognizer.py``.  The reference runs its
Pallas refine through the interpreter (``TSD_PALLAS_INTERPRET=1``); its
recognition sweep has pointer jumps, so it takes no other kernel.

Tolerances: ``lda_fit`` arrays equal (both fit in the same host numpy);
probabilities and transforms within 1e-5; KNN labels equal, ties included;
MSER proposals, their crops and the training crops equal; validation
confusion matrix, report and accuracy equal; proposal caches and
classifier directories written by either package are read by the other.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.knn as jknn
import opencv_traffic_sign_detector_tpu.models.lda as jlda
import opencv_traffic_sign_detector_tpu.models.recognizer as jrec
import opencv_traffic_sign_detector_tpu.ops.geometry as jgeo
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.knn as tknn
import opencv_traffic_sign_detector_tpu_torch.models.lda as tlda
import opencv_traffic_sign_detector_tpu_torch.models.recognizer as trec
import opencv_traffic_sign_detector_tpu_torch.ops.geometry as tgeo
from opencv_traffic_sign_detector_tpu.config import ClassifierConfig, MSERConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_gt_dir

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_PARAMS = os.path.join(REPO, "artifacts", "cnn_detector", "params.npz")
SPECS = ["HOG_LDA_LDABAYES", "HOG_LDA_KNN", "GRAY_LDA_LDABAYES", "GRAY_LDA_KNN"]
# the recognizer's default MSER config (--downscale 1, pointer jumps) with
# 96 regions a frame instead of 384: the CPU refine floods 4x fewer windows
MINE = MSERConfig(max_regions=96)


def _t(cfg):
    """The same config from the port's own config module."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _features(seed: int, per: int = 40, d: int = 24) -> dict[int, np.ndarray]:
    """Class c > 0 lights up its own dimension (separable heads)."""
    rng = np.random.default_rng(seed)
    out = {}
    for c in range(7):
        center = np.zeros(d)
        if c > 0:
            center[c] = 5.0
        out[c] = (center + rng.normal(0, 0.7, (per, d))).astype(np.float32)
    return out


# --- LDA, KNN, arbitration, IoU ------------------------------------------

@pytest.mark.parametrize("classes", [2, 7])
def test_lda_fit_equal_and_inference_close(classes):
    feats = _features(3)
    X = np.concatenate([feats[c] for c in range(classes)])
    y = np.concatenate([np.full(len(feats[c]), c) for c in range(classes)])
    want, got = jlda.lda_fit(X, y), tlda.lda_fit(X, y)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
    np.testing.assert_allclose(tlda.lda_transform(got, X).numpy(),
                               np.asarray(jlda.lda_transform(want, X)), atol=1e-5)
    np.testing.assert_allclose(tlda.lda_decision(got, X).numpy(),
                               np.asarray(jlda.lda_decision(want, X)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tlda.lda_predict_proba(got, X).numpy(),
                               np.asarray(jlda.lda_predict_proba(want, X)), atol=1e-5)


def test_lda_params_save_load_cross(tmp_path):
    feats = _features(4)
    X = np.concatenate([feats[0], feats[2]])
    y = np.concatenate([np.zeros(len(feats[0])), np.full(len(feats[2]), 2)])
    jlda.lda_fit(X, y).save(str(tmp_path / "j.npz"))
    tlda.lda_fit(X, y).save(str(tmp_path / "t.npz"))
    a, b = tlda.LDAParams.load(str(tmp_path / "j.npz")), jlda.LDAParams.load(str(tmp_path / "t.npz"))
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_knn_labels_equal_with_ties():
    """Integer-valued points make every distance exact: duplicated training
    points tie, and both packages must take the lower index among them
    (which decides the vote), then the smallest label among tied votes."""
    rng = np.random.default_rng(5)
    base = rng.integers(-4, 5, (12, 3)).astype(np.float32)
    train_x = np.concatenate([base, base, base[:6]])  # exact duplicates
    train_y = np.concatenate([np.arange(12) % 4, (np.arange(12) + 1) % 4, np.arange(6) % 3])
    queries = np.concatenate([base, rng.integers(-4, 5, (40, 3)).astype(np.float32)])
    for k in (1, 2, 3, 4, 6):
        want = np.asarray(jknn.knn_predict(jknn.knn_fit(train_x, train_y, k), queries))
        got = tknn.knn_predict(tknn.knn_fit(train_x, train_y, k), queries).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_arbitration_equal(margin):
    rng = np.random.default_rng(6)
    p1 = rng.random((6, 300)).astype(np.float32)
    p1[:, :20] = 0.5  # ties at the threshold and between heads
    p1[2, 20:40] = p1[4, 20:40] = 0.9
    probs = np.stack([1.0 - p1, p1], axis=-1)
    for tol in (0.5, 0.6):
        want = np.asarray(jrec.arbitrate_lda_heads(jnp.asarray(probs), tol, margin))
        got = trec.arbitrate_lda_heads(torch.from_numpy(probs), tol, margin).numpy()
        np.testing.assert_array_equal(got, want)


def test_iou_matrix_equal():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 60, (50, 4)).astype(np.int32)
    a[:, 2:] += a[:, :2]
    b = np.concatenate([a[:5], a[5:15] + 3]).astype(np.int32)
    np.testing.assert_array_equal(tgeo.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jgeo.iou_matrix(a, b)))


@pytest.mark.parametrize("spec", SPECS)
def test_fit_and_predict_classifier_equal(spec):
    cfg = ClassifierConfig.from_string(spec)
    train, test = _features(8), _features(9, per=15)
    want_clf, got_clf = jrec.fit_classifier(train, cfg), trec.fit_classifier(train, _t(cfg))
    X = np.concatenate([test[c] for c in range(7)])
    if cfg.classifier == "KNN":
        np.testing.assert_allclose(got_clf.knn.train_x, want_clf.knn.train_x, atol=1e-5)
    np.testing.assert_array_equal(trec.predict_classifier(got_clf, X, device="cpu"),
                                  jrec.predict_classifier(want_clf, X))


# --- proposals, training data, validation -----------------------------------

@pytest.fixture(scope="module")
def mined(tmp_path_factory):
    """Both packages mine MSER proposals (:data:`MINE`) into their own
    caches."""
    root = tmp_path_factory.mktemp("rec")
    train = str(root / "train")
    write_gt_dir(train, 2, 192, 192, seed=6, signs_per_frame=4)
    caches = {"jax": str(root / "jax_cache.npz"), "port": str(root / "port_cache.npz")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TSD_PALLAS_INTERPRET", "1")
        jax.clear_caches()
        want = jrec.extract_train_proposals(train, MINE, cache_path=caches["jax"],
                                            batch_size=2)
    jax.clear_caches()
    got = trec.extract_train_proposals(train, _t(MINE), cache_path=caches["port"],
                                       batch_size=2, device="cpu")
    return train, want, got, caches


def _same_proposals(a, b):
    assert list(a) == list(b)
    for f in a:
        for x, y in zip(a[f], b[f]):
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_mser_proposals_equal(mined):
    _, want, got, _ = mined
    assert sum(len(b) for b, _ in want.values()) > 0, "no proposals; pick another seed"
    _same_proposals(got, want)


def test_proposal_caches_cross_load(mined, monkeypatch):
    """Each package reads the other's cache (same tag and layout) instead
    of mining again."""
    train, want, _, caches = mined

    def no_mining(*a, **kw):
        raise AssertionError("mined again instead of reading the cache")

    monkeypatch.setattr(trec, "propose_batch", no_mining)
    monkeypatch.setattr(jrec, "_propose_batch_fn", no_mining)
    _same_proposals(trec.extract_train_proposals(train, _t(MINE), cache_path=caches["jax"],
                                                 batch_size=2, device="cpu"), want)
    _same_proposals(jrec.extract_train_proposals(train, MINE, cache_path=caches["port"],
                                                 batch_size=2), want)


@pytest.mark.parametrize("proposal_positives", [False, True])
def test_build_training_data_equal(mined, proposal_positives):
    train, want_props, _, _ = mined
    want = jrec.build_training_data(train, proposals=want_props,
                                    proposal_positives=proposal_positives)
    got = trec.build_training_data(train, proposals=want_props, device="cpu",
                                   proposal_positives=proposal_positives)
    assert [len(got[c]) for c in range(7)] == [len(want[c]) for c in range(7)]
    assert all(len(want[c]) for c in range(7)), "a class without crops; pick another seed"
    for c in range(7):
        np.testing.assert_array_equal(got[c], want[c], err_msg=f"class {c}")


@pytest.mark.parametrize("spec", SPECS)
def test_run_validation_equal(mined, spec, tmp_path):
    """Same confusion matrix, report and accuracy; then the reference loads
    the port's classifier directory and the port the reference's, and each
    predicts as the one that saved it."""
    train, props, _, _ = mined
    cfg = ClassifierConfig.from_string(spec)
    want = jrec.run_validation(train, mser_cfg=MINE, clf_cfg=cfg, proposals=props,
                               validation_pct=0.4)
    got = trec.run_validation(train, mser_cfg=_t(MINE), clf_cfg=_t(cfg), proposals=props,
                              validation_pct=0.4, device="cpu")
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.report == want.report
    assert got.accuracy == want.accuracy
    np.testing.assert_array_equal(got.y_true, want.y_true)
    assert got.classifier.proposal_spec == want.classifier.proposal_spec

    feats = trec.compute_features_dict(trec.build_training_data(train, proposals=props,
                                                                device="cpu"),
                                       cfg.features, "cpu")
    X = np.concatenate([feats[c] for c in range(7)])
    want.classifier.save(str(tmp_path / "jax"))
    got.classifier.save(str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    from_jax = trec.SignClassifier.load(str(tmp_path / "jax"))
    from_port = jrec.SignClassifier.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(trec.predict_classifier(from_jax, X, device="cpu"),
                                  jrec.predict_classifier(want.classifier, X))
    np.testing.assert_array_equal(jrec.predict_classifier(from_port, X),
                                  trec.predict_classifier(got.classifier, X, device="cpu"))


def test_compute_features_equal(mined):
    train, props, _, _ = mined
    data = trec.build_training_data(train, proposals=props, device="cpu")
    crops = np.concatenate([data[c] for c in range(7)])
    np.testing.assert_allclose(trec.compute_features(crops, "HOG", "cpu"),
                               jrec.compute_features(crops, "HOG"), atol=1e-5)
    np.testing.assert_array_equal(trec.compute_features(crops[:0], "GRAY", "cpu"),
                                  jrec.compute_features(crops[:0], "GRAY"))


# --- CNN proposals -------------------------------------------------------------

def test_params_digest_equal():
    want = jrec.params_digest(jcd.CNNDetector.load(CNN_PARAMS))
    got = trec.params_digest(tcd.CNNDetector.load(CNN_PARAMS, device="cpu"))
    assert got == want


def test_cnn_proposal_caches_cross_load(mined, tmp_path, monkeypatch):
    """The CNN proposal cache's tag carries the parameter digest: a cache
    that the reference wrote is read by the port without running the
    detector, and the other way round."""
    train = mined[0]
    jdet = jcd.CNNDetector.load(CNN_PARAMS)
    jdet.cfg = dataclasses.replace(jdet.cfg, score_threshold=0.1)
    tdet = tcd.CNNDetector.load(CNN_PARAMS, device="cpu")
    tdet.cfg = dataclasses.replace(tdet.cfg, score_threshold=0.1)
    jc, tc = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = jrec.extract_train_proposals_cnn(train, jdet, cache_path=jc, batch_size=2)
    got = trec.extract_train_proposals_cnn(train, tdet, cache_path=tc, batch_size=2)
    assert list(got) == list(want)
    assert sum(len(b) for b, _ in want.values()) > 0, "no CNN proposals"

    def no_detector(*a, **kw):
        raise AssertionError("ran the detector instead of reading the cache")

    monkeypatch.setattr(tdet, "dispatch", no_detector)
    monkeypatch.setattr(jdet, "dispatch", no_detector)
    _same_proposals(trec.extract_train_proposals_cnn(train, tdet, cache_path=jc,
                                                     batch_size=2), want)
    _same_proposals(jrec.extract_train_proposals_cnn(train, jdet, cache_path=tc,
                                                     batch_size=2), got)


def test_run_validation_rejects_mesh(mined):
    """``run_validation(mesh=...)``, once refused, now fits the LDABAYES
    heads from statistics summed over a mesh: the port's 8 CPU shards
    against the reference's virtual 8-device mesh give the same confusion
    matrix, report and accuracy.  Each head's 324-dim covariance of a few
    dozen HOG descriptors is near singular, so its coefficients differ by
    far more than the f32 rounding on either side (as the reference's own
    sharded and unsharded fits do); both packages' heads are held to the
    head's training statistics instead: normwise backward error and
    intercept within 1e-5 (``tests/test_torch_parallel.py``)."""
    from opencv_traffic_sign_detector_tpu.parallel.mesh import data_mesh as jdata_mesh
    from opencv_traffic_sign_detector_tpu_torch.parallel.mesh import data_mesh

    train, props, _, _ = mined
    cfg = ClassifierConfig.from_string("HOG_LDA_LDABAYES")
    want = jrec.run_validation(train, mser_cfg=MINE, clf_cfg=cfg, proposals=props,
                               validation_pct=0.4, mesh=jdata_mesh())
    got = trec.run_validation(train, mser_cfg=_t(MINE), clf_cfg=_t(cfg), proposals=props,
                              validation_pct=0.4, device="cpu",
                              mesh=data_mesh(8, device="cpu"))
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.report == want.report
    assert got.accuracy == want.accuracy
    from opencv_traffic_sign_detector_tpu_torch.parallel.train import _class_statistics
    from test_torch_parallel import _backward_error

    data = trec.build_training_data(train, mser_cfg=_t(MINE), proposals=props, device="cpu")
    feats = trec.compute_features_dict(trec.split_validation(data, 0.4)[0], "HOG", "cpu")
    for t, (g, r) in enumerate(zip(got.classifier.heads, want.classifier.heads), start=1):
        assert (g is None) == (r is None) and (r is None) == (len(feats[t]) == 0)
        if r is None:
            continue
        assert not r.xbar.any() and not g.xbar.any()
        X = np.concatenate([feats[0], feats[t]])
        y = np.concatenate([np.zeros(len(feats[0])), np.ones(len(feats[t]))])
        stats = [a.numpy() for a in _class_statistics(
            torch.from_numpy(X), torch.from_numpy(y), torch.ones(len(y)), n_classes=2)]
        for head in (g, r):
            eta, int_err = _backward_error(head.coef, head.intercept, stats)
            assert eta <= 1e-5 and int_err <= 1e-5, (t, eta, int_err)
