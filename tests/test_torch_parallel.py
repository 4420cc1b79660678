"""PyTorch port vs the JAX reference: the data mesh, sharded detection and
recognition, and the statistics-sum LDA fits (``parallel/mesh.py``,
``parallel/train.py``, ``DetectionPipeline(mesh=...)``).

The reference runs on conftest's virtual 8-device CPU mesh, the port on a
CPU mesh of 8 shards run in turn (``data_mesh(8, device="cpu")``); the
same numpy-seeded inputs go to both.  Tolerances, each test restating its
own:

* shards, psum and pmean: exact;
* LDA fits on the reference test's separable 16-dim data: coef within
  rtol 2e-3 / atol 2e-3, intercept within rtol 2e-3 / atol 2e-2 (the
  bounds of ``tests/test_parallel.py`` between the reference's sharded
  and single-device fits);
* the SPMD train step on the dry run's planted frames: class counts
  exact, feature sums and second moments within 1e-5 of their largest
  magnitude.  The 324-dim pooled covariance of ~45 proposals is near
  singular (condition ~5e5): the reference's own sharded and unsharded
  fits differ by tens of percent a coefficient, so each side's fit is
  held to the reference's statistics by its normwise backward error
  ``|cov c - means| / (|cov| |c| + |means|)`` <= 1e-5 (both measure
  ~6e-7) and its intercept to ``-means . c / 2 + log prior`` within 1e-5
  of the largest;
* sharded detection and recognition: records and outputs equal to the
  unsharded port's and to the reference's (scores within 1e-5).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_detection_torch
import opencv_traffic_sign_detector_tpu.models.rec_pipeline as jrp
import opencv_traffic_sign_detector_tpu.parallel.mesh as jmesh
import opencv_traffic_sign_detector_tpu.parallel.train as jtrain
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.detector as tdet
import opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline as trp
import opencv_traffic_sign_detector_tpu_torch.parallel.mesh as tmesh
import opencv_traffic_sign_detector_tpu_torch.parallel.train as ttrain
from opencv_traffic_sign_detector_tpu.config import ClassifierConfig, MSERConfig, PipelineConfig
from opencv_traffic_sign_detector_tpu.models.detector import DetectionPipeline as JPipeline
from opencv_traffic_sign_detector_tpu.models.lda import lda_fit
from opencv_traffic_sign_detector_tpu.models.mean_masks import MeanMaskTemplates
from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
    MeanMaskTemplates as TTemplates,
)

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

# the dry run's config (``__graft_entry__.py: dryrun_multichip``)
DRY = MSERConfig(min_area=60, max_area=1200, max_variation=1.0, max_regions=32)


def _t(cfg):
    """The same config from the port's own config module."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, PipelineConfig):
        fields["mser"] = _t(cfg.mser)
    return getattr(tcfg, type(cfg).__name__)(**fields)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.data_mesh(8, device="cpu")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


# --- the mesh ------------------------------------------------------------------


def test_data_mesh_shapes_and_refusals(monkeypatch):
    m = tmesh.data_mesh(8, device="cpu")
    assert (m.size, m.shards, m.rank, m.world, m.group) == (8, 8, 0, 1, None)
    assert m.devices == (torch.device("cpu"),) * 8
    assert len(jmesh.data_mesh().devices) == m.shards
    assert tmesh.data_mesh(device="cpu").size == 1
    assert tmesh.data_mesh(devices=["cuda:1", "cuda:0"]).devices == (
        torch.device("cuda", 1), torch.device("cuda", 0))
    with pytest.raises(ValueError, match="one type"):
        tmesh.data_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="one type"):
        tmesh.data_mesh(devices=[])
    # the reference slices jax.devices()[:n]; the port refuses more cards
    # than it sees
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 > 1 visible"):
        tmesh.data_mesh(2)
    assert tmesh.data_mesh(1).devices == (torch.device("cuda", 0),)


def test_cli_n_devices_past_the_visible_cards_exits_2(monkeypatch, capsys):
    """As ``main_recognition.py`` refuses more devices than it sees."""
    import main_recognition_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main_detection_torch.main(["--n_devices", "2"]) == 2
    assert "--n_devices 2 > 1 visible" in capsys.readouterr().out
    assert main_recognition_torch.main(["--n_devices", "3", "--proposals", "MSER"]) == 2
    assert "--n_devices 3 > 1 visible" in capsys.readouterr().out


def test_shard_batch_splits_like_the_reference(mesh):
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8 * 4, 3)
    shards = tmesh.shard_batch(mesh, x)
    ref = jmesh.shard_batch(jmesh.data_mesh(), x)
    want = sorted((s.index[0].start, np.asarray(s.data)) for s in ref.addressable_shards)
    assert len(shards) == len(want) == 8
    for got, (_, w) in zip(shards, want):
        np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(mesh, x[:7])


def test_psum_pmean_and_unshard(mesh):
    parts = [torch.full((3,), float(i)) for i in range(8)]
    assert torch.equal(tmesh.psum(mesh, parts), torch.full((3,), 28.0))
    assert torch.equal(tmesh.pmean(mesh, parts), torch.full((3,), 3.5))
    assert parts[0].sum() == 0, "psum wrote into its input"
    ints = [torch.tensor([i, 1]) for i in range(8)]
    assert tmesh.psum(mesh, ints).tolist() == [28, 8]
    with pytest.raises(ValueError, match="parts for 8 shards"):
        tmesh.psum(mesh, parts[:2])
    out = tmesh.unshard([(torch.tensor([i]), torch.tensor([[i, i]])) for i in range(3)])
    assert out[0].tolist() == [0, 1, 2] and out[1].tolist() == [[0, 0], [1, 1], [2, 2]]
    host, done = tmesh.to_host(mesh, [torch.tensor([i]) for i in range(8)])
    assert host.tolist() == list(range(8)) and done == []


# --- LDA from statistics -------------------------------------------------------


def _separable(seed=13, n=8 * 50, d=16):
    """``tests/test_parallel.py``'s data: seven classes, shifted apart."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = rng.integers(0, 7, n).astype(np.int32)
    for c in range(7):
        X[y == c, c % d] += 4.0
    return X, y, np.ones(n, np.float32)


def test_class_statistics_and_lda_from_statistics_match_reference():
    """Statistics within 1e-5 of their largest magnitude (counts exact);
    the fit from the same statistics within the reference test's bounds."""
    X, y, w = _separable()
    w[::5] = 0.5
    want = jtrain._class_statistics(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w))
    got = ttrain._class_statistics(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, r in zip(got[1:], want[1:]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    coef, intercept = jtrain.lda_from_statistics(*want)
    tcoef, tint = ttrain.lda_from_statistics(*(torch.from_numpy(np.array(a)) for a in want))
    np.testing.assert_allclose(tcoef.numpy(), np.asarray(coef), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tint.numpy(), np.asarray(intercept), rtol=2e-3, atol=2e-2)


def test_distributed_lda_fit_matches_reference(mesh):
    X, y, w = _separable()
    jm = jmesh.data_mesh()
    coef, intercept = jtrain.distributed_lda_fit(jm)(
        *(jmesh.shard_batch(jm, a) for a in (X, y, w)))
    tcoef, tint = ttrain.distributed_lda_fit(mesh)(*(tmesh.shard_batch(mesh, a)
                                                     for a in (X, y, w)))
    np.testing.assert_allclose(tcoef.numpy(), np.asarray(coef), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tint.numpy(), np.asarray(intercept), rtol=2e-3, atol=2e-2)
    scores = X @ tcoef.numpy().T + tint.numpy()
    assert (scores.argmax(1) == y).mean() > 0.9


def _head_features(seed=3, d=24):
    """Six types of separable positives (type 4 without any) and negatives."""
    rng = np.random.default_rng(seed)
    feats = {0: rng.normal(0, 1, (61, d)).astype(np.float32)}
    for t in range(1, 7):
        center = np.zeros(d)
        center[t] = 4.0
        n = 0 if t == 4 else 15 + 3 * t
        feats[t] = (center + rng.normal(0, 1, (n, d))).astype(np.float32)
    return feats


@pytest.mark.parametrize("spec", ["HOG_LDA_LDABAYES", "HOG_LDA_KNN"])
def test_fit_classifier_distributed_matches_reference(mesh, spec):
    """LDABAYES heads within the reference test's bounds (a None head where
    a type has no positives; zero ``xbar`` and ``scalings``); KNN falls
    back to the host fit: its reducer equal to the reference's, the reduced
    train set within 1e-5 (a product on either side)."""
    feats = _head_features()
    cfg = ClassifierConfig.from_string(spec)
    want = jtrain.fit_classifier_distributed(feats, cfg, jmesh.data_mesh())
    got = ttrain.fit_classifier_distributed(feats, _t(cfg), mesh)
    if spec.endswith("KNN"):
        np.testing.assert_array_equal(got.reducer.coef, want.reducer.coef)
        np.testing.assert_allclose(got.knn.train_x, want.knn.train_x, rtol=0, atol=1e-5)
        return
    assert [h is None for h in got.heads] == [h is None for h in want.heads]
    assert got.heads[3] is None
    for g, r in zip(got.heads, want.heads):
        if r is None:
            continue
        np.testing.assert_array_equal(g.classes, r.classes)
        np.testing.assert_array_equal(g.xbar, r.xbar)
        np.testing.assert_array_equal(g.scalings, r.scalings)
        np.testing.assert_allclose(g.coef, r.coef, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(g.intercept, r.intercept, rtol=2e-3, atol=2e-2)


# --- the SPMD train step --------------------------------------------------------


def _planted(n=8, h=96, w=96, g=2, seed=1):
    """The dry run's planted frames: a dark square "sign" a frame, its GT."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(90, 140, (n, h, w, 3), np.uint8)
    gt_boxes = np.zeros((n, g, 4), np.int32)
    gt_types = np.zeros((n, g), np.int32)
    for i in range(n):
        x, y = 20 + (i % 3) * 10, 30
        frames[i, y:y + 24, x:x + 24] = 25
        gt_boxes[i, 0] = (x, y, x + 24, y + 24)
        gt_types[i, 0] = 1 + (i % 6)
    return frames, gt_boxes, gt_types


def _backward_error(coef, intercept, stats) -> tuple[float, float]:
    """How far a fit (coef, intercept) is from solving the LDA system of
    ``stats`` (counts, sums, second moments), in f64: the normwise backward
    error of ``cov @ coef.T = means.T`` and the intercept's largest
    difference to ``-means . coef / 2 + log prior``, over its largest."""
    counts, sums, sq = (np.asarray(a, np.float64) for a in stats)
    coef, intercept = np.asarray(coef, np.float64), np.asarray(intercept, np.float64)
    n, (c, d) = counts.sum(), sums.shape
    means = sums / np.maximum(counts, 1.0)[:, None]
    cov = ((sq.sum(0) - np.einsum("c,cd,ce->de", counts, means, means)) / max(n - c, 1.0)
           + 1e-6 * np.eye(d))
    eta = np.linalg.norm(cov @ coef.T - means.T) / (
        np.linalg.norm(cov) * np.linalg.norm(coef) + np.linalg.norm(means))
    want = -0.5 * (means * coef).sum(1) + np.log(np.maximum(counts, 1e-6) / max(n, 1.0))
    return eta, np.abs(intercept - want).max() / np.abs(want).max()


@pytest.mark.parametrize("route", ["shard_map", "interpret"])
def test_distributed_train_step_matches_reference(mesh, route, monkeypatch):
    """The port's step over 8 CPU shards against the reference's.

    ``shard_map``: the reference's own step over its 8-device mesh.  On the
    CPU its refine floods by XLA rolls (the Pallas flood needs a TPU or
    the interpreter), so both sides run the dry run's config with the roll
    refine (``refine_scan_passes=0``).  ``interpret``: the dry run's config
    itself, its scan refine through the Pallas interpreter, held against
    the reference step's body (its jitted per-frame proposals and labels,
    then statistics and fit); the reference's ``shard_map`` refuses the
    interpreted kernel (``check_vma``).

    Class counts exact; statistics within 1e-5 of their largest; both fits
    within 1e-5 of solving the reference's statistics (module docstring).
    """
    batch = _planted()
    if route == "shard_map":
        cfg = dataclasses.replace(DRY, refine_scan_passes=0)
        jm = jmesh.data_mesh()
        coef, intercept, counts = (np.asarray(a) for a in jtrain.distributed_train_step(jm, cfg)(
            *(jmesh.shard_batch(jm, a) for a in batch)))
    else:
        cfg = DRY
        monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    fj, lj, wj = jax.jit(jax.vmap(
        lambda f, b, t: jtrain._propose_and_label(f, b, t, cfg, 1.15, 32)))(*batch)
    d = fj.shape[-1]
    stats = [np.asarray(a) for a in jtrain._class_statistics(
        fj.reshape(-1, d), lj.reshape(-1), wj.reshape(-1))]
    if route == "interpret":
        coef, intercept = (np.asarray(a) for a in jtrain.lda_from_statistics(*stats))
        counts = stats[0]
    jax.clear_caches()
    tcoef, tint, tcounts = ttrain.distributed_train_step(mesh, _t(cfg))(
        *(tmesh.shard_batch(mesh, a) for a in batch))
    assert tcoef.shape == (7, 324) and torch.isfinite(tcoef).all()
    np.testing.assert_array_equal(tcounts.numpy(), counts)
    np.testing.assert_array_equal(stats[0], counts)
    assert counts.sum() > 0 and (counts[1:] > 0).all()

    feats, labels, weights = ttrain._propose_and_label(
        *(torch.from_numpy(a) for a in batch), _t(cfg), 1.15, 32)
    got = ttrain._class_statistics(feats.reshape(-1, d), labels.reshape(-1),
                                   weights.reshape(-1))
    np.testing.assert_array_equal(got[0].numpy(), counts)
    for g, r in zip(got[1:], stats[1:]):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    for fit in ((coef, intercept), (tcoef.numpy(), tint.numpy())):
        eta, int_err = _backward_error(*fit, stats)
        assert eta <= 1e-5 and int_err <= 1e-5, (eta, int_err)


# --- sharded inference ------------------------------------------------------------


def _frames(seed, b=8, h=128, w=160):
    rng = np.random.default_rng(seed)
    frames = rng.integers(80, 170, (b, h, w, 3), np.uint8)
    for i in range(b):  # a dark square "sign" a frame
        x, y = 30 + (i % 4) * 12, 40
        frames[i, y:y + 20, x:x + 20] = 20
    return frames


PCFG = PipelineConfig(mser=DRY, max_detections=16, batch_size=8)


def test_sharded_recognize_matches_reference(mesh, interpret):
    """``tests/test_parallel.py``'s sharded recognition: six LDA heads on
    separable HOG-sized features, their sign scores raised by 45 so that
    proposals are recognised; the port's 8 shards give the unsharded
    port's outputs exactly and the reference's sharded outputs (boxes,
    labels, valid exact; scores within 1e-5)."""
    coefs, ints = [], []
    for hseed in range(6):
        r = np.random.default_rng(hseed)
        X = np.concatenate([r.normal(0, 1, (40, 324)), r.normal(2, 1, (40, 324))]).astype(
            np.float32)
        p = lda_fit(X, np.array([0] * 40 + [1] * 40))
        coefs.append(p.coef)
        ints.append(p.intercept + np.float32([0.0, 45.0]))
    arrays = (np.stack(coefs).astype(np.float32), np.stack(ints).astype(np.float32))
    frames = _frames(23)
    jm = jmesh.data_mesh()
    want = jmesh.sharded_recognize_fn(jm, PCFG, "HOG", "LDABAYES")(
        jmesh.shard_batch(jm, frames), tuple(jnp.asarray(a) for a in arrays))
    tarrays = tuple(torch.from_numpy(a) for a in arrays)
    got = tmesh.unshard(tmesh.sharded_recognize_fn(mesh, _t(PCFG), "HOG", "LDABAYES")(
        tmesh.shard_batch(mesh, frames), tarrays))
    single = trp.recognize_batch(torch.from_numpy(frames), tarrays, _t(PCFG), "HOG", "LDABAYES")
    for g, s in zip(got, single):
        assert torch.equal(g, s)
    boxes, labels, scores, valid = (np.asarray(a) for a in want)
    assert valid.any(), "nothing recognised; pick another seed"
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[0].numpy()[valid], boxes[valid])
    np.testing.assert_array_equal(got[1].numpy()[valid], labels[valid])
    np.testing.assert_allclose(got[2].numpy()[valid], scores[valid], rtol=0, atol=1e-5)


def _red_signs(b=8, h=96, w=96, seed=22):
    """The dry run's detection frames, with a noisy background and the
    planted red sign moved a frame, and its template: the sign's own red
    mask through the pipeline's crop geometry (by the reference's ops)."""
    from opencv_traffic_sign_detector_tpu.constants import DETECT_CROP, DETECT_GROW
    from opencv_traffic_sign_detector_tpu.ops.color import color_mask
    from opencv_traffic_sign_detector_tpu.ops.geometry import filter_and_grow_boxes
    from opencv_traffic_sign_detector_tpu.ops.resize import crop_and_resize

    rng = np.random.default_rng(seed)
    frames = rng.integers(150, 171, (b, h, w, 3), np.uint8)
    s = 24
    for i in range(b):
        x, y = 20 + (i % 4) * 8, 30 + (i % 3) * 6
        frames[i, y:y + s, x:x + s] = (40, 40, 230)  # BGR red
    box, keep = filter_and_grow_boxes(jnp.asarray([[20, 30, s, s]], jnp.int32),
                                      jnp.asarray([True]), DETECT_GROW)
    assert bool(np.asarray(keep)[0])
    crop = crop_and_resize(jnp.asarray(frames[0]), box, DETECT_CROP)[0]
    red = np.tile((np.asarray(color_mask(crop, "r")) > 0).astype(np.float32).reshape(-1), (6, 1))
    return frames, red, np.zeros_like(red)


def test_sharded_detection_pipeline_matches_reference(interpret):
    """``DetectionPipeline(mesh=...)`` at 8 shards and 2 on the dry run's
    red-sign frames: the unsharded port's records, and the reference's
    mesh pipeline's (boxes, classes exact, scores within 1e-5), a detection
    on every frame; a batch that does not divide is refused."""
    frames, red, blue = _red_signs()
    names = [f"{i:05d}.jpg" for i in range(8)]

    def key(dets):
        return [(d.filename, d.x1, d.y1, d.x2, d.y2, d.class_id) for d in dets]

    want = JPipeline(cfg=PCFG, templates=MeanMaskTemplates(red, blue),
                     mesh=jmesh.data_mesh()).detect_frames(frames, names)
    single = tdet.DetectionPipeline(cfg=_t(PCFG), templates=TTemplates(red, blue),
                                    device="cpu").detect_frames(frames, names)
    assert {d.filename for d in want} == set(names)
    assert key(single) == key(want)
    for n in (8, 2):
        pipe = tdet.DetectionPipeline(cfg=_t(PCFG), templates=TTemplates(red, blue),
                                      mesh=tmesh.data_mesh(n, device="cpu"))
        got = pipe.detect_frames(frames, names)
        assert got == single
    np.testing.assert_allclose([d.score for d in got], [d.score for d in want], rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tdet.DetectionPipeline(cfg=dataclasses.replace(_t(PCFG), batch_size=3),
                               templates=TTemplates(red, blue),
                               mesh=tmesh.data_mesh(2, device="cpu"))
