"""PyTorch port vs the JAX reference: detection statistics on the device
(``eval/device_stats.py``) and the match score (``ops/geometry.py:
boxes_match_score``).

The cases of ``tests/test_device_stats.py``: the reference's
``ref_resultado_MSER_7_200_2000_1.txt`` against ``gt_test.txt``, padded a
frame, through ``frame_type_counts`` batched over every frame at once,
against the port's host engine (``eval/stats.py``) and the reference's
per-frame function; and random detections over an 8-shard CPU mesh
(``distributed_statistics``) against the reference's on its virtual
8-device mesh.  Counts are exact; match scores within 1e-6.
"""

import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.eval.device_stats as jds
import opencv_traffic_sign_detector_tpu.ops.geometry as jgeo
import opencv_traffic_sign_detector_tpu.parallel.mesh as jmesh
import opencv_traffic_sign_detector_tpu_torch.eval.device_stats as tds
import opencv_traffic_sign_detector_tpu_torch.ops.geometry as tgeo
import opencv_traffic_sign_detector_tpu_torch.parallel.mesh as tmesh
from opencv_traffic_sign_detector_tpu_torch.data.gt import load_ground_truth, load_results_file
from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _pad_frame(dets, gts, d_cap=32, g_cap=16):
    db = np.zeros((d_cap, 4), np.int32)
    dt = np.zeros((d_cap,), np.int32)
    dv = np.zeros((d_cap,), bool)
    for i, d in enumerate(dets[:d_cap]):
        db[i] = (d.x1, d.y1, d.x2, d.y2)
        dt[i] = d.class_id
        dv[i] = True
    gb = np.zeros((g_cap, 4), np.int32)
    gt = np.zeros((g_cap,), np.int32)
    for i, g in enumerate(gts[:g_cap]):
        gb[i] = (g.x1, g.y1, g.x2, g.y2)
        gt[i] = g.class_id
    return db, dt, dv, gb, gt


def _random_batch(seed=0, b=8, d=16, g=8):
    """``tests/test_device_stats.py``'s psum case: half the GT slots copy a
    detection's box (sure matches), 30% of them unused."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 700, (b, d, 4)).astype(np.int32)
    db[..., 2:] = db[..., :2] + rng.integers(20, 60, (b, d, 2))
    dt = rng.integers(1, 7, (b, d)).astype(np.int32)
    dv = rng.random((b, d)) < 0.5
    gb = db[:, :g].copy()
    gt = np.where(rng.random((b, g)) < 0.7, dt[:, :g], 0).astype(np.int32)
    return db, dt, dv, gb, gt


def _tensors(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_boxes_match_score_matches_reference():
    db, _, _, gb, _ = _random_batch(3)
    gb[0, 1] = db[0, 5]  # a perfect match: score 1
    got = tgeo.boxes_match_score(*_tensors([db, gb]))
    want = np.stack([np.asarray(jgeo.boxes_match_score(db[k], gb[k])) for k in range(len(db))])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert got[0, 5, 1] == 1.0


def test_batched_counts_match_host_engine_and_reference(fixtures_dir):
    dets = load_results_file(str(fixtures_dir / "ref_resultado_MSER_7_200_2000_1.txt"))
    gt = [g for g in load_ground_truth(str(fixtures_dir / "gt_test.txt")) if g.class_id != -1]
    frames = sorted({d.filename for d in dets} | {g.filename for g in gt})
    batch = [np.stack(x) for x in zip(*(
        _pad_frame([d for d in dets if d.filename == f], [g for g in gt if g.filename == f])
        for f in frames))]

    c, i, m = (x.numpy() for x in tds.frame_type_counts(*_tensors(batch)))
    assert c.shape == (len(frames), 6) and c.dtype == np.int32
    for k in range(len(frames)):
        want = jds.frame_type_counts(*(a[k] for a in batch))
        for got, w in zip((c[k], i[k], m[k]), want):
            np.testing.assert_array_equal(got, np.asarray(w))

    host = compute_detection_statistics(dets, gt, unmapped_as_type6=False)
    np.testing.assert_array_equal(c.sum(0), [host.per_type[t].correct for t in host.per_type])
    np.testing.assert_array_equal(i.sum(0), [host.per_type[t].incorrect for t in host.per_type])
    np.testing.assert_array_equal(m.sum(0),
                                  [host.per_type[t].non_detected for t in host.per_type])


def test_ties_empty_frames_and_no_gt_slots():
    """Two equal GT boxes: the first takes the match (``jnp.argmax``), the
    second is missed; a frame without detections misses its GT; no GT
    slots at all leaves every valid detection incorrect."""
    db = np.zeros((2, 2, 4), np.int32)
    db[0, 0] = (10, 10, 50, 50)
    dt = np.array([[3, 0], [0, 0]], np.int32)
    dv = np.array([[True, False], [False, False]])
    gb = np.zeros((2, 2, 4), np.int32)
    gb[0, :] = (10, 10, 50, 50)
    gb[1, 0] = (5, 5, 20, 20)
    gt = np.array([[3, 3], [2, 0]], np.int32)
    got = [x.numpy() for x in tds.frame_type_counts(*_tensors([db, dt, dv, gb, gt]))]
    for k in range(2):
        want = jds.frame_type_counts(db[k], dt[k], dv[k], gb[k], gt[k])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[k], np.asarray(w))
    assert got[0][0].tolist() == [0, 0, 1, 0, 0, 0] and got[2][0].tolist() == [0, 0, 1, 0, 0, 0]
    assert got[2][1].tolist() == [0, 1, 0, 0, 0, 0]
    c, i, m = tds.frame_type_counts(*_tensors([db[:1], dt[:1], dv[:1], gb[:1, :0], gt[:1, :0]]))
    assert c.sum() == 0 and i[0].tolist() == [0, 0, 1, 0, 0, 0] and m.sum() == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_distributed_statistics_matches_reference(seed):
    batch = _random_batch(seed)
    jm = jmesh.data_mesh()
    want = jds.distributed_statistics(jm)(*(jmesh.shard_batch(jm, x) for x in batch))
    mesh = tmesh.data_mesh(8, device="cpu")
    got = tds.distributed_statistics(mesh)(*(tmesh.shard_batch(mesh, x) for x in batch))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].sum() > 0, "no correct detection; pick another seed"
