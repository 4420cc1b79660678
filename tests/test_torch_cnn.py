"""PyTorch port vs the JAX reference: the CNN detector's network, decode and
checkpoints.

Inputs are made with numpy from a fixed seed and handed to both packages;
parameters are the reference's ``init_params`` turned into its flat keystr
dict, or the shipped npz checkpoints.  Tolerances:

* every arch in float32 at 64x96: head maps within 1e-4 (measured 4e-6:
  the same f32 algorithm, convs summed in another order);
* decode on the same f32 maps: classes and validity exact, scores within
  1e-6, boxes within 1e-5 px (sigmoid may differ by an ulp);
* the shipped bf16 checkpoints: decoded detections agree (same class,
  corners within 1 px, scores within 0.05, the reference's own cross-path
  bound) except those within 0.05 of the threshold; the two frameworks
  round bf16 convs after sums taken in other orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "cnn_detector")
ARCHS = ["v3", "slim", "base", "v2wide", "v2s16", "v2s16wide"]


def _flat(params) -> dict:
    """The reference's parameter tree as its flat keystr -> numpy dict."""
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_signcenternet_f32_matches_reference(arch):
    jcfg = jcd.CNNDetectorConfig(arch=arch, dtype="float32")
    params = jcd.init_params(jcfg, 3, (64, 64))
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    want = jcd.SignCenterNet(jcfg).apply({"params": params}, jnp.asarray(frames))
    flat = _flat(params)
    net = tcd.params_from_flat(tcd.CNNDetectorConfig(arch=arch, dtype="float32"), flat,
                               device="cpu")
    assert set(tcd.flat_params(net)) == set(flat)
    with torch.inference_mode():
        got = net(torch.from_numpy(frames))
    stride = tcd.CNNDetectorConfig(arch=arch).stride
    for key, shape_c in (("hm", 6), ("size", 2), ("off", 2)):
        assert got[key].shape == (2, 64 // stride, 96 // stride, shape_c)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-4)


def test_v3_trunk_heads_split_equals_network():
    cfg = tcd.CNNDetectorConfig(arch="v3")
    with np.load(os.path.join(CKPT, "params.npz")) as data:
        flat = dict(data)
    net = tcd.params_from_flat(cfg, flat, device="cpu")
    trunk = tcd.load_flat_params(tcd.V3TrunkHeads(cfg), flat)
    frames = torch.from_numpy(make_frames(1, 64, 64, seed=7))
    with torch.inference_mode():
        full = net(frames)
        split = trunk(net.Conv_0(frames))
    for key in full:
        assert torch.equal(full[key], split[key])


def _random_maps(seed, b=2, hc=5, wc=7):
    rng = np.random.default_rng(seed)
    maps = {"hm": rng.normal(-1, 2, (b, hc, wc, 6)).astype(np.float32),
            "size": rng.normal(1, 1, (b, hc, wc, 2)).astype(np.float32),
            "off": rng.normal(0.5, 0.5, (b, hc, wc, 2)).astype(np.float32)}
    # planted ties: equal peak logits in two classes of one cell and in two
    # distant cells; lax.top_k takes the lower flat index first
    maps["hm"][0, 1, 1, [2, 4]] = 9.0
    maps["hm"][0, 3, 5, 0] = 9.0
    maps["hm"][1, 0, 0, :] = 7.0
    return maps


@pytest.mark.parametrize("seed,stride", [(0, 16), (1, 8)])
def test_decode_matches_reference(seed, stride):
    maps = _random_maps(seed)
    want = [np.asarray(x) for x in jcd.decode_detections(
        {k: jnp.asarray(v) for k, v in maps.items()}, 12, 0.35, stride)]
    got = [x.numpy() for x in tcd.decode_detections(
        {k: torch.from_numpy(v) for k, v in maps.items()}, 12, 0.35, stride)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert want[3].any() and not want[3].all()
    # the ties resolve to the lower flat index: cell (1,1) class 2 first
    assert got[1][0, :3].tolist() == [3, 5, 1]


def _collect_both(jdet, tdet, frames, names):
    hw = frames.shape[1:3]
    want = jdet.collect(jdet.dispatch(frames), names, hw)
    got = tdet.collect(tdet.dispatch(frames), names, hw)
    return want, got


@pytest.mark.parametrize("ckpt", ["params.npz", "params_slim.npz"])
def test_shipped_bf16_checkpoint_detections_agree(ckpt):
    path = os.path.join(CKPT, ckpt)
    jdet = jcd.CNNDetector.load(path)
    tdet = tcd.CNNDetector.load(path, device="cpu")
    assert tdet.cfg == tcd.CNNDetectorConfig(**tcd.saved_meta(path))
    # slim is untagged for its threshold: take its default 0.5
    frames = make_frames(2, 128, 192, seed=31)
    names = ["a.jpg", "b.jpg"]
    want, got = _collect_both(jdet, tdet, frames, names)
    assert want, "the reference detected nothing; pick another seed"
    assert not tcd.unmatched_detections(want, got, 0.05, tdet.cfg.score_threshold)
    assert abs(len(want) - len(got)) <= sum(
        abs(d.score - tdet.cfg.score_threshold) <= 0.05 for d in want + got)


def test_saved_meta_equals_reference():
    for name in ("params.npz", "params_int8.npz", "params_v3.npz", "params_slim.npz"):
        path = os.path.join(CKPT, name)
        assert tcd.saved_meta(path) == jcd.saved_meta(path)


def test_checkpoint_errors_and_save_roundtrip(tmp_path):
    path = os.path.join(CKPT, "params.npz")
    with np.load(path) as data:
        flat = dict(data)
    cfg = tcd.CNNDetectorConfig(**tcd.saved_meta(path))
    missing = {k: v for k, v in flat.items() if k != "['Conv_2']['bias']"}
    with pytest.raises(ValueError, match=r"missing parameter \['Conv_2'\]\['bias'\]"):
        tcd.load_flat_params(tcd.SignCenterNet(cfg), missing, path)
    wrong = dict(flat, **{"['Conv_1']['kernel']": np.zeros((3, 3, 64, 64), np.float32)})
    with pytest.raises(ValueError, match=r"has shape \(3, 3, 64, 64\), model expects "
                                         r"\(3, 3, 64, 128\)"):
        tcd.load_flat_params(tcd.SignCenterNet(cfg), wrong, path)

    det = tcd.CNNDetector.load(path, device="cpu")
    out = str(tmp_path / "saved.npz")
    det.save(out)
    with np.load(out) as saved, np.load(path) as orig:
        assert set(saved.files) == set(orig.files)
        for key in orig.files:
            np.testing.assert_array_equal(saved[key], orig[key])
    # the reference loads the port's file
    assert jcd.saved_meta(out) == jcd.saved_meta(path)
    jcd.CNNDetector.load(out)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown CNN detector arch"):
        tcd.SignCenterNet(tcd.CNNDetectorConfig(arch="v9"))
