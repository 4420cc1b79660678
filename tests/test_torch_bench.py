"""PyTorch port vs the JAX reference: ``bench_torch.py`` against ``bench.py``.

The helpers are held against ``bench.py``'s own: frames (noise and a
``write_gt_dir`` tree, both sizes) and scores equal; the 1080p quality
resize against ``jax.image.resize`` under jit (f32 values within 1e-2;
uint8 equal except +-1 where the reference's value lies within 1e-2 of a
.5 tie, on at most 1e-4 of the pixels).  Both twins run their scopes with
spies in place of ``detect_batch`` and of the CNN detectors' ``dispatch``
and ``dispatch_yuv``: the spies see the same configs, templates, frames,
4:2:0 planes and detectors, call for call, and both print one JSON line
with the same keys but the port's ``device``.  Then each scope of the port
runs for real on the CPU at a small size.
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.cnn_quant as jcq
import opencv_traffic_sign_detector_tpu.models.detector as jdet
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_quant as tcq
import opencv_traffic_sign_detector_tpu_torch.models.detector as tdet
from opencv_traffic_sign_detector_tpu.data.gt import GroundTruthBox as JBox
from opencv_traffic_sign_detector_tpu.data.gt import load_ground_truth
from opencv_traffic_sign_detector_tpu_torch.data.gt import GroundTruthBox as TBox
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import (
    make_frames,
    write_gt_dir,
    write_train_dir,
)
from test_torch_cnn_train import _parser_defaults

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSER_ARGS = ["--model", "mser", "--frames", "2", "--batch", "2", "--skip_e2e"]
CNN_ARGS = ["--model", "cnn", "--frames", "2", "--batch", "2", "--cnn_batch", "1",
            "--cnn_iters", "1", "--fed_batches", "1"]


@pytest.fixture(scope="module")
def gtsdb_tree(tmp_path_factory):
    """A DET_DATA tree of two labelled 1360x800 frames."""
    root = tmp_path_factory.mktemp("det_data")
    write_gt_dir(str(root / "test_alumnos_jpg"), 2, 800, 1360, seed=31)
    return str(root)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    """A DET_DATA tree of two labelled 160x256 frames and template crops."""
    root = tmp_path_factory.mktemp("small_data")
    write_gt_dir(str(root / "test_alumnos_jpg"), 2, 160, 256, seed=5)
    write_train_dir(str(root / "train_jpg"), seed=3)
    return str(root)


def _point_both(monkeypatch, data_root: str, home) -> None:
    """DET_DATA of both twins at ``data_root``, and each twin's template
    cache (``mean_masks.npz`` beside the script) in its own dir of
    ``home``."""
    for mod in (bench, bench_torch):
        monkeypatch.setattr(mod, "DET_DATA", data_root)
        d = home / mod.__name__
        d.mkdir(exist_ok=True)
        monkeypatch.setattr(mod, "__file__", str(d / f"{mod.__name__}.py"))


def _digest(a) -> tuple:
    a = np.ascontiguousarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
    return a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).hexdigest()


def _run(main, argv) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


# --- helpers ----------------------------------------------------------------

@pytest.mark.parametrize("size", ["gtsdb", "1080p"])
@pytest.mark.parametrize("data", ["noise", "tree"])
def test_load_frames_equal_reference(size, data, gtsdb_tree, tmp_path, monkeypatch):
    """Three frames from a tree of two (tiled) or from noise, padded to
    1088x1920 for 1080p: equal arrays."""
    root = gtsdb_tree if data == "tree" else str(tmp_path / "absent")
    for mod in (bench, bench_torch):
        monkeypatch.setattr(mod, "DET_DATA", root)
    want = bench._load_frames(3, size)
    got = bench_torch._load_frames(3, size)
    assert got.shape == ((3, 1088, 1920, 3) if size == "1080p" else (3, 800, 1360, 3))
    np.testing.assert_array_equal(got, want)


def test_score_dets_equal_reference(gtsdb_tree):
    """One detection list (gt boxes, a shifted one, a false one, another
    class): the same (f1, ap, precision, recall)."""
    gt_path = os.path.join(gtsdb_tree, "test_alumnos_jpg", "gt.txt")
    gt = load_ground_truth(gt_path)
    rows = [(g.filename.replace(".ppm", ".jpg"), g.x1, g.y1, g.x2, g.y2, g.class_id,
             0.9 - 0.05 * i) for i, g in enumerate(gt[:5])]
    f, x1, y1, x2, y2, c, _ = rows[0]
    rows += [(f, x1 + 9, y1 + 9, x2 + 9, y2 + 9, c, 0.5), (f, 5, 5, 40, 40, 1, 0.7),
             (f, x1, y1, x2, y2, 6 if c != 6 else 1, 0.3)]
    want = bench._score_dets([JBox(*r[:6], score=r[6]) for r in rows], gt_path)
    got = bench_torch._score_dets([TBox(*r[:6], score=r[6]) for r in rows], gt_path)
    assert got == want
    assert 0 < want[0] < 1


@jax.jit
def _jax_upscale(frames_u8):
    """``bench.py``'s ``_upscale`` (its :391-396), and the raw f32 values."""
    b = frames_u8.shape[0]
    out = jax.image.resize(frames_u8.astype(jnp.float32), (b, 1088, 1920, 3), "bilinear")
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8), out


@pytest.mark.parametrize("hw", [(800, 1360), (96, 160)], ids=["gtsdb", "small"])
def test_upscale_equal_jax_resize(hw):
    frames = make_frames(2, *hw, seed=3)
    want, raw = (np.asarray(x) for x in _jax_upscale(jnp.asarray(frames)))
    got = bench_torch._upscale(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = got.astype(np.int16) - want
    off = diff != 0
    assert np.abs(diff).max() <= 1
    assert off.mean() <= 1e-4
    assert np.all(np.abs(raw[off] - np.floor(raw[off]) - 0.5) <= 1e-2)


def test_parser_defaults_equal_reference(monkeypatch):
    assert _parser_defaults(bench_torch.main, monkeypatch) == _parser_defaults(
        bench.main, monkeypatch)


# --- spies on the scopes --------------------------------------------------------

def _spy_detect_batch(monkeypatch, mod, calls: list, jax_side: bool):
    """``mod.detect_batch`` -> records (frames, red, blue, cfg as a dict)
    and returns empty detections."""

    def spy(frames, red, blue, cfg, *rest):
        calls.append((_digest(frames), _digest(red), _digest(blue), dataclasses.asdict(cfg)))
        b, d = frames.shape[0], cfg.max_detections
        if jax_side:
            return (jnp.zeros((b, d, 4), jnp.int32), jnp.zeros((b, d), jnp.int32),
                    jnp.zeros((b, d)), jnp.zeros((b, d), bool))
        return (torch.zeros((b, d, 4), dtype=torch.int32), torch.zeros((b, d), dtype=torch.int32),
                torch.zeros((b, d)), torch.zeros((b, d), dtype=torch.bool))

    monkeypatch.setattr(mod, "detect_batch", spy)


def _json_line(lines: list[str]) -> dict:
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("templates,flags", [
    ("fallback", ["--skip_1080p"]), ("fallback", []), ("trained", ["--skip_1080p"]),
    ("cache", ["--skip_1080p"]),
], ids=["fallback", "probe_1080p", "trained", "cache"])
def test_mser_scope_equal_reference(templates, flags, small_tree, tmp_path, monkeypatch):
    """``--model mser``: the same PipelineConfig, frames and templates at
    every ``detect_batch`` call (3 warm-ups, the timed batch, and with the
    probe its warm-up and 4 batches of 1088x1920), the random templates
    without data, trained and cached ones otherwise; the same JSON keys."""
    data = str(tmp_path / "absent")
    if templates == "trained":
        data = str(tmp_path / "data")
        shutil.copytree(os.path.join(small_tree, "train_jpg"), os.path.join(data, "train_jpg"))
    _point_both(monkeypatch, data, tmp_path)
    if templates == "cache":
        for mod in (bench, bench_torch):
            shutil.copy(os.path.join(REPO, "artifacts", "mean_masks.npz"),
                        os.path.join(os.path.dirname(mod.__file__), "mean_masks.npz"))
    calls = {"ref": [], "port": []}
    _spy_detect_batch(monkeypatch, jdet, calls["ref"], True)
    _spy_detect_batch(monkeypatch, tdet, calls["port"], False)
    rc_ref, ref = _run(bench.main, MSER_ARGS + flags)
    rc_port, port = _run(bench_torch.main, MSER_ARGS + flags + ["--device", "cpu"])
    assert rc_ref == rc_port == 0
    assert calls["port"] == calls["ref"]
    assert len(calls["ref"]) == (4 if flags else 9)
    if not flags:
        assert calls["ref"][-1][0][0] == (2, 1088, 1920, 3)
    want, got = _json_line(ref), _json_line(port)
    assert got.pop("device") == "cpu"
    assert set(got) == set(want)
    if templates == "trained":
        caches = [os.path.join(os.path.dirname(m.__file__), "mean_masks.npz")
                  for m in (bench, bench_torch)]
        a, b = (np.load(c) for c in caches)
        np.testing.assert_array_equal(a["red"], b["red"])
        np.testing.assert_array_equal(a["blue"], b["blue"])


def test_mser_scope_and_probe_replay_one_graph_a_shape(tmp_path, monkeypatch):
    """``--model mser`` with the probe through ``CapturedFn``'s card path
    (the CPU taken for a card, a stand-in capture step): one capture a frame
    shape, keyed by the PipelineConfig, at the scope's first warm-up and at
    the probe's warm-up, and a replay at every later call, each calling
    ``detect_batch`` with the scope's frames and templates."""
    from test_torch_graphs import StandIn

    from opencv_traffic_sign_detector_tpu_torch.config import PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    _point_both(monkeypatch, str(tmp_path / "absent"), tmp_path)
    calls, made = [], []
    _spy_detect_batch(monkeypatch, tdet, calls, False)

    class OnTheCard(graphs.CapturedFn):
        EAGER_DEVICES = ()

        def __init__(self, fn, capture=None, keyed=False):
            made.append(self)
            super().__init__(fn, capture=step, keyed=keyed)

    step = StandIn()
    monkeypatch.setattr(graphs, "CapturedFn", OnTheCard)
    rc, lines = _run(bench_torch.main, MSER_ARGS + ["--frames", "4", "--device", "cpu"])
    assert rc == 0 and set(_json_line(lines)) >= {"value", "fps_1080p", "device"}
    assert len(made) == 1
    assert [c[1] for c in step.captures] == [(2, 800, 1360, 3), (2, 1088, 1920, 3)]
    # the scope: 3 warm-ups (1 capture, 2 replays) and 2 timed batches; the
    # probe: its warm-up (the capture) and 4 timed batches
    assert step.replays == 2 + 2 + 4 and len(calls) == 10
    keys = {k[3] for k in made[0].entries()}
    assert len(keys) == 1 and isinstance(keys.pop(), PipelineConfig)
    assert [c[0][0] for c in calls] == [(2, 800, 1360, 3)] * 5 + [(2, 1088, 1920, 3)] * 5


def _spy_cnn(monkeypatch, det_cls, quant_cls, methods, calls: list, jax_side: bool):
    """Spies on the CNN detectors' dispatches: each call's route, detector
    (arch, upscale, int8 or float) and inputs, in order; empty outputs."""
    for cls, name in methods:
        orig = getattr(cls, name)

        def spy(self, *arrays, _name=name, _orig=orig):
            calls.append((_name, self.cfg.arch, self.upscale, isinstance(self, quant_cls),
                          [_digest(a) for a in arrays]))
            b, k = arrays[0].shape[0], self.cfg.max_detections
            if jax_side:
                return (np.zeros((b, k, 4), np.float32), np.zeros((b, k), np.int32),
                        np.zeros((b, k), np.float32), np.zeros((b, k), bool))
            return (torch.zeros((b, k, 4)), torch.zeros((b, k), dtype=torch.int32),
                    torch.zeros((b, k)), torch.zeros((b, k), dtype=torch.bool))

        monkeypatch.setattr(cls, name, spy)


@pytest.fixture(scope="module")
def cnn_spied(tmp_path_factory):
    """Both twins' ``--model cnn`` runs with spies: (ref, port) each of
    (dispatch calls, detect_batch calls, JSON) and the port's fed frames."""
    home = tmp_path_factory.mktemp("cnn_spied")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _point_both(mp, str(home / "absent"), home)
        for side, mod, jax_side, main, extra in [
            ("ref", jdet, True, bench.main, []),
            ("port", tdet, False, bench_torch.main, ["--device", "cpu"]),
        ]:
            dispatches, batches = [], []
            if jax_side:
                _spy_cnn(mp, jcd.CNNDetector, jcq.QuantCNNDetector,
                         [(jcd.CNNDetector, "dispatch"), (jcd.CNNDetector, "dispatch_yuv"),
                          (jcq.QuantCNNDetector, "dispatch")], dispatches, True)
            else:
                _spy_cnn(mp, tcd.CNNDetector, tcq.QuantCNNDetector,
                         [(tcd.CNNDetector, "dispatch"), (tcd.CNNDetector, "dispatch_yuv")],
                         dispatches, False)
            _spy_detect_batch(mp, mod, batches, jax_side)
            rc, lines = _run(main, CNN_ARGS + ["--skip_e2e"] + extra)
            assert rc == 0
            out[side] = (dispatches, batches, _json_line(lines))
        out["fed_frames"] = bench_torch._load_frames(1, "gtsdb")
    return out


def test_cnn_scopes_dispatch_the_same(cnn_spied):
    """Every scope's dispatches in the same order, on the same detector
    (v3 float, int8, upscaled at 1.6 int8 and float) and inputs; the MSER
    pipeline's batches equal."""
    (ref, ref_batches, _), (port, port_batches, _) = cnn_spied["ref"], cnn_spied["port"]
    assert [c[:4] for c in port] == [c[:4] for c in ref]
    assert port == ref
    assert port_batches == ref_batches
    routes = {c[:4] for c in ref}
    assert ("dispatch", "v3", 1.6, True) in routes and ("dispatch", "v3", 1.6, False) in routes
    assert ("dispatch_yuv", "v3", 1.0, False) in routes
    assert ("dispatch", "v3", 1.0, True) in routes


def test_yuv420_repack_equal_reference(cnn_spied):
    """The planes of the yuv scopes (patchified in the device-queue scope,
    tight in the fed one) equal the reference's, and the tight ones are
    :func:`bench_torch._yuv420_planes` of the fed frames."""
    ref = [c for c in cnn_spied["ref"][0] if c[0] == "dispatch_yuv"]
    port = [c for c in cnn_spied["port"][0] if c[0] == "dispatch_yuv"]
    assert port == ref
    assert {len(c[4][0][0]) for c in ref} == {3, 4}
    tight = [_digest(p) for p in bench_torch._yuv420_planes(cnn_spied["fed_frames"])]
    assert tight in [c[4] for c in port]


def test_cnn_json_keys_equal_reference(cnn_spied):
    want, got = cnn_spied["ref"][2], dict(cnn_spied["port"][2])
    assert got.pop("device") == "cpu"
    assert set(got) == set(want)
    for key in ("weights_sha256", "int8_weights_sha256", "arch", "scope", "metric", "n_windows"):
        assert got[key] == want[key]


# --- real runs on the CPU ---------------------------------------------------------

QUALITY = {"cnn_f1_test", "cnn_ap_test", "cnn_f1_int8_test", "cnn_ap_int8_test",
           "cnn_f1_upscaled_test", "cnn_ap_upscaled_test", "cnn_f1_yuv_test",
           "cnn_ap_yuv_test", "cnn_f1_1080p", "cnn_ap_1080p", "mser_f1_test", "mser_ap_test"}


def test_real_run_cnn_scopes(small_tree, cnn_spied, tmp_path, monkeypatch):
    """The CNN scopes end to end on the small tree: every key of the spied
    run plus the end-to-end and quality keys, finite; quality in [0, 1]."""
    _point_both(monkeypatch, small_tree, tmp_path)
    rc, lines = _run(bench_torch.main, CNN_ARGS + ["--device", "cpu"])
    assert rc == 0
    got = _json_line(lines)
    assert set(got) == set(cnn_spied["port"][2]) | QUALITY | {
        "e2e_fps", "e2e_vs_reference", "e2e_yuv_fps"}
    assert all(0 <= got[k] <= 1 for k in QUALITY)
    assert all(np.isfinite(v) and v > 0 for k, v in got.items()
               if k.endswith("fps") or k in ("value", "e2e_vs_reference"))


def test_real_run_mser_scope(small_tree, tmp_path, monkeypatch):
    """``--model mser`` end to end on the small tree, templates trained
    from its crops and cached; the 1080p probe is left to the spied run
    (four 1088x1920 batches take minutes on the CPU) and the card."""
    _point_both(monkeypatch, small_tree, tmp_path)
    rc, lines = _run(bench_torch.main, ["--model", "mser", "--frames", "2", "--batch", "2",
                                        "--skip_1080p", "--device", "cpu"])
    assert rc == 0
    got = _json_line(lines)
    assert set(got) == {"metric", "value", "unit", "vs_baseline", "vs_reference_detect_only",
                        "e2e_fps", "e2e_vs_reference", "device"}
    assert got["value"] > 0 and got["e2e_fps"] > 0
    assert os.path.exists(os.path.join(os.path.dirname(bench_torch.__file__), "mean_masks.npz"))


def test_dispatch_constants_are_made_once():
    """The CNN dispatch's constants and weight matrices come from
    ``ops/resident.py``: one tensor per value and device, rounded as
    ``torch.tensor(value, dtype=...)`` rounds it (a copy to a card at every
    dispatch would wait for the card inside the device-queue window)."""
    from opencv_traffic_sign_detector_tpu_torch.ops import resident as res
    from opencv_traffic_sign_detector_tpu_torch.ops import upscale as tup

    a = res.resident(res.scalar, 1 / 255.0, torch.bfloat16, device="cpu")
    assert a is res.resident(res.scalar, 1 / 255.0, torch.bfloat16, device=torch.device("cpu"))
    assert torch.equal(a, torch.tensor(1 / 255.0, dtype=torch.bfloat16))
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    assert tcd._const(0.5, x, torch.bfloat16) is tcd._const(0.5, x, torch.bfloat16)
    assert tup._dense_weights(800, 1088, "cpu") is tup._dense_weights(800, 1088, "cpu")
    np.testing.assert_array_equal(tup._band(800, 1088), res.resident(tup._band, 800, 1088,
                                                                     device="cpu").numpy())
