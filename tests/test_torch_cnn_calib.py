"""PyTorch port vs the JAX reference: int8 calibration (``quantize_v3``)
and the quantization twin ``scripts/quantize_cnn_torch.py``.

The shipped float checkpoint ``artifacts/cnn_detector/params.npz`` is
calibrated on a few synthetic frames by both packages.  Weights are
quantized in host numpy on both sides, so every ``q*_kernel`` is
identical; the activation scales come from each side's f32 forward, so
``q*_mult``, ``q*_bias``, ``a*_inv``, ``a3_scale`` and ``f*`` are held
within 1e-5 relative.  Artifacts cross-load both ways.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.cnn_quant as jcq
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_quant as tcq
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames, write_gt_dir

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "artifacts", "cnn_detector", "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))


@pytest.fixture(scope="module")
def flat():
    with np.load(PARAMS) as data:
        return {k: v for k, v in data.items() if not k.startswith("__")}


@pytest.fixture(scope="module")
def ref_params():
    cfg = jcd.CNNDetectorConfig(**jcd.saved_meta(PARAMS))
    return jcd.load_params(PARAMS, jcd.init_params(cfg, 0))


def assert_quant_close(got: dict, want: dict) -> None:
    """Kernels identical, every other array within 1e-5 relative."""
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith("q") and k.endswith("_kernel"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=k)


def test_float_activations_match_reference(flat, ref_params):
    """Each post-relu activation within 1e-5 of its largest magnitude."""
    frames = make_frames(2, 96, 160, seed=61)
    want = jcq.v3_float_activations(ref_params, jnp.asarray(frames))
    got = tcq.v3_float_activations(flat, frames)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    net = tcd.load_params(PARAMS, tcd.SignCenterNet(tcd.CNNDetectorConfig(arch="v3")))
    from_net = tcq.v3_float_activations(net, torch.from_numpy(frames))
    assert all(torch.equal(a, b) for a, b in zip(from_net, got))


@pytest.mark.parametrize("float_heads", [False, True])
def test_quantize_v3_matches_reference(flat, ref_params, float_heads):
    frames = make_frames(3, 128, 192, seed=62)
    want = jcq.quantize_v3(ref_params, frames, float_heads=float_heads)
    assert_quant_close(tcq.quantize_v3(flat, frames, float_heads=float_heads), want)
    net = tcd.load_params(PARAMS, tcd.SignCenterNet(tcd.CNNDetectorConfig(arch="v3")))
    assert_quant_close(tcq.quantize_v3(net, frames, float_heads=float_heads), want)
    assert ("f4_kernel" in want) == ("a3_scale" in want) == float_heads


def test_quantize_v3_percentile_matches_reference(flat, ref_params):
    frames = make_frames(2, 96, 160, seed=63)
    want = jcq.quantize_v3(ref_params, frames, percentile=99.9)
    assert_quant_close(tcq.quantize_v3(flat, frames, percentile=99.9), want)


def test_artifacts_cross_load(tmp_path, flat, ref_params):
    """The port's artifact loads in the reference's ``QuantCNNDetector``
    and the reference's in the port's, arrays and tags unchanged."""
    frames = make_frames(2, 96, 160, seed=64)
    port_q = tcq.quantize_v3(flat, frames, float_heads=True)
    ref_q = jcq.quantize_v3(ref_params, frames, float_heads=True)
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tcq.save_quant_params(port_path, port_q, score_threshold=0.35, source_sha256="abc")
    jcq.save_quant_params(ref_path, ref_q, score_threshold=0.35, source_sha256="abc")
    jdet = jcq.load_detector(port_path)
    tdet = tcq.load_detector(ref_path, device="cpu")
    assert isinstance(jdet, jcq.QuantCNNDetector) and isinstance(tdet, tcq.QuantCNNDetector)
    assert jdet.cfg.score_threshold == tdet.cfg.score_threshold == pytest.approx(0.35)
    for k, v in port_q.items():
        np.testing.assert_array_equal(np.asarray(jdet.q[k]), v)
    for k, v in ref_q.items():
        np.testing.assert_array_equal(tdet.q[k].numpy(), v)
    with np.load(port_path) as a, np.load(ref_path) as b:
        assert set(a.files) == set(b.files)
        assert str(a["__source_sha256__"]) == "abc" and str(a["__quant__"]) == "int8"


@pytest.fixture(scope="module")
def calib_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("calib") / "train")
    write_gt_dir(root, 2, 800, 1360, seed=65)
    return root


@pytest.mark.parametrize("float_heads", [False, True])
def test_quantize_script_matches_reference_script(tmp_path, calib_dir, float_heads, capsys,
                                                  monkeypatch):
    """``scripts/quantize_cnn_torch.py --device cpu`` and
    ``scripts/quantize_cnn.py`` on two 1360x800 frames write the same
    arrays (to the bounds above) and the same tags."""
    import quantize_cnn
    import quantize_cnn_torch

    extra = ["--float_heads"] if float_heads else []
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    common = ["--params", PARAMS, "--calib_dir", calib_dir, "--calib_frames", "2", *extra]
    assert quantize_cnn_torch.main(common + ["--out", ours, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["quantize_cnn.py", *common, "--out", ref])
    quantize_cnn.main()
    assert capsys.readouterr().out.splitlines()[0] == out.splitlines()[0]
    assert out.splitlines()[1].startswith(f"wrote {ours} (")
    with np.load(ours) as a, np.load(ref) as b:
        tags = [k for k in b.files if k.startswith("__")]
        assert sorted(k for k in a.files if k.startswith("__")) == sorted(tags)
        for k in tags:
            assert str(a[k]) == str(b[k]), k
        assert_quant_close({k: a[k] for k in a.files if k not in tags},
                           {k: b[k] for k in b.files if k not in tags})


def test_quantize_script_refuses_missing_card_and_other_arch(tmp_path, calib_dir, capsys,
                                                             monkeypatch):
    import quantize_cnn_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert quantize_cnn_torch.main(["--params", PARAMS, "--calib_dir", calib_dir,
                                    "--out", str(tmp_path / "x.npz")]) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().out
    slim = os.path.join(REPO, "artifacts", "cnn_detector", "params_slim.npz")
    with pytest.raises(SystemExit, match="implements arch v3"):
        quantize_cnn_torch.main(["--params", slim, "--calib_dir", calib_dir,
                                 "--out", str(tmp_path / "x.npz"), "--device", "cpu"])


class _Parsed(Exception):
    """Raised in place of ``parse_args``: carries the parser it was called on."""

    def __init__(self, parser):
        super().__init__("parser captured")
        self.parser = parser


def _parser_defaults(main, monkeypatch) -> dict:
    """The defaults of the parser that ``main()`` builds, by ``dest``, the
    port-only ``--device`` left out."""
    import argparse

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as caught:
            main()
    return {a.dest: a.default for a in caught.value.parser._actions
            if a.dest not in ("help", "device")}


def test_quantize_script_defaults_equal_reference(monkeypatch):
    """Every flag of ``scripts/quantize_cnn_torch.py`` but ``--device``
    defaults as in ``scripts/quantize_cnn.py``: the calibration frames are
    read from the reference's train_jpg unless ``--calib_dir`` says
    otherwise."""
    import quantize_cnn
    import quantize_cnn_torch

    got = _parser_defaults(quantize_cnn_torch.main, monkeypatch)
    want = _parser_defaults(quantize_cnn.main, monkeypatch)
    assert got == want
