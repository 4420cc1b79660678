"""PyTorch port vs the JAX reference: ``main_detection_torch.py --detector
CNN`` against ``main_detection.py`` on a synthetic test directory.

Both CLIs write resultado.txt; the lines must agree within the CNN parity
bound (same file and class, corners within 1 px, scores within 0.05 --
the reference's cross-path bound, which also covers the 2-decimal score
format -- except detections within 0.05 of the threshold).  Both CLIs
must refuse the same bad arguments with exit code 2.
"""

import os

import pytest
import torch

import main_detection
import main_detection_torch
from opencv_traffic_sign_detector_tpu.data.gt import load_results_file
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_test_dir
from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import (
    saved_meta,
    unmatched_detections,
)

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "cnn_detector")


@pytest.fixture(scope="module")
def test_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cnn_cli")
    test = str(root / "test")
    names = write_test_dir(test, 2, 256, 256, seed=23)
    with open(os.path.join(test, "gt.txt"), "w") as f:
        f.write(f"{names[0][:-4]}.ppm;36;37;100;97;2\n{names[1][:-4]}.ppm;52;56;88;88;2\n")
    return test, root


@pytest.mark.parametrize("ckpt,upscale,fmt", [
    ("params.npz", "1", "bgr"), ("params_int8.npz", "1", "bgr"),
    ("params.npz", "1.6", "bgr"), ("params_int8.npz", "1.6", "bgr"),
    ("params.npz", "1", "yuv420"), ("params_int8.npz", "1", "patches8"),
])
def test_cli_cnn_writes_same_results_as_reference(test_dir, ckpt, upscale, fmt):
    """yuv420 on v3 at native resolution becomes yuv420p, which the port
    patchifies itself (the loader's fallback patchify imports jax)."""
    test, root = test_dir
    params = os.path.join(CKPT, ckpt)
    common = ["--detector", "CNN", "--cnn_params", params, "--test_path", test,
              "--batch_size", "2", "--no-images", "--upscale", upscale,
              "--input_format", fmt]
    ref_out, port_out = str(root / "ref_cnn.txt"), str(root / "port_cnn.txt")
    assert main_detection.main(common + ["--out", ref_out]) == 0
    assert main_detection_torch.main(common + ["--out", port_out, "--device", "cpu"]) == 0
    ref, port = load_results_file(ref_out), load_results_file(port_out)
    assert ref, "the reference detected nothing on the synthetic frames"
    thr = saved_meta(params)["score_threshold"]
    assert not unmatched_detections(ref, port, 0.05, thr)


@pytest.mark.parametrize("detector,flags,thr", [
    ("CNN", ["--n_devices", "2"], None), ("CNN_0.4", ["--trace_dir", "t"], 0.4),
], ids=["n_devices", "trace_dir"])
def test_cli_cnn_ignores_mser_only_flags(test_dir, detector, flags, thr):
    """The reference's CNN branch returns before ``--n_devices`` and
    ``--trace_dir`` are read: both CLIs ignore them, write resultado.txt on
    one device (same bound as above) and make no trace directory."""
    test, root = test_dir
    params = os.path.join(CKPT, "params.npz")
    trace = str(root / "trace")
    flags = [trace if f == "t" else f for f in flags]
    common = ["--detector", detector, "--cnn_params", params, "--test_path", test,
              "--batch_size", "2", "--no-images", *flags]
    ref_out, port_out = str(root / "ref_flags.txt"), str(root / "port_flags.txt")
    assert main_detection.main(common + ["--out", ref_out]) == 0
    assert main_detection_torch.main(common + ["--out", port_out, "--device", "cpu"]) == 0
    ref, port = load_results_file(ref_out), load_results_file(port_out)
    assert ref, "the reference detected nothing on the synthetic frames"
    thr = saved_meta(params)["score_threshold"] if thr is None else thr
    assert not unmatched_detections(ref, port, 0.05, thr)
    assert not os.path.exists(trace)


@pytest.mark.parametrize("argv", [
    ["--upscale", "0"],
    ["--upscale", "1.6", "--input_format", "patches8"],
    ["--upscale", "-1", "--detector", "CNN"],
    ["--detector", "CNN_1.5"],
    ["--detector", "CNN_0.4_x"],
], ids=["upscale0", "upscale_patches8", "upscale_negative_cnn", "cnn_thr_range",
        "cnn_spec"])
def test_both_clis_reject_bad_arguments(argv, capsys):
    assert main_detection.main(argv) == 2
    assert main_detection_torch.main(argv + ["--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert "--upscale" in out or "Invalid" in out
