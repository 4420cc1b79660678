"""PyTorch port vs the JAX reference: the streaming server.

``serve_detection_torch.py --once`` against ``serve_detection.py --once`` on
the same synthetic frames (256x256, 3 frames at batch 2: one full batch and
one padded).  The JSONL lines must be equal apart from ``latency_ms`` for
MSER at the tuned ``--downscale 2`` point (the reference's kernels through
the interpreter) and at ``--downscale 1``, with 48 regions a frame (the CPU
refine floods fewer windows); for the CNN detector they agree
within the CNN parity bound (same file and class, corners within 1 px,
scores within 0.05, except detections within 0.05 of the threshold).  Both
servers refuse the same bad arguments with exit code 2, and the port's
refuses ``--device cuda`` where no card is visible.
"""

import json
import os

import jax
import pytest
import torch

import serve_detection
import serve_detection_torch
from opencv_traffic_sign_detector_tpu_torch.data.gt import GroundTruthBox
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_test_dir
from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import unmatched_detections

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "artifacts", "mean_masks.npz")
CNN_PARAMS = os.path.join(REPO, "artifacts", "cnn_detector", "params.npz")


@pytest.fixture(scope="module")
def watch_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve") / "incoming")
    write_test_dir(d, 3, 256, 256, seed=23)
    return d


def _serve(main, watch_dir, out, *flags):
    assert main(["--watch_dir", watch_dir, "--out", str(out), "--batch", "2", "--once",
                 *flags]) == 0
    with open(out) as f:
        return [json.loads(line) for line in f]


def _without_latency(lines):
    for rec in lines:
        assert set(rec) == {"file", "latency_ms", "detections"}
        assert rec["latency_ms"] >= 0
        for d in rec["detections"]:
            assert set(d) == {"box", "type", "score"}
    return [{k: v for k, v in rec.items() if k != "latency_ms"} for rec in lines]


@pytest.mark.parametrize("downscale", ["2", "1"])
def test_serve_mser_same_jsonl(watch_dir, tmp_path, monkeypatch, capsys, downscale):
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    flags = ["--templates", TEMPLATES, "--downscale", downscale, "--max_regions", "48"]
    want = _serve(serve_detection.main, watch_dir, tmp_path / "ref.jsonl", *flags)
    got = _serve(serve_detection_torch.main, watch_dir, tmp_path / "port.jsonl", *flags,
                 "--device", "cpu")
    jax.clear_caches()
    assert "latency ms p50" in capsys.readouterr().out
    assert [r["file"] for r in got] == sorted(os.listdir(watch_dir))
    assert _without_latency(got) == _without_latency(want)
    assert any(r["detections"] for r in want), "no detections to compare; pick another seed"


def _records(lines):
    return [GroundTruthBox(filename=r["file"], x1=d["box"][0], y1=d["box"][1], x2=d["box"][2],
                           y2=d["box"][3], class_id=d["type"], score=d["score"])
            for r in lines for d in r["detections"]]


@pytest.mark.parametrize("fmt", ["bgr", "yuv420", "patches8"])
def test_serve_cnn_agrees(watch_dir, tmp_path, fmt):
    flags = ["--detector", "CNN_0.3", "--cnn_params", CNN_PARAMS, "--input_format", fmt]
    want = _serve(serve_detection.main, watch_dir, tmp_path / "ref.jsonl", *flags)
    got = _serve(serve_detection_torch.main, watch_dir, tmp_path / "port.jsonl", *flags,
                 "--device", "cpu")
    assert [r["file"] for r in _without_latency(got)] == [r["file"] for r in want]
    ref, port = _records(want), _records(got)
    assert ref, "the reference detected nothing on the synthetic frames"
    assert not unmatched_detections(ref, port, 0.05, 0.3)
    for d in port:  # clipped to the frame
        assert 0 <= d.x1 < d.x2 <= 255 and 0 <= d.y1 < d.y2 <= 255


@pytest.mark.parametrize("argv", [
    ["--detector", "CNN_x_y"],
    ["--detector", "CNN_0.4_x"],
    ["--detector", "MSER_7_200_2000_1", "--upscale", "1.5"],
    ["--detector", "CNN", "--upscale", "1.6", "--input_format", "patches8"],
    ["--input_format", "yuv420"],
    ["--detector", "MSER_7_200"],
    ["--detector", "CNN", "--cnn_params", "missing.npz"],
    ["--templates", "missing.npz"],
], ids=["cnn_spec", "cnn_spec3", "upscale_mser", "upscale_patches8", "yuv_mser", "mser_spec",
        "cnn_weights", "templates"])
def test_both_servers_reject(tmp_path, argv, capsys):
    """Both exit 2 with the same message; the port's points at its own
    trainer."""
    common = ["--watch_dir", str(tmp_path), "--once", "--out", str(tmp_path / "o.jsonl")]
    assert serve_detection.main(common + argv) == 2
    ref = capsys.readouterr().out.replace("scripts/train_cnn.py", "scripts/train_cnn_torch.py")
    assert serve_detection_torch.main(common + argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().out == ref


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
@pytest.mark.parametrize("detector", ["MSER_7_200_2000_1", "CNN"])
def test_serve_refuses_cuda_without_a_card(tmp_path, capsys, detector):
    assert serve_detection_torch.main(["--watch_dir", str(tmp_path), "--once", "--detector",
                                       detector, "--templates", TEMPLATES,
                                       "--cnn_params", CNN_PARAMS]) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().out
