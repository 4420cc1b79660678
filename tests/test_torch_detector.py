"""PyTorch port vs the JAX reference: the whole práctica-1 detection slice.

``detect_batch`` and the CLI run on synthetic 256x256 frames through both
packages; the reference's Pallas kernels run through the interpreter
(``TSD_PALLAS_INTERPRET=1``), the port's kernels as their plain versions.
Proposals must be identical; detections must agree in count and type with
box IoU >= 0.99; the CLIs must write the same resultado.txt.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_detection
import main_detection_torch
import opencv_traffic_sign_detector_tpu.models.detector as jdet
import opencv_traffic_sign_detector_tpu.models.mean_masks as jmm
import opencv_traffic_sign_detector_tpu.ops.mser as jmser
import opencv_traffic_sign_detector_tpu.ops.preprocess as jpre
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.detector as tdet
import opencv_traffic_sign_detector_tpu_torch.models.mean_masks as tmm
import opencv_traffic_sign_detector_tpu_torch.ops.mser as tmser
from opencv_traffic_sign_detector_tpu.config import MSERConfig, PipelineConfig
from opencv_traffic_sign_detector_tpu.data.images import load_image_bgr
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import (
    make_frames,
    write_test_dir,
    write_train_dir,
)
from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSER = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                  downscale=2, max_regions=128, ccl_iters=2, ccl_jumps=0,
                  level_step=9, refine_scan_passes=2)
CFG = PipelineConfig(mser=MSER, batch_size=2)
# the same configs from the port's own config module, for the port's calls
T_MSER = tcfg.MSERConfig(**dataclasses.asdict(MSER))
T_CFG = tcfg.PipelineConfig(mser=T_MSER, batch_size=2)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def templates():
    return jmm.MeanMaskTemplates.load(os.path.join(REPO, "artifacts", "mean_masks.npz"))


def _iou_xyxy(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union else 1.0


def test_detect_batch_matches_reference(interpret, templates):
    frames = make_frames(2, 256, 256, seed=21)
    gray = np.array(jpre.enhance_contrast(jnp.asarray(frames)))
    tb, tv = tmser.mser_regions(torch.from_numpy(gray), T_MSER)
    for i in range(2):
        jb, jv = jmser.mser_regions(jnp.asarray(gray[i]), MSER)
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tb[i].numpy(), np.asarray(jb))

    want = [np.asarray(x) for x in jdet.detect_batch(
        jnp.asarray(frames), jnp.asarray(templates.red), jnp.asarray(templates.blue), CFG)]
    red, blue = tmm.templates_to_torch(templates, "cpu")
    got = [x.numpy() for x in tdet.detect_batch(torch.from_numpy(frames), red, blue, T_CFG)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert want[3].sum() > 0, "the reference detected nothing; pick another seed"
    np.testing.assert_array_equal(got[3].sum(1), want[3].sum(1))
    for b in range(2):
        gv, wv = got[3][b], want[3][b]
        np.testing.assert_array_equal(got[1][b][gv], want[1][b][wv])
        for gb, wb in zip(got[0][b][gv], want[0][b][wv]):
            assert _iou_xyxy(gb, wb) >= 0.99
        np.testing.assert_allclose(got[2][b][gv], want[2][b][wv], atol=1e-6)


def test_pipeline_run_directory_pads_and_unpads(tmp_path, templates):
    d = str(tmp_path / "frames")
    names = write_test_dir(d, 3, 160, 160, seed=22)
    rt.reset_launch_counts()
    pipe = tdet.DetectionPipeline(cfg=T_CFG, templates=tmm.MeanMaskTemplates(
        templates.red, templates.blue), device="cpu")
    dets = pipe.run_directory(d)
    assert {x.filename for x in dets} <= set(names)
    frames = np.stack([load_image_bgr(os.path.join(d, n)) for n in names])
    direct = pipe.detect_frames(frames[:2], names[:2]) + pipe.detect_frames(frames[2:], names[2:])
    assert dets == direct
    assert rt.launch_counts() == dict.fromkeys(rt.KERNELS, 0)


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    test = str(root / "test")
    names = write_test_dir(test, 2, 256, 256, seed=23)
    with open(os.path.join(test, "gt.txt"), "w") as f:
        f.write(f"{names[0][:-4]}.ppm;40;40;80;80;1\n{names[1][:-4]}.ppm;100;30;140;70;38\n")
    return write_train_dir(str(root / "train"), seed=4), test, root


def test_cli_writes_same_results_as_reference(interpret, cli_dirs):
    train, test, root = cli_dirs
    common = ["--train_path", train, "--test_path", test, "--batch_size", "2", "--no-images"]
    ref_out, port_out = str(root / "ref.txt"), str(root / "port.txt")
    assert main_detection.main(common + ["--out", ref_out]) == 0
    assert main_detection_torch.main(common + ["--out", port_out, "--device", "cpu"]) == 0
    with open(ref_out) as a, open(port_out) as b:
        ref, port = a.read(), b.read()
    assert ref == port
    assert ref.strip(), "no detections to compare; pick another seed"


@pytest.mark.parametrize("flags", [["--pixel_area_stability"], ["--downscale", "1"]],
                         ids=["pixel_area_stability", "downscale1"])
def test_cli_xla_sweep_modes_write_same_results(interpret, cli_dirs, flags):
    """Both modes keep ccl_jumps=1 (the XLA sweep without K5 in the
    reference), so the reference runs under the interpreter."""
    train, test, root = cli_dirs
    common = ["--train_path", train, "--test_path", test, "--batch_size", "2",
              "--no-images", *flags]
    ref_out, port_out = str(root / "ref_xla.txt"), str(root / "port_xla.txt")
    assert main_detection.main(common + ["--out", ref_out]) == 0
    assert main_detection_torch.main(common + ["--out", port_out, "--device", "cpu"]) == 0
    with open(ref_out) as a, open(port_out) as b:
        ref, port = a.read(), b.read()
    assert ref == port
    assert ref.strip(), "no detections to compare; pick another seed"


@pytest.mark.parametrize("argv", [
    ["--n_devices", "2"], ["--trace_dir", "t"], ["--detector", "MSER_7_200"],
])
def test_cli_rejects_unported_modes(argv, interpret, cli_dirs, tmp_path, capsys):
    """The MSER modes that exited 2 until scale-out was ported now run:
    ``--device cpu --n_devices 2`` (each batch split over 2 CPU shards)
    writes the same resultado.txt as ``main_detection.py --n_devices 2``
    (its batches split over 2 of its virtual devices) and both print the
    sharding line; ``--trace_dir`` writes a profiler trace that names the
    port's ops.  A bad detector spec is still refused with exit 2.  With
    the CNN detector both CLIs ignore the first two flags
    (tests/test_torch_cnn_cli.py)."""
    train, test, root = cli_dirs
    common = ["--train_path", train, "--test_path", test, "--batch_size", "2", "--no-images"]
    if argv[0] == "--detector":
        assert main_detection_torch.main(argv + ["--device", "cpu"]) == 2
        assert "Invalid detector spec" in capsys.readouterr().out
        return
    if argv[0] == "--n_devices":
        ref_out, port_out = str(tmp_path / "ref.txt"), str(tmp_path / "port.txt")
        assert main_detection.main(common + argv + ["--out", ref_out]) == 0
        ref_log = capsys.readouterr().out
        assert main_detection_torch.main(common + argv + ["--out", port_out,
                                                          "--device", "cpu"]) == 0
        assert "sharding batches over 2 devices" in ref_log
        assert "sharding batches over 2 devices" in capsys.readouterr().out
        with open(ref_out) as a, open(port_out) as b:
            ref, port = a.read(), b.read()
        assert ref == port
        assert ref.strip(), "no detections to compare; pick another seed"
        return
    trace_dir = tmp_path / "trace"
    assert main_detection_torch.main(common + ["--trace_dir", str(trace_dir), "--out",
                                               str(tmp_path / "port.txt"), "--device",
                                               "cpu"]) == 0
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "aten::" in traces[0].read_text()
