"""PyTorch port vs the JAX reference: the tool twins under ``scripts/``.

Each quality tool and its twin run on the same ``write_gt_dir`` frames
(two of 256x256, with template crops), the reference's Pallas kernels
through the interpreter (K5 too: ``propagate_rolls_pallas`` has no
interpret mode, so its body is run through it, as in
``tests/test_torch_mser_xla.py``), the port's as their plain versions:
the printed lines must be equal but for times, and a resultado file the
tool writes must be equal.  The CNN tools' lines are compared as they are:
the detections behind them agree within the CNN bound (1 px, score 0.05,
``tests/test_torch_cnn_cli.py``), and no count, P, R, F1 or AP moved on
these frames.  Paths the originals hard-code (the reference's data root,
``/tmp``) are redirected into the test's directory by patching the
loader functions both twins import.  The profile twin's FLOP model is held
against the GFLOP line ``scripts/cnn_profile.py --size gtsdb --batch 1``
prints for each arch.  Every twin has the original's parser defaults (but
``--device``; ``scripts/int8_probe.py`` and ``scripts/tpu_microbench.py``
have no parser) and, as
``scripts/resident_ab_torch.py``, exits 2 without a card.
"""

import contextlib
import io
import os
import re
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
import opencv_traffic_sign_detector_tpu.data.gt as jgt
import opencv_traffic_sign_detector_tpu.data.images as jimages
import opencv_traffic_sign_detector_tpu.eval.ap as jap
import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.mean_masks as jmm
import opencv_traffic_sign_detector_tpu.ops.pallas_prop as jprop
import opencv_traffic_sign_detector_tpu.utils.serialization as jser
import opencv_traffic_sign_detector_tpu_torch.data.gt as tgt
import opencv_traffic_sign_detector_tpu_torch.data.images as timages
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.mean_masks as tmm
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_gt_dir, write_train_dir
from test_torch_cnn_train import _parser_defaults
from test_torch_mser_xla import _rolls_interpret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cnn_profile  # noqa: E402
import cnn_profile_torch  # noqa: E402
import cnn_threshold_sweep  # noqa: E402
import cnn_threshold_sweep_torch  # noqa: E402
import cnn_variants  # noqa: E402
import cnn_variants_torch  # noqa: E402
import int8_probe_torch  # noqa: E402
import mxu_peak  # noqa: E402
import mxu_peak_torch  # noqa: E402
import parity_subset  # noqa: E402
import parity_subset_torch  # noqa: E402
import proposal_recall  # noqa: E402
import proposal_recall_torch  # noqa: E402
import quality_probe  # noqa: E402
import quality_probe_torch  # noqa: E402
import rec_test_run  # noqa: E402
import rec_test_run_torch  # noqa: E402
import resident_ab_torch  # noqa: E402
import stage_profile  # noqa: E402
import stage_profile_torch  # noqa: E402
import tpu_microbench_torch  # noqa: E402

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

DET_ROOT = "/root/reference/Deteción de Objetos"  # the originals' data root
TWINS = {  # original -> twin
    cnn_profile: cnn_profile_torch, cnn_threshold_sweep: cnn_threshold_sweep_torch,
    parity_subset: parity_subset_torch, proposal_recall: proposal_recall_torch,
    quality_probe: quality_probe_torch, rec_test_run: rec_test_run_torch,
    stage_profile: stage_profile_torch, mxu_peak: mxu_peak_torch,
    cnn_variants: cnn_variants_torch,
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A GTSDB-style root: test_alumnos_jpg (2 labelled 256x256 frames and
    gt.txt) and train_jpg (template crops)."""
    root = tmp_path_factory.mktemp("det_root")
    write_gt_dir(str(root / "test_alumnos_jpg"), 2, 256, 256, seed=0)
    write_train_dir(str(root / "train_jpg"), seed=3)
    return str(root)


@pytest.fixture
def interpret(monkeypatch):
    """Every reference kernel through the Pallas interpreter."""
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jprop, "propagate_rolls_pallas", _rolls_interpret)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _run(main, argv=None, sys_argv=None, monkeypatch=None) -> tuple[int, list[str]]:
    """``main(argv)``, or ``main()`` with ``sys.argv`` set (the originals
    that read it); -> (return code, stdout lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if sys_argv is not None:
            monkeypatch.setattr(sys, "argv", ["tool"] + sys_argv)
            rc = main()
        else:
            rc = main(argv)
    return rc or 0, out.getvalue().splitlines()


def _untimed(lines: list[str]) -> list[str]:
    """Lines with every time and rate (``12.3s``, ``(4s)``, ``0.53 fps``)
    replaced by ``T``."""
    return [re.sub(r"\d+(?:\.\d+)?(?:s\b| fps)", "T", ln) for ln in lines]


def _moved(path: str, src: str, dst: str) -> str:
    return dst + path[len(src):] if path.startswith(src) else path


def _redirect(monkeypatch, mod, name: str, src: str, dst: str) -> None:
    """``mod.name(path, ...)`` reads ``dst`` where it was given ``src``."""
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda p, *a, **kw: orig(_moved(p, src, dst), *a, **kw))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


# --- the MSER tools -----------------------------------------------------------

def test_quality_probe_equal_reference(tree, interpret, tmp_path, monkeypatch):
    """Defaults (fused sweep, roll-flood refine, 256 regions): both train
    templates from the tree into their caches beside the script, run the
    whole test dir and print the same PROBE line; probe_<tag>.txt equal."""
    ref_tmp, port_tmp = tmp_path / "ref_tmp", tmp_path / "port_tmp"
    for mod in (quality_probe, quality_probe_torch):
        monkeypatch.setattr(mod, "DET", tree)
        scripts = tmp_path / mod.__name__ / "scripts"
        scripts.mkdir(parents=True)
        monkeypatch.setattr(mod, "__file__", str(scripts / "tool.py"))
    ref_tmp.mkdir()
    port_tmp.mkdir()
    _redirect(monkeypatch, jser, "write_results_file", "/tmp", str(ref_tmp))
    _redirect(monkeypatch, jap, "score_detection_files", "/tmp", str(ref_tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(port_tmp))
    argv = ["--batch", "2", "--tag", "t"]
    rc_ref, ref = _run(quality_probe.main, argv)
    rc_port, port = _run(quality_probe_torch.main, argv + ["--device", "cpu"])
    assert rc_ref == rc_port == 0
    assert _untimed(port) == _untimed(ref)
    assert "dets=0 " not in ref[-1]
    assert _read(port_tmp / "probe_t.txt") == _read(ref_tmp / "probe_t.txt")
    caches = [np.load(tmp_path / m.__name__ / "mean_masks.npz")
              for m in (quality_probe, quality_probe_torch)]
    np.testing.assert_array_equal(caches[1]["red"], caches[0]["red"])


def _os_with_tmp(dst: str):
    """The ``os`` module as the original sees it, with ``os.path.exists``
    reading ``dst`` where it is given ``/tmp``."""
    path = types.ModuleType("os.path")
    path.__dict__.update(os.path.__dict__)
    path.exists = lambda p: os.path.exists(_moved(p, "/tmp", dst))
    proxy = types.ModuleType("os")
    proxy.__dict__.update(os.__dict__)
    proxy.path = path
    return proxy


def test_parity_subset_equal_reference(tree, interpret, tmp_path, monkeypatch):
    """Defaults (``--downscale 1 --max_regions 768``: the XLA sweep, K5 and
    K4) on the tree's 2 frames: the reference's data root is redirected in
    the loaders both twins import, its /tmp template cache into the test's
    dir; both train templates, print the same lines, write the same
    resultado and score the fixture's reference detections (none of them
    on these frames) alike."""
    ref_tmp, port_tmp = tmp_path / "ref_tmp", tmp_path / "port_tmp"
    ref_tmp.mkdir()
    port_tmp.mkdir()
    for mod, name in [(jimages, "list_frame_files"), (jimages, "load_image_bgr"),
                      (timages, "list_frame_files"), (timages, "load_image_bgr"),
                      (jgt, "load_ground_truth"), (tgt, "load_ground_truth"),
                      (jmm, "train_mean_masks"), (tmm, "train_mean_masks")]:
        _redirect(monkeypatch, mod, name, DET_ROOT, tree)
    monkeypatch.setattr(parity_subset, "os", _os_with_tmp(str(ref_tmp)))
    save = jmm.MeanMaskTemplates.save
    monkeypatch.setattr(jmm.MeanMaskTemplates, "save",
                        lambda self, p: save(self, _moved(p, "/tmp", str(ref_tmp))))
    monkeypatch.setattr(tempfile, "tempdir", str(port_tmp))
    common = ["--frames", "2", "--batch", "2"]
    rc_ref, ref = _run(parity_subset.main, sys_argv=common + ["--out", str(ref_tmp / "r.txt")],
                       monkeypatch=monkeypatch)
    rc_port, port = _run(parity_subset_torch.main,
                         common + ["--out", str(port_tmp / "r.txt"), "--device", "cpu"])
    assert rc_ref == rc_port == 0
    assert _untimed(port) == _untimed(ref)
    assert ref[0] == "training templates..."
    ours = _read(ref_tmp / "r.txt")
    assert ours.strip(), "no detections to compare"
    assert _read(port_tmp / "r.txt") == ours
    np.testing.assert_array_equal(np.load(port_tmp / "mean_masks.npz")["blue"],
                                  np.load(ref_tmp / "mean_masks.npz")["blue"])


@pytest.mark.parametrize("flags", [[], ["--vs_cv2", "--limit", "1"]], ids=["gt", "vs_cv2"])
def test_proposal_recall_equal_reference(flags, tree, interpret):
    """Defaults (fused sweep, scan refine, 512 regions): the same coverage
    lines, against gt.txt and against cv2.MSER's own boxes."""
    if flags:
        pytest.importorskip("cv2")
    test = os.path.join(tree, "test_alumnos_jpg")
    argv = ["--test_path", test, "--batch", "2"] + flags
    rc_ref, ref = _run(proposal_recall.main, argv)
    rc_port, port = _run(proposal_recall_torch.main, argv + ["--device", "cpu"])
    assert rc_ref == rc_port == 0
    assert port == ref
    assert "ceiling: 0/" not in "\n".join(ref)


def test_rec_test_run_equal_reference(tree, interpret, tmp_path, monkeypatch):
    """The r5 classifier over MSER proposals at ``--downscale 2``: the same
    lines (totals, AP) and resultado."""
    test = os.path.join(tree, "test_alumnos_jpg")
    model = os.path.join(REPO, "artifacts", "sign_classifier_r5_cnn")
    common = ["--model", model, "--test_path", test]
    rc_ref, ref = _run(rec_test_run.main, sys_argv=common + ["--out", str(tmp_path / "ref.txt")],
                       monkeypatch=monkeypatch)
    rc_port, port = _run(rec_test_run_torch.main,
                         common + ["--out", str(tmp_path / "port.txt"), "--device", "cpu"])
    assert rc_ref == rc_port == 0
    assert _untimed(port) == _untimed(ref)
    assert _read(tmp_path / "ref.txt").strip(), "no detections to compare"
    assert _read(tmp_path / "port.txt") == _read(tmp_path / "ref.txt")


# --- the CNN tools ------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--input_scale", "1080p"], ["--upscale", "1.6"]],
                         ids=["native", "input_scale_1080p", "upscale_1.6"])
def test_cnn_threshold_sweep_equal_reference(flags, tree, monkeypatch):
    """The shipped v3 checkpoint: the same detection count and the same
    P/R/F1/AP row at every threshold; ``--input_scale 1080p`` resizes with
    ``ops/upscale.py: resize_bilinear_u8`` (the bench's ``_upscale``)."""
    test = os.path.join(tree, "test_alumnos_jpg")
    argv = ["--test_path", test, "--eval_batch", "2"] + flags
    rc_ref, ref = _run(cnn_threshold_sweep.main, sys_argv=argv, monkeypatch=monkeypatch)
    rc_port, port = _run(cnn_threshold_sweep_torch.main, argv + ["--device", "cpu"])
    assert rc_ref == rc_port == 0
    assert _untimed(port) == _untimed(ref)
    assert not ref[1].startswith("0 detections")


class _StubNet:
    """Stands in for the reference's ``SignCenterNet``: ``apply`` returns
    empty maps, so the profile prints its FLOP line without a forward."""

    def __init__(self, cfg):
        self.cfg = cfg

    def apply(self, variables, frames):
        return {k: jnp.zeros((1, 1, 1, c)) for k, c in (("hm", 6), ("size", 2), ("off", 2))}


@pytest.mark.parametrize("arch", ["v3", "slim", "base"])
def test_model_flops_equal_reference(arch, monkeypatch):
    """The GFLOP figure of ``cnn_profile.py --size gtsdb --batch 1`` on each
    arch (a stub network and no timing) equals the twin's FLOP model; on
    v3, the shipped arch, the twin's own run prints the same figure."""
    cfg = jcd.CNNDetectorConfig(arch=arch)
    monkeypatch.setattr(jcd.CNNDetector, "load",
                        staticmethod(lambda path: types.SimpleNamespace(cfg=cfg, params={})))
    monkeypatch.setattr(jcd, "SignCenterNet", _StubNet)
    monkeypatch.setattr(cnn_profile, "timeit", lambda fn, *a, iters=10: 1.0)
    argv = ["--size", "gtsdb", "--batch", "1"]
    _, ref = _run(cnn_profile.main, sys_argv=argv, monkeypatch=monkeypatch)
    line = next(ln for ln in ref if ln.startswith("model FLOPs/batch"))
    gflop = re.search(r"([\d.]+) GFLOP", line).group(1)
    flops = cnn_profile_torch.model_flops(tcd.CNNDetectorConfig(arch=arch), 800, 1360, 1)
    assert f"{flops / 1e9:.1f}" == gflop
    if arch == "v3":
        rc, port = _run(cnn_profile_torch.main, argv + ["--device", "cpu"])
        assert rc == 0
        assert port[0] == "arch v3 (stride 16)"
        assert f"model FLOPs/batch: {gflop} GFLOP" in "\n".join(port)


def test_profile_segments_run(monkeypatch):
    """``--segments`` builds and times every prefix of v3 from the port's
    modules with seeded weights."""
    rc, lines = _run(cnn_profile_torch.main, ["--size", "gtsdb", "--batch", "1", "--segments",
                                              "--device", "cpu"])
    assert rc == 0
    assert [ln.split(":")[0] for ln in lines if ln.startswith("prefix depth")] == [
        f"prefix depth {d}" for d in range(1, 5)]


# --- every twin -----------------------------------------------------------------

@pytest.mark.parametrize("original", list(TWINS), ids=[m.__name__ for m in TWINS])
def test_parser_defaults_equal_reference(original, monkeypatch):
    """With the temp directory at /tmp, where the originals write."""
    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    assert _parser_defaults(TWINS[original].main, monkeypatch) == _parser_defaults(
        original.main, monkeypatch)


@pytest.mark.parametrize("twin", [bench_torch, resident_ab_torch, int8_probe_torch,
                                  tpu_microbench_torch] + list(TWINS.values()),
                         ids=lambda m: m.__name__)
def test_twin_exits_2_without_a_card(twin, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert twin.main([]) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().out
