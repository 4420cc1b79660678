"""PyTorch port vs the JAX reference: the fused sweep's extent-only and
scan-pass bodies (K3 and K7) and the low-res refine (``sweep_res_pipeline``).

All comparisons are exact.  The reference's fused sweep runs through the
Pallas interpreter, as ``tests/test_torch_mser.py`` runs it.  Its scan-pass
body is slow there (seconds for a few small planes), so these planes are
small and the scan cases take a coarser level step.  One plane has no
255 border: a dark band crosses its columns ``w - 1 -> 0`` and dark runs lie
on its second and second-last rows, which pins the wrapping of the
reference's rolls (a run across the seam is one run; a row all in the mask
reduces whole).  Then ``mser_regions`` end to end for each knob, and the
bench and quality-probe twins: their flags build the originals' configs,
and the probe prints the original's line.
"""

import contextlib
import dataclasses
import io
import os
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
import opencv_traffic_sign_detector_tpu.eval.ap as jap
import opencv_traffic_sign_detector_tpu.models.detector as jdet
import opencv_traffic_sign_detector_tpu.ops.mser as jmser
import opencv_traffic_sign_detector_tpu.ops.mser_pallas as jmp
import opencv_traffic_sign_detector_tpu.ops.pallas_prop as jprop
import opencv_traffic_sign_detector_tpu.ops.preprocess as jpre
import opencv_traffic_sign_detector_tpu.utils.serialization as jser
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.detector as tdet
import opencv_traffic_sign_detector_tpu_torch.ops.mser as tmser
import opencv_traffic_sign_detector_tpu_torch.ops.mser_cuda as tmc
from opencv_traffic_sign_detector_tpu.config import MSERConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames
from test_torch_bench import MSER_ARGS, _point_both, _spy_detect_batch
from test_torch_mser_xla import _rolls_interpret
from test_torch_tools import _redirect, _untimed, tree  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import quality_probe  # noqa: E402
import quality_probe_torch  # noqa: E402

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

BASE = MSERConfig(delta=7, min_area=5, max_area=200, max_variation=1.0, level_step=9,
                  ccl_iters=2, ccl_jumps=0)
# the scan-pass cases step 14 (21 levels, still past 255)
BODIES = {
    "extent": dataclasses.replace(BASE, sweep_extent_only=True),
    "scan1": dataclasses.replace(BASE, scan_passes=1, level_step=14),
    "scan2": dataclasses.replace(BASE, scan_passes=2, level_step=14),
    "both": dataclasses.replace(BASE, scan_passes=2, sweep_extent_only=True, level_step=14),
}
TUNED = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                   downscale=2, max_regions=128, ccl_iters=2, ccl_jumps=0,
                   level_step=9, refine_scan_passes=2)


def _port(cfg):
    """The same MSER config from the port's own config module."""
    return tcfg.MSERConfig(**dataclasses.asdict(cfg))


def _schedule(cfg) -> tuple[int, int]:
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d_idx = max(1, round(cfg.delta / s))
    return d_idx, len(range(0, 256 + (d_idx + 1) * s + 1, s))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jprop, "propagate_rolls_pallas", _rolls_interpret)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _gray(h: int, w: int, seed: int) -> np.ndarray:
    """Enhanced gray of one synthetic frame (the sweep's real input): the
    middle [h, w] of a frame twice that size, at least 48x48."""
    fh, fw = max(48, 2 * h), max(48, 2 * w)
    full = np.array(jpre.enhance_contrast(jnp.asarray(make_frames(1, fh, fw, seed=seed))))[0]
    return np.ascontiguousarray(full[h // 2:h // 2 + h, w // 2:w // 2 + w])


def _pol_stack(g: np.ndarray) -> np.ndarray:
    both = np.stack([g, 255 - g]).astype(np.uint8)
    return np.pad(both, ((0, 0), (1, 1), (1, 1)), constant_values=255)


def _seam_plane(h: int = 24, w: int = 40) -> np.ndarray:
    """[1, h, w] without a border: noise over 120, a dark band through
    columns w - 5 .. w - 1 and 0 .. 4 (one run across the seam), dark runs on
    rows 1 and h - 2 and a blob in the middle."""
    rng = np.random.default_rng(5)
    g = (120 + rng.integers(0, 100, (h, w))).astype(np.uint8)
    g[3:h - 3, :5] = 40 + rng.integers(0, 20, (h - 6, 5))
    g[3:h - 3, w - 5:] = 40 + rng.integers(0, 20, (h - 6, 5))
    g[1, 8:30] = 30
    g[h - 2, 12:36] = 60
    g[9:15, 16:24] = 20 + rng.integers(0, 30, (6, 8))
    return g[None]


PLANES = {"bordered": lambda: _pol_stack(_gray(22, 38, seed=3)), "seam": _seam_plane}


# --- K7: every level's byte map ------------------------------------------------

@pytest.mark.parametrize("body,plane", [
    ("extent", "bordered"), ("extent", "seam"), ("scan1", "bordered"), ("scan1", "seam"),
    ("scan2", "seam"), ("both", "bordered"), ("both", "seam"),
])
def test_k7_plain_matches_full_sweep_interpret(body, plane):
    cfg = BODIES[body]
    d_idx, nl = _schedule(cfg)
    im2 = PLANES[plane]()
    want = np.asarray(jmp.fused_level_sweep_full(jnp.asarray(im2), cfg, d_idx, nl,
                                                 interpret=True))
    got = tmc.fused_level_sweep_full(torch.from_numpy(im2), _port(cfg), d_idx, nl)
    assert got.dtype == torch.uint8 and got.shape == (im2.shape[0], nl, *im2.shape[1:])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() >= 5


def test_bodies_differ_from_the_default_sweep():
    """Each body changes the candidates on these planes: the tests above
    would catch a body that fell back to the default one."""
    im2 = torch.from_numpy(PLANES["bordered"]())
    maps = {}
    for name, cfg in [("default", BASE), ("extent", BODIES["extent"]),
                      ("scan", dataclasses.replace(BASE, scan_passes=1))]:
        d_idx, nl = _schedule(cfg)
        maps[name] = tmc.fused_level_sweep_full(im2, _port(cfg), d_idx, nl)
    assert not torch.equal(maps["default"], maps["extent"])
    assert not torch.equal(maps["default"], maps["scan"])


# --- K3: strip windows with a halo ---------------------------------------------

@pytest.mark.parametrize("body", ["extent", "scan2"])
def test_k3_two_strip_plan_matches(body, monkeypatch):
    """A plan of 2 strips of 40 rows (core 24, halo 8) over a 42x24 plane:
    a run reduce must not see past its strip window."""
    cfg = dataclasses.replace(BODIES[body], topk_pool=4)
    d_idx, nl = _schedule(cfg)
    im2 = _pol_stack(_gray(40, 22, seed=4))
    if body != "extent":
        im2 = im2[1:]  # the scan body is slow in the interpreter
    for mod in (jmp, tmc):
        monkeypatch.setattr(mod, "_VMEM_PX", 40 * 24)
        monkeypatch.setattr(mod, "_HALO_MIN", 8)
        monkeypatch.setattr(mod, "_HALO_MAX", 8)
    plan = tmc.sweep_plan(42, 24, 4, tmc.plan_halo(_port(cfg)))
    assert plan == jmp.sweep_plan(42, 24, 4, jmp.plan_halo(cfg)) == (2, 24, 8)
    jmp.fused_level_sweep.clear_cache()
    try:
        want = np.asarray(jmp.fused_level_sweep(jnp.asarray(im2), cfg, d_idx, nl,
                                                interpret=True))
    finally:
        jmp.fused_level_sweep.clear_cache()
    got = tmc.fused_level_sweep(torch.from_numpy(im2), _port(cfg), d_idx, nl).numpy()
    assert got.shape == want.shape == (im2.shape[0], 48, 24)
    np.testing.assert_array_equal(got, want)
    _, lbits = tmc.packing_bits(4, nl)
    assert (want >> lbits).max() > 0


# --- mser_regions end to end ----------------------------------------------------

REGION_CFGS = {
    "extent_only": dataclasses.replace(TUNED, sweep_extent_only=True),
    "scan_passes2": dataclasses.replace(TUNED, scan_passes=2, level_step=14, min_area=40),
    "sweep_res": dataclasses.replace(TUNED, sweep_res_pipeline=True),
    "sweep_res_roll_refine": dataclasses.replace(TUNED, sweep_res_pipeline=True,
                                                 refine_scan_passes=0),
    "sweep_res_xla_sweep": dataclasses.replace(TUNED, sweep_res_pipeline=True, ccl_jumps=1,
                                               ccl_iters=4, min_area=100),
}


@pytest.mark.parametrize("name", list(REGION_CFGS))
def test_mser_regions_match(name, interpret):
    """Boxes and valid equal, frame by frame (one smaller frame for the scan
    body), against the reference with every kernel through the
    interpreter."""
    cfg = REGION_CFGS[name]
    n, h, w = (1, 48, 64) if cfg.scan_passes else (2, 64, 96)
    gray = np.array(jpre.enhance_contrast(jnp.asarray(make_frames(n, h, w, seed=8))))
    tb, tv = tmser.mser_regions(torch.from_numpy(gray), _port(cfg))
    for i in range(n):
        jb, jv = jmser.mser_regions(jnp.asarray(gray[i]), cfg)
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tb[i].numpy(), np.asarray(jb))
    assert tv.sum() > 0, "no proposals to compare; pick another seed"
    if cfg.sweep_res_pipeline:  # boxes on the sweep's grid, scaled back
        assert (tb[tv] % cfg.downscale == 0).all()


# --- the twins ------------------------------------------------------------------

def test_bench_flags_build_the_reference_config(tmp_path, monkeypatch):
    """``--scan_passes 2 --extent_only 1`` on ``--model mser``: the same
    PipelineConfig at every ``detect_batch`` call."""
    _point_both(monkeypatch, str(tmp_path / "absent"), tmp_path)
    calls = {"ref": [], "port": []}
    _spy_detect_batch(monkeypatch, jdet, calls["ref"], True)
    _spy_detect_batch(monkeypatch, tdet, calls["port"], False)
    flags = MSER_ARGS + ["--skip_1080p", "--scan_passes", "2", "--extent_only", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert bench.main(flags) == 0
        assert bench_torch.main(flags + ["--device", "cpu"]) == 0
    assert calls["port"] == calls["ref"] and calls["ref"]
    mser = calls["port"][0][3]["mser"]
    assert (mser["scan_passes"], mser["sweep_extent_only"]) == (2, True)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag,field,value", [
    ("--extent_only", "sweep_extent_only", True), ("--scan_passes", "scan_passes", 3),
    ("--sweep_res", "sweep_res_pipeline", True),
])
def test_quality_probe_flags_build_the_reference_config(flag, field, value, tmp_path,
                                                         monkeypatch):
    """Each flag reaches ``DetectionPipeline``'s config as in the original."""
    seen = {}
    for mod, det in ((quality_probe, jdet), (quality_probe_torch, tdet)):
        scripts = tmp_path / mod.__name__ / "scripts"
        scripts.mkdir(parents=True)
        monkeypatch.setattr(mod, "__file__", str(scripts / "tool.py"))
        shutil.copy(os.path.join(REPO, "artifacts", "mean_masks.npz"),
                    tmp_path / mod.__name__ / "mean_masks.npz")

        def spy(cfg, templates, *a, _mod=mod.__name__, **kw):
            seen[_mod] = dataclasses.asdict(cfg)
            raise _Stop

        monkeypatch.setattr(det, "DetectionPipeline", spy)
    argv = [flag, str(int(value))]
    for main, extra in ((quality_probe.main, []), (quality_probe_torch.main, ["--device", "cpu"])):
        with pytest.raises(_Stop):
            main(argv + extra)
    assert seen["quality_probe_torch"] == seen["quality_probe"]
    assert seen["quality_probe"]["mser"][field] == value


def test_quality_probe_sweep_res_extent_line_equal(tree, interpret, tmp_path,  # noqa: F811
                                                   monkeypatch):
    """``--sweep_res 1 --extent_only 1`` on two frames: the same PROBE line
    and probe_<tag>.txt as the original."""
    ref_tmp, port_tmp = tmp_path / "ref_tmp", tmp_path / "port_tmp"
    for mod in (quality_probe, quality_probe_torch):
        monkeypatch.setattr(mod, "DET", tree)
        scripts = tmp_path / mod.__name__ / "scripts"
        scripts.mkdir(parents=True)
        monkeypatch.setattr(mod, "__file__", str(scripts / "tool.py"))
        shutil.copy(os.path.join(REPO, "artifacts", "mean_masks.npz"),
                    tmp_path / mod.__name__ / "mean_masks.npz")
    ref_tmp.mkdir()
    port_tmp.mkdir()
    _redirect(monkeypatch, jser, "write_results_file", "/tmp", str(ref_tmp))
    _redirect(monkeypatch, jap, "score_detection_files", "/tmp", str(ref_tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(port_tmp))
    argv = ["--batch", "2", "--tag", "v", "--sweep_res", "1", "--extent_only", "1",
            "--level_step", "9", "--ccl_iters", "2"]
    out = {}
    for name, main, extra in (("ref", quality_probe.main, []),
                              ("port", quality_probe_torch.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra) == 0
        out[name] = buf.getvalue().splitlines()
    assert _untimed(out["port"]) == _untimed(out["ref"])
    assert "ext=1" in out["ref"][-1] and "dets=0 " not in out["ref"][-1]
    with open(port_tmp / "probe_v.txt") as a, open(ref_tmp / "probe_v.txt") as b:
        assert a.read() == b.read()
