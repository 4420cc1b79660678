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
import types

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


# --- the scan-pass kernel's plan and its band decomposition ---------------------

H100_SMS, H100_SMEM = 132, 232448
# (windows, rows, columns) -> (rows a band, bands, windows a wave, waves)
SCAN_PLANS = {
    "tuned": ((64, 408, 684), (26, 16, 8, 8)),
    "two_strip": ((16, 808, 1364), (13, 63, 2, 8)),
    "probe_1080p": ((64, 552, 964), (17, 33, 4, 16)),
}


@pytest.mark.parametrize("name", list(SCAN_PLANS))
def test_scan_plan_at_the_card_limits(name):
    """The plan of each shape the scan-pass body runs at on an H100: every
    band of a window resident at once, bands covering the rows with none
    empty, the shared memory within a block's, the fewest waves x band rows
    among the band heights that fit."""
    (n, r, w), want = SCAN_PLANS[name]
    plan = tmc.scan_plan(n, r, w, H100_SMS, H100_SMEM)
    assert (plan.rows, plan.bands, plan.slots, plan.waves) == want
    assert plan.grid <= H100_SMS and plan.slots * plan.waves >= n
    assert (plan.bands - 1) * plan.rows < r <= plan.bands * plan.rows
    assert plan.smem_bytes == plan.rows * (13 * w + 4) <= H100_SMEM
    assert plan.summary_bytes == 4 * plan.slots * (32 + 2 * plan.bands * 8 * w)
    cost = plan.waves * plan.rows
    for rows in range(1, H100_SMEM // (13 * w + 4) + 1):
        bands = -(-r // rows)
        if bands <= H100_SMS:
            assert -(-n // min(H100_SMS // bands, n)) * rows >= cost


@pytest.mark.parametrize("shape,why", [
    ((1, 4, 17881), "does not fit one block"),  # a row wider than a block holds
    ((4, 3500, 684), "more than the 132 blocks"),  # a window's bands not all resident
    ((1, 4, 1 << 15), "int16"),
])
def test_scan_plan_refuses_windows_it_cannot_hold(shape, why):
    with pytest.raises(ValueError, match=why):
        tmc.scan_plan(*shape, H100_SMS, H100_SMEM)
    assert tmc.scan_plan(1, 4, 17880, H100_SMS, H100_SMEM).rows == 1  # the widest row


def test_scan_device_reads_the_opt_in_limit(monkeypatch):
    """The plan's card limits come from torch's device properties: an H100
    reports 132 SMs of 233472 bytes of shared memory, of which a block may
    opt in to 232448 (1024 reserved a block)."""
    props = types.SimpleNamespace(multi_processor_count=132,
                                  shared_memory_per_multiprocessor=233472)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    assert tmc.scan_device(torch.device("cuda", 0)) == (H100_SMS, H100_SMEM)


def _band_column_resolve(mask, keys, chans, rows: int, big: int, bigc: int):
    """Plain model of the kernel's column resolve by bands of ``rows``
    window rows (csrc/mser_sweep.cu: band_col_resolve) over the state as the
    kernel keeps it (sentinels off the mask, channels at their fills where the
    key is < 0): per band and column a summary (a break in the band, the
    reduce of its top run and of its bottom run), then per band the carries
    (the bottom runs of the bands above to the first band with a break, the
    top runs of those below), then the local apply of each run's whole
    value, the carries joining only the runs on the band's first and last
    rows.  -> (keys, [ymin, ymax, xmin, xmax])."""
    mn, mx = torch.minimum, torch.maximum
    ops, ident = [mn, mn, mx, mn, mx], [big, bigc, -1, bigc, -1]
    live = mask & (keys >= 0)
    vals = [torch.where(mask, keys, big)] + [
        torch.where(live, c, f) for c, f in zip(chans, ident[1:])]
    n, r, w = mask.shape
    bands = -(-r // rows)
    spans = [(b * rows, min(r, (b + 1) * rows)) for b in range(bands)]

    def full(v):
        return torch.full((n, w), v, dtype=torch.int32)

    summaries = []
    for y0, y1 in spans:
        brk = torch.zeros((n, w), dtype=torch.bool)
        top, bot = [full(v) for v in ident], [full(v) for v in ident]
        for y in range(y0, y1):
            m = mask[:, y]
            top = [torch.where(~brk & m, op(t, v[:, y]), t) for t, v, op in zip(top, vals, ops)]
            bot = [torch.where(m, op(b, v[:, y]), full(i))
                   for b, v, op, i in zip(bot, vals, ops, ident)]
            brk = brk | ~m
        summaries.append((brk, top, bot))
    out = [v.clone() for v in vals]
    for b, (y0, y1) in enumerate(spans):
        up, dn = [full(v) for v in ident], [full(v) for v in ident]
        for others, carry, part in ((range(b - 1, -1, -1), up, 2), (range(b + 1, bands), dn, 1)):
            stop = torch.zeros((n, w), dtype=torch.bool)
            for bb in others:
                s = summaries[bb]
                carry[:] = [torch.where(stop, c, op(c, v)) for c, v, op in zip(carry, s[part], ops)]
                stop = stop | s[0]
        # forward: each pixel the reduce from its run's start, the carry from
        # above joining a run on the band's first row
        acc, fwd = up, []
        for y in range(y0, y1):
            m = mask[:, y]
            acc = [torch.where(m, op(a, v[:, y]), full(i))
                   for a, v, op, i in zip(acc, vals, ops, ident)]
            fwd.append(acc)
        # backward: each run its value at its end, the carry from below
        # joining a run on the band's last row
        res = None
        for j in range(y1 - y0 - 1, -1, -1):
            y = y0 + j
            m = mask[:, y]
            end = [op(f, d) for f, d, op in zip(fwd[j], dn, ops)] if j == y1 - y0 - 1 else (
                [torch.where(mask[:, y + 1], rv, f) for rv, f in zip(res, fwd[j])])
            res = end
            for o, v in zip(out, res):
                o[:, y] = torch.where(m, v, o[:, y])
    keys = torch.where(mask, out[0], big)
    live = mask & (keys >= 0)
    return keys, [torch.where(live, v, f) for v, f in zip(out[1:], ident[1:])]


@pytest.mark.parametrize("rows", [1, 2, 7, "r"])
def test_band_column_resolve_matches_axis_resolve(rows):
    """The band decomposition equals ``axis_resolve`` along the columns, run
    through the sweep's key and channel handling, on masks whose runs cross
    bands, columns all mask inside a band (and across all bands) and dead
    keys (-1) that must spread through their runs."""
    rng = np.random.default_rng(11)
    n, r, w = 3, 31, 23
    big, bigc = 256 * r * w, 1 << 28
    mask = rng.random((n, r, w)) < 0.8
    mask[:, :, 3] = True            # a whole column: one run across every band
    mask[:, 9:17, 5:8] = True       # all mask across a band boundary
    mask[:, 14, 10:12] = False      # a break just inside a band
    mask[:, [0, -1]] = False        # the window's first and last rows
    keys = rng.integers(0, big, (n, r, w))
    keys[rng.random((n, r, w)) < 0.06] = -1
    keys[:, 20, 3] = -1             # a dead key in the whole column's run
    chans = [rng.integers(0, r, (n, r, w)), rng.integers(0, r, (n, r, w)),
             rng.integers(0, w, (n, r, w)), rng.integers(0, w, (n, r, w))]
    mask_t = torch.from_numpy(mask)
    keys_t = torch.from_numpy(keys.astype(np.int32))
    chans_t = [torch.from_numpy(c.astype(np.int32)) for c in chans]
    want_k, want_c = tmc._scan_resolve(mask_t, keys_t, chans_t, -2, big, bigc)
    got_k, got_c = _band_column_resolve(mask_t, keys_t, chans_t, r if rows == "r" else rows,
                                        big, bigc)
    assert torch.equal(got_k, want_k)
    for g, wnt in zip(got_c, want_c):
        assert torch.equal(g, wnt)
    assert (want_k[:, 1:-1, 3] == -1).all()  # the dead key spread through its run


def _sweep_levels_ring_skip(windows: torch.Tensor, p, num_levels: int):
    """The plain sweep's levels with the scan-pass kernel's ring traffic
    (csrc/mser_sweep.cu: band_row_emit): the rings start as garbage, a pixel
    off the level's mask neither reads nor writes them and emits as a
    non-candidate, and at its first level in the mask it reads their initial
    values and writes every slot.  Yields each level's byte map."""
    n, r, w = windows.shape
    f32, bf16 = torch.float32, torch.bfloat16
    hw = r * w
    big, bigc = 256 * hw, 1 << 28
    im = windows.to(torch.int32)
    rows = torch.arange(r, dtype=torch.int32).view(1, r, 1)
    cols = torch.arange(w, dtype=torch.int32).view(1, 1, w)
    keys0 = im * hw + rows * w + cols
    mn, mx = torch.minimum, torch.maximum
    keys = torch.full((n, r, w), big, dtype=torch.int32)
    chans = [torch.full((n, r, w), v, dtype=torch.int32) for v in (bigc, -1, bigc, -1)]
    nring = p.d + 1
    rings = torch.full((p.d + 4, n, r, w), float("nan"), dtype=bf16)  # garbage
    zero, inf = torch.tensor(0.0), torch.tensor(float("inf"))
    for t in range(num_levels):
        level = t * p.step
        mask = (im <= level) & (rows > 0) & (rows < r - 1)
        first = mask & (im > level - p.step)
        keys = torch.where(mask, mn(keys, keys0), big)
        chans = [torch.where(mask, op(c, v), fill) for c, v, op, fill in
                 zip(chans, (rows, rows, cols, cols), (mn, mx, mn, mx), (bigc, -1, bigc, -1))]
        keys, *chans = tmc._scan_resolves(mask, keys, chans, p.scan_passes, big, bigc)
        ymin, ymax, xmin, xmax = chans
        anchor = mask & (keys == keys0)
        bb = mn((ymax - ymin + 1).to(f32) * (xmax - xmin + 1).to(f32), torch.tensor(65535.0))
        a_cur = torch.where(anchor, bb, zero)
        keys = torch.where(anchor & (bb > p.max_area), -1, keys)
        s_area = t % nring
        s_td = (t + nring - p.d % nring) % nring
        s_vnew = nring + (t + 2 * nring - p.d) % 2
        s_vc = 2 * nring + 1 - s_vnew
        s_last = nring + 2

        def read(slot, init):
            return torch.where(first, init, rings[slot].to(f32))

        area_c, a_td = read(s_area, zero), read(s_td, zero)
        v_c, v_prev, last = read(s_vc, inf), read(s_vnew, inf), read(s_last, zero)
        v_new = torch.where((a_td > 0) & (a_cur > 0), (a_cur - a_td) / mx(a_td, torch.tensor(1.0)),
                            inf)
        cand = ((area_c >= p.min_area) & (area_c <= p.max_area) & (v_c < p.max_variation)
                & (v_c <= v_prev) & (v_c <= v_new))
        cand &= (last <= 0) | ((area_c - last) >= p.min_diversity * mx(area_c, torch.tensor(1.0)))
        cand &= mask
        qv = torch.clamp(254.0 - torch.floor(v_c * 253.0), 1.0, 254.0)
        for k in range(nring):  # at a first level every slot is written
            rings[k] = torch.where(first, zero.to(bf16), rings[k])
        rings[s_vc] = torch.where(first, inf.to(bf16), rings[s_vc])
        writes = ((s_area, a_cur), (s_vnew, v_new), (s_last, torch.where(cand, area_c, last)))
        for slot, v in writes:
            rings[slot] = torch.where(mask, v.to(bf16), rings[slot])
        yield torch.where(cand, qv, zero)


@pytest.mark.parametrize("body", ["scan1", "scan2"])
def test_ring_skip_equals_the_plain_rings(body):
    """The scan-pass kernel leaves a pixel's rings untouched until it joins
    the mask and then starts them from their initial values: the same
    candidates, level by level, as the plain sweep's rings over every pixel
    (on bordered planes and the seam plane, dead marks included)."""
    cfg = dataclasses.replace(BODIES[body], max_area=60)
    d_idx, nl = _schedule(cfg)
    p = tmc.SweepParams.from_config(_port(cfg), d_idx)
    for plane in PLANES.values():
        win = torch.from_numpy(plane())
        got = list(_sweep_levels_ring_skip(win, p, nl))
        want = list(tmc._sweep_levels_plain(win, p, nl))
        assert len(got) == len(want) == nl
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt)
        assert sum(int((wnt > 0).sum()) for wnt in want) > 0
