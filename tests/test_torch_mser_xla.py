"""PyTorch port vs the JAX reference: the XLA level sweep, the non-fused
``mser_regions`` and kernel K7 (the fused sweep's per-level byte maps).

All comparisons are bit-exact.  Which reference path runs where:

* jump-free configs (``ccl_jumps=0``) run the reference without
  ``TSD_PALLAS_INTERPRET``: with it, its ``propagate_min_keys`` would call
  ``propagate_rolls_pallas``, which has no interpret switch and refuses the
  CPU backend.  Its XLA roll passes compute the same keys.  Compared end
  to end with ``refine_scan_passes=0``, where both sides use the roll flood;
* configs with pointer jumps, and every K4 refine (``refine_scan_passes >
  0``), run under the interpreter;
* one test swaps the reference's ``propagate_rolls_pallas`` for the same
  kernel body run through the interpreter, so that the recall config runs
  the reference's product path with every kernel.

``mser_regions`` is jitted on its config alone, so JAX's caches are cleared
around every test that changes the interpret switch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import opencv_traffic_sign_detector_tpu.ops.mser as jmser
import opencv_traffic_sign_detector_tpu.ops.mser_pallas as jmp
import opencv_traffic_sign_detector_tpu.ops.pallas_prop as jprop
import opencv_traffic_sign_detector_tpu.ops.preprocess as jpre
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.ops.mser as tmser
import opencv_traffic_sign_detector_tpu_torch.ops.mser_cuda as tmc
from opencv_traffic_sign_detector_tpu.config import MSERConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

H, W = 80, 112


def _port(cfg):
    """A reference MSER config rebuilt from the port's own config module:
    each package's functions take their own package's config."""
    return tcfg.MSERConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def gray():
    """Enhanced gray of 2 synthetic frames (the sweep's real input)."""
    return np.array(jpre.enhance_contrast(jnp.asarray(make_frames(2, H, W, seed=31))))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def no_interpret(monkeypatch):
    monkeypatch.delenv("TSD_PALLAS_INTERPRET", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _pol_stack(g: np.ndarray) -> np.ndarray:
    both = np.stack([g, 255 - g]).astype(np.uint8)
    return np.pad(both, ((0, 0), (1, 1), (1, 1)), constant_values=255)


def _schedule(cfg: MSERConfig):
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d_idx = max(1, round(cfg.delta / s))
    return s, d_idx, len(range(0, 256 + (d_idx + 1) * s + 1, s))


BASE = dict(min_area=30, max_area=900, max_variation=1.0, fused_sweep=False, max_regions=96)
SWEEP_CFGS = {
    "jumps0_d1": MSERConfig(delta=9, level_step=9, ccl_iters=2, ccl_jumps=0, **BASE),
    "jumps0_d2": MSERConfig(delta=7, level_step=3, ccl_iters=6, ccl_jumps=0, **BASE),
    "jumps1_d1": MSERConfig(delta=7, level_step=0, ccl_iters=8, ccl_jumps=1, **BASE),
    "jumps1_d2": MSERConfig(delta=10, level_step=5, ccl_iters=4, ccl_jumps=1,
                            **dict(BASE, max_variation=0.6)),
}


@pytest.mark.parametrize("name", sorted(SWEEP_CFGS))
def test_level_sweep_matches(gray, no_interpret, name):
    cfg = SWEEP_CFGS[name]
    s, d_idx, nl = _schedule(cfg)
    assert d_idx == int(name[-1])
    assert (nl - 1) * s > 255 + s  # the flush levels past 255 run too
    im2 = np.stack([_pol_stack(g) for g in gray])
    levels = list(range(0, nl * s, s))
    want = np.stack([np.asarray(jmser._level_sweep(jnp.asarray(x.astype(np.int32)), levels,
                                                   cfg, d_idx)) for x in im2])
    got = np.stack([sb.numpy() for sb in tmser._level_sweep(torch.from_numpy(im2),
                                                            _port(cfg),
                                                            d_idx, nl)], axis=1)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert (want > 0).sum() >= 10


def _compare_regions(gray, cfg):
    boxes, valid = tmser.mser_regions(torch.from_numpy(gray), _port(cfg))
    assert boxes.shape == (2, cfg.max_regions, 4) and boxes.dtype == torch.int32
    for i in range(2):
        jb, jv = jmser.mser_regions(jnp.asarray(gray[i]), cfg)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(boxes[i].numpy(), np.asarray(jb))
    assert valid.sum(1).min() >= 1


# --pixel_area_stability and --downscale 1 of the CLIs (pointer jumps, K4
# refine): the reference under the interpreter
PIXEL_AREA = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                        max_regions=64, fused_sweep=False)


@pytest.mark.parametrize("downscale", [2, 1])
def test_pixel_area_regions_match(gray, interpret, downscale):
    _compare_regions(gray, dataclasses.replace(PIXEL_AREA, downscale=downscale,
                                               min_area=60 * downscale ** 2))


def test_jump_config_takes_xla_sweep_with_fused_flag(gray, interpret):
    """``--downscale 1``: fused_sweep stays True, but ccl_jumps=1 sends both
    packages to the XLA sweep."""
    cfg = dataclasses.replace(PIXEL_AREA, fused_sweep=True, min_area=60)
    assert not jmp.fused_sweep_ok(H + 2, W + 2, cfg)
    *_, fused = tmser.sweep_candidates(torch.from_numpy(gray), _port(cfg))
    assert fused is False
    _compare_regions(gray, cfg)


# the recall config of scripts/proposal_recall.py, cut to size
RECALL = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                    downscale=2, ccl_iters=6, ccl_jumps=0, level_step=3,
                    max_regions=128, fused_sweep=False)


@pytest.mark.parametrize("downscale", [2, 1])
def test_roll_refine_regions_match(gray, no_interpret, downscale):
    _compare_regions(gray, dataclasses.replace(RECALL, downscale=downscale,
                                               min_area=50 * downscale ** 2,
                                               refine_scan_passes=0))


def _rolls_interpret(keys, mask, big, num_rolls):
    """The reference's ``propagate_rolls_pallas`` through the interpreter."""
    p, h, w = keys.shape
    block = pl.BlockSpec((1, h, w), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(jprop._kernel, num_rolls=num_rolls, big=big),
        grid=(p,), out_shape=jax.ShapeDtypeStruct(keys.shape, keys.dtype),
        in_specs=[block, block], out_specs=block, interpret=True,
    )(keys, mask.astype(jnp.int8))


def test_recall_config_matches_with_every_reference_kernel(gray, interpret, monkeypatch):
    monkeypatch.setattr(jprop, "propagate_rolls_pallas", _rolls_interpret)
    _compare_regions(gray, dataclasses.replace(RECALL, min_area=100))


def test_frame_without_strip_plan_takes_xla_sweep(gray, no_interpret, monkeypatch):
    """A frame too wide for any strip plan goes to the XLA sweep, as in the
    reference (which on CPU takes that sweep for every frame)."""
    monkeypatch.setattr(tmc, "_VMEM_PX", 1000)
    cfg = dataclasses.replace(RECALL, fused_sweep=True, downscale=1, min_area=50,
                              refine_scan_passes=0)
    assert tmc.sweep_plan(H + 2, W + 2, cfg.topk_pool, tmc.plan_halo(_port(cfg))) is None
    *_, fused = tmser.sweep_candidates(torch.from_numpy(gray), _port(cfg))
    assert fused is False
    _compare_regions(gray, cfg)


def test_sweep_topk_prefers_lower_index_on_ties(monkeypatch):
    """Equal bytes in two levels and two polarities: the lower flat index of
    [L, 2, H*W] wins, as lax.top_k orders them."""
    maps = [torch.zeros((1, 2, 4, 4), dtype=torch.uint8) for _ in range(3)]
    maps[2][0, 0, 1, 1] = maps[1][0, 1, 2, 2] = maps[1][0, 0, 3, 0] = 200
    maps[0][0, 1, 0, 3] = 90
    monkeypatch.setattr(tmser, "_level_sweep", lambda *a: iter(maps))
    cfg = MSERConfig(delta=3, level_step=3, max_regions=5)
    seeds, levels, pol, valid = tmser._sweep_topk(torch.zeros((1, 2, 4, 4)), _port(cfg), 1, 3)
    assert valid.tolist() == [[True, True, True, True, False]]
    assert seeds[0, :4].tolist() == [[3, 0], [2, 2], [1, 1], [0, 3]]
    assert pol[0, :4].tolist() == [0, 1, 0, 1]
    assert levels[0, :4].tolist() == [0, 0, 0, 0]  # max(t*3 - 6, 0)
    assert seeds[0, 4].tolist() == [0, 0] and pol[0, 4] == 0  # first zero byte


# --- K7: the fused sweep's per-level byte maps -------------------------------

K7_CFGS = {
    "tuned": MSERConfig(delta=7, min_area=50, max_area=500, max_variation=1.0,
                        ccl_iters=2, ccl_jumps=0, level_step=9),
    "ring3_step5": MSERConfig(delta=10, min_area=30, max_area=600, max_variation=0.8,
                              level_step=5, ccl_iters=3, ccl_jumps=0, topk_pool=2),
}


@pytest.mark.parametrize("name", sorted(K7_CFGS))
def test_k7_plain_matches_full_sweep_interpret(gray, name):
    cfg = K7_CFGS[name]
    _, d_idx, nl = _schedule(cfg)
    im2 = _pol_stack(gray[0])
    want = np.asarray(jmp.fused_level_sweep_full(jnp.asarray(im2), cfg, d_idx, nl,
                                                 interpret=True))
    got = tmc.fused_level_sweep_full(torch.from_numpy(im2), _port(cfg), d_idx, nl)
    assert got.dtype == torch.uint8 and got.shape == (2, nl, H + 2, W + 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() >= 5


@pytest.mark.parametrize("name", sorted(K7_CFGS))
def test_k3_equals_fold_of_k7(gray, name):
    """K3's output on single-strip windows is K7's per-level maps folded into
    max over levels of (byte << lbits) | t."""
    cfg = K7_CFGS[name]
    _, d_idx, nl = _schedule(cfg)
    im2 = torch.from_numpy(_pol_stack(gray[1]))
    n_strips, core, halo = tmc.sweep_plan(H + 2, W + 2, cfg.topk_pool,
                                          tmc.plan_halo(_port(cfg)))
    assert (n_strips, halo) == (1, 0)
    _, lbits = tmc.packing_bits(cfg.topk_pool, nl)
    wp = -(-(W + 2) // max(1, cfg.topk_pool)) * max(1, cfg.topk_pool)
    windows = torch.full((2, core, wp), 255, dtype=torch.uint8)
    windows[:, :H + 2, :W + 2] = im2
    k3 = tmc.level_sweep_windows(windows, tmc.SweepParams.from_config(_port(cfg), d_idx),
                                 core, 0, nl, lbits)
    k7 = tmc.fused_level_sweep_full(windows, _port(cfg), d_idx, nl).to(torch.int32)
    fold = (k7 * (1 << lbits) + torch.arange(nl).view(1, nl, 1, 1)).amax(1)
    np.testing.assert_array_equal(fold.numpy(), k3.numpy())
    np.testing.assert_array_equal(
        k3.numpy(), tmc.fused_level_sweep(im2, _port(cfg), d_idx, nl).numpy())
