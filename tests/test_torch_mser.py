"""PyTorch port vs the JAX reference: the MSER proposal step and its kernels
K3 (fused level sweep) and K4 (seed flood + bbox).

All comparisons are bit-exact.  The reference's fused sweep and flood run
through the Pallas interpreter: on CPU its ``mser_regions`` would otherwise
take the XLA sweep, which has other semantics.  ``mser_regions`` is jitted
on its config alone, so the interpret env var is set with ``monkeypatch``
and JAX's caches are cleared around each such test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.ops.mser as jmser
import opencv_traffic_sign_detector_tpu.ops.mser_pallas as jmp
import opencv_traffic_sign_detector_tpu.ops.pallas_prop as jprop
import opencv_traffic_sign_detector_tpu.ops.preprocess as jpre
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.ops.mser as tmser
import opencv_traffic_sign_detector_tpu_torch.ops.mser_cuda as tmc
import opencv_traffic_sign_detector_tpu_torch.ops.prop_cuda as tprop
from opencv_traffic_sign_detector_tpu.config import MSERConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

TUNED = MSERConfig(delta=7, min_area=200, max_area=2000, max_variation=1.0,
                   downscale=2, max_regions=128, ccl_iters=2, ccl_jumps=0,
                   level_step=9, refine_scan_passes=2)


def _port(cfg):
    """A reference MSER config rebuilt from the port's own config module:
    each package's functions take their own package's config."""
    return tcfg.MSERConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def gray():
    """Enhanced gray of 2 synthetic 256x256 frames (the sweep's real input)."""
    frames = make_frames(2, 256, 256, seed=11)
    return np.array(jpre.enhance_contrast(jnp.asarray(frames)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TSD_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _pol_stack(g: np.ndarray) -> np.ndarray:
    both = np.stack([g, 255 - g]).astype(np.uint8)
    return np.pad(both, ((0, 0), (1, 1), (1, 1)), constant_values=255)


def _sweep_inputs(gray, cfg: MSERConfig):
    """Half-res polarity stack of frame 0 and the level schedule."""
    small = gray[0].reshape(128, 2, 128, 2).astype(np.int32).sum((1, 3)) // 4
    s = cfg.level_step
    d_idx = max(1, round(cfg.delta / s))
    num_levels = len(range(0, 256 + (d_idx + 1) * s + 1, s))
    return _pol_stack(small.astype(np.uint8)), d_idx, num_levels


SWEEP_CFGS = {
    "tuned_ds2": dataclasses.replace(TUNED, min_area=50, max_area=500, downscale=1),
    "ring3_step5": MSERConfig(delta=10, min_area=30, max_area=600, max_variation=0.8,
                              level_step=5, ccl_iters=3, ccl_jumps=0, topk_pool=2),
}


@pytest.mark.parametrize("name", sorted(SWEEP_CFGS))
def test_k3_plain_matches_fused_sweep_interpret(gray, name):
    cfg = SWEEP_CFGS[name]
    im2, d_idx, nl = _sweep_inputs(gray, cfg)
    want = np.asarray(jmp.fused_level_sweep(jnp.asarray(im2), cfg, d_idx, nl, interpret=True))
    got = tmc.fused_level_sweep(torch.from_numpy(im2), _port(cfg), d_idx, nl).numpy()
    np.testing.assert_array_equal(got, want)
    _, lbits = tmc.packing_bits(cfg.topk_pool, nl)
    assert (got >> lbits).max() > 0  # some candidates emitted


def test_k3_two_strip_plan_matches(gray, monkeypatch):
    cfg = SWEEP_CFGS["tuned_ds2"]
    im2, d_idx, nl = _sweep_inputs(gray, cfg)
    for mod in (jmp, tmc):
        monkeypatch.setattr(mod, "_VMEM_PX", 132 * 120)
        monkeypatch.setattr(mod, "_HALO_MIN", 24)
        monkeypatch.setattr(mod, "_HALO_MAX", 24)
    plan = tmc.sweep_plan(130, 130, cfg.topk_pool, tmc.plan_halo(_port(cfg)))
    assert plan == jmp.sweep_plan(130, 130, cfg.topk_pool, jmp.plan_halo(cfg))
    assert plan[0] == 2, plan
    jmp.fused_level_sweep.clear_cache()
    try:
        want = np.asarray(jmp.fused_level_sweep(jnp.asarray(im2), cfg, d_idx, nl,
                                                interpret=True))
    finally:
        jmp.fused_level_sweep.clear_cache()
    got = tmc.fused_level_sweep(torch.from_numpy(im2), _port(cfg), d_idx, nl).numpy()
    assert got.shape == want.shape == (2, 2 * plan[1], 132)
    np.testing.assert_array_equal(got, want)


def test_k4_plain_matches_flood_interpret(gray):
    planes = np.concatenate([_pol_stack(g) for g in gray])  # [4, 258, 258]
    rng = np.random.default_rng(12)
    n, win, big = 24, 128, 128 * 128 + 1
    plane = rng.integers(0, 4, n)
    y0 = rng.integers(0, 258 - win + 1, n)
    x0 = rng.integers(0, 258 - win + 1, n)
    sy, sx = rng.integers(0, win, n), rng.integers(0, win, n)
    sy[:4] = [0, win - 1, 64, 64]  # seeds on the masked ring
    sx[:4] = [64, 64, 0, win - 1]
    wins = np.stack([planes[p, a:a + win, b:b + win] for p, a, b in zip(plane, y0, x0)])
    level = (wins[np.arange(n), sy, sx].astype(int) + rng.integers(0, 60, n)).clip(0, 255)
    level[4] = int(wins[4, sy[4], sx[4]]) - 1  # seed above its level: empty
    inner = np.zeros((win, win), bool)
    inner[1:-1, 1:-1] = True
    mask = (wins <= level[:, None, None]) & inner
    seed_map = np.full((n, win, win), big, np.int32)
    seed_map[np.arange(n), sy, sx] = 0
    for passes in (1, 2):
        want = np.asarray(jprop.flood_bbox_pallas(jnp.asarray(seed_map), jnp.asarray(mask), big,
                                                  passes, interpret=True))[:, :5]
        cand = torch.from_numpy(np.stack([plane, y0, x0, sy, sx, level], -1).astype(np.int32))
        got = tprop.flood_bbox(torch.from_numpy(planes), cand, win, win, passes, big).numpy()
        np.testing.assert_array_equal(got, want)
    assert (want[:, 4] > 50).sum() >= 4 and (want[:, 4] == 0).sum() >= 1


@pytest.mark.parametrize("downscale", [2, 1])
def test_mser_regions_matches_interpret(gray, interpret, downscale):
    cfg = dataclasses.replace(TUNED, downscale=downscale)
    h, w = 256 // downscale + 2, 256 // downscale + 2
    assert jmp.fused_sweep_ok(h, w, dataclasses.replace(cfg, downscale=1))
    boxes, valid = tmser.mser_regions(torch.from_numpy(gray), _port(cfg))
    assert boxes.shape == (2, 128, 4) and boxes.dtype == torch.int32
    for i in range(2):
        jb, jv = jmser.mser_regions(jnp.asarray(gray[i]), cfg)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(boxes[i].numpy(), np.asarray(jb))
    assert valid.sum(1).min() >= 1


def test_pooled_topk_prefers_lower_index_on_ties():
    cmap = torch.zeros((1, 2, 8, 8), dtype=torch.int32)
    cmap[0, 0, 5, 5] = cmap[0, 1, 1, 1] = cmap[0, 0, 2, 6] = (7 << 5) | 3
    cfg = dataclasses.replace(TUNED, max_regions=4)
    seeds, _, pol, valid = tmser.pooled_topk_packed(cmap, _port(cfg), 31, 1)
    assert valid.tolist() == [[True, True, True, False]]
    assert seeds[0, :3].tolist() == [[2, 6], [5, 5], [1, 1]]
    assert pol[0, :3].tolist() == [0, 0, 1]


@pytest.mark.parametrize("r, w", [(408, 684), (816, 1360), (24, 20), (408, 101),
                                  (1, 1), (52, 52), (53, 105)])
def test_k3_tiles_fit_the_region(r, w):
    """K3's tile plan: a core plus its halo fits the 64-pixel region, with
    as few tiles as that allows and the fewest ghost rows and columns."""
    th, tw = tmc.sweep_tiles(r, w)
    side = tmc.TILE_REGION - 2 * tmc.SWEEP_SPAN
    assert 0 < th <= side and 0 < tw <= side
    assert -(-r // th) == -(-r // side) and -(-w // tw) == -(-w // side)
    assert -(-r // th) * th - r < -(-r // th) and -(-w // tw) * tw - w < -(-w // tw)


@pytest.mark.parametrize("pool", [1, 2, 4])
def test_plan_helpers_copy_match(pool):
    for max_area, scale in ((500, 2.0), (2000, 2.0), (20000, 1.0)):
        cfg = MSERConfig(max_area=max_area, min_area=10, bbox_area_cap_scale=scale)
        assert tmc.plan_halo(_port(cfg)) == jmp.plan_halo(cfg)
        halo = tmc.plan_halo(_port(cfg))
        for h in (10, 130, 402, 802, 1082, 4000):
            for w in (34, 130, 682, 1362, 1922, 600_000):
                assert tmc.sweep_plan(h, w, pool, halo) == jmp.sweep_plan(h, w, pool, halo)
    for nl in (2, 31, 32, 55):
        assert tmc.packing_bits(pool, nl) == jmp.packing_bits(pool, nl)
