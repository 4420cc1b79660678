"""PyTorch port vs the JAX reference: yuv420 ingest, the bilinear upscale
and the fused upscale+stem.

Inputs are made with numpy from a fixed seed and handed to both packages.
Tolerances: yuv420 conversion is integer math and bit-exact; the host-side
plans and tap tables are equal exactly; the upscale is within 1 count (the
f32 band products sum in another order, which can flip a round at .5) on a
stated share of values; the fused stem in f32 is within the reference's own
bound against its unrounded oracle (atol 2e-4, rtol 1e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.ops.fused_upscale as jfu
import opencv_traffic_sign_detector_tpu.ops.upscale as jup
import opencv_traffic_sign_detector_tpu.ops.yuv as jyuv
import opencv_traffic_sign_detector_tpu_torch.ops.fused_upscale as tfu
import opencv_traffic_sign_detector_tpu_torch.ops.upscale as tup
import opencv_traffic_sign_detector_tpu_torch.ops.yuv as tyuv

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _planes(b, h, w, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    cb = rng.integers(0, 256, (b, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (b, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    return y, cb, cr


# --- yuv420 -------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(16, 24), (17, 23), (1, 3), (64, 96)])
def test_yuv420_to_bgr_bit_exact(h, w):
    y, cb, cr = _planes(2, h, w, seed=h * w)
    want = np.asarray(jyuv.yuv420_to_bgr(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    got = tyuv.yuv420_to_bgr(*map(torch.from_numpy, (y, cb, cr))).numpy()
    assert got.shape == (2, h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_yuv420_patches_bit_exact_and_equal_to_tight_route():
    y, cb, cr = _planes(2, 48, 64, seed=5)
    want_planes = jyuv.patchify_yuv_planes(y, cb, cr)
    planes = tyuv.patchify_yuv_planes(y, cb, cr)
    for got, want in zip(planes, want_planes):
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jyuv.yuv420_patches_to_bgr_patches8(*map(jnp.asarray, planes)))
    got = tyuv.yuv420_patches_to_bgr_patches8(*map(torch.from_numpy, planes)).numpy()
    np.testing.assert_array_equal(got, want)
    # the patches route equals the port's own tight route, patchified
    tight = tyuv.yuv420_to_bgr(*map(torch.from_numpy, (y, cb, cr))).numpy()
    patched = tight.reshape(2, 6, 8, 8, 24).transpose(0, 1, 3, 2, 4).reshape(2, 6, 8, 192)
    np.testing.assert_array_equal(got, patched)


def test_fancy_kernel_table_equal():
    for got, want in zip(tyuv._fancy_kernel_and_bias(), jyuv._fancy_kernel_and_bias()):
        np.testing.assert_array_equal(got, want)


# --- bilinear upscale -----------------------------------------------------------

def _rand_frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("hw,thw,route", [
    ((50, 34), (71, 48), "phase"),       # T=71 rows / T=24 cols
    ((64, 64), (128, 128), "phase"),     # integer 2x
    ((40, 68), (52, 88), "phase"),       # 1.3x, as upscaled_hw gives on GTSDB frames
    ((16, 16), (16, 24), "phase"),       # one axis only
    ((127, 16), (256, 24), "dense"),     # rows T=256 > 192: dense; cols phase
    ((32, 48), (16, 24), "dense"),       # downscale: antialiased dense pass
    ((80, 136), (64, 112), "dense"),     # the 0.9 operating point's ratio class
    ((32, 48), (16, 96), "dense"),       # rows down, cols up
])
def test_upscale_within_one_count(hw, thw, route):
    frames = _rand_frames((2, *hw, 3), seed=hw[0] + thw[1])
    want = np.asarray(jup.upscale_bilinear_u8(jnp.asarray(frames), *thw))
    got = tup.upscale_bilinear_u8(torch.from_numpy(frames), *thw).numpy()
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    # measured: at most a few values in 10^4 flip a .5 round
    assert (diff != 0).mean() <= 0.002, (diff != 0).mean()
    if route == "dense":
        assert thw[0] < hw[0] or thw[1] < hw[1] or tup._phase_plan(hw[0], thw[0]) is None


def test_dense_weights_equal_jax_resize_weights():
    import jax.image

    for in_size, out_size in [(32, 16), (800, 720), (1360, 1216), (127, 256)]:
        eye = np.eye(in_size, dtype=np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(eye), (in_size, out_size), "bilinear"))
        got = tup._dense_weights(in_size, out_size, "cpu").numpy()
        # XLA may contract the sample positions' product and sum into an
        # FMA: positions near 800 then differ by one f32 ulp (6.1e-5),
        # which moves a weight by at most 1.3e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        assert (got != want).mean() < 1e-3


def test_upscale_axis_raises_on_degenerate_plan():
    with pytest.raises(ValueError, match="no phase plan"):
        tup._upscale_axis(torch.zeros((1, 127, 16, 3), dtype=torch.uint8), 1, 256)


def test_phase_plans_and_bands_equal():
    for in_size, out_size in [(800, 1040), (1360, 1760), (800, 1136), (7, 12), (127, 256)]:
        want, got = jup._phase_plan(in_size, out_size), tup._phase_plan(in_size, out_size)
        assert got == want
        if want is not None:
            np.testing.assert_array_equal(tup._band_matrix(want[0], want[2], want[3]),
                                          jup._band_matrix(want[0], want[2], want[3]))


# --- fused upscale + stem -----------------------------------------------------

def _fields(plan):
    return None if plan is None else dataclasses.astuple(plan)


def test_find_plan_equals_reference_over_a_grid():
    for h, w in [(800, 1360), (1088, 1920), (160, 160), (68, 68), (60, 76), (40, 80)]:
        for s in [0.9, 1.0, 1.3, 1.412, 1.5, 1.51, 1.55, 1.6, 1.75, 2.0, 2.5]:
            assert _fields(tfu.find_plan(h, w, s)) == _fields(jfu.find_plan(h, w, s)), (h, w, s)
    # the shipped points on GTSDB frames
    p = tfu.find_plan(800, 1360, 1.6)
    assert (p.t, p.a, p.sb, p.h_pad, p.w_pad) == (8, 5, 1, 800, 1360)
    p = tfu.find_plan(800, 1360, 1.412)
    assert (p.t, p.a, p.sb, p.h_pad) == (24, 17, 3, 816)
    assert tfu.find_plan(800, 1360, 1.3) is None
    assert tfu.find_plan(800, 1360, 1.75) is None
    assert tfu.find_plan(800, 1360, 0.9) is None


def test_tap_tables_equal():
    for h, w, s in [(800, 1360, 1.6), (800, 1360, 1.412), (48, 32, 2.0), (1088, 1920, 1.412)]:
        plan = jfu.find_plan(h, w, s)
        np.testing.assert_array_equal(tfu._superblock_taps(plan.t, plan.a, plan.sb, plan.n),
                                      jfu._superblock_taps(plan.t, plan.a, plan.sb, plan.n))
        np.testing.assert_array_equal(tfu._width_conv_weights(plan),
                                      jfu._width_conv_weights(plan))


@pytest.mark.parametrize("hw,scale", [
    ((68, 68), 1.412),    # 24/17, no padding
    ((60, 76), 1.412),    # 24/17 with height and width padding
    ((40, 80), 1.6),      # 8/5, sb = 1
    ((48, 32), 2.0),      # integer 2x
])
def test_fused_stem_f32_matches_reference(hw, scale):
    rng = np.random.default_rng(42)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    kernel = rng.normal(0, 0.1, (8, 8, 3, 16)).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    plan = jfu.find_plan(*hw, scale)
    want = np.asarray(jfu.fused_upscale_stem(jnp.asarray(frames), jnp.asarray(kernel),
                                             jnp.asarray(bias), plan, dtype=jnp.float32))
    got = tfu.fused_upscale_stem(torch.from_numpy(frames), torch.from_numpy(kernel),
                                 torch.from_numpy(bias), tfu.find_plan(*hw, scale),
                                 dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, plan.h_out // 8, plan.w_out // 8, 16)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
