"""PyTorch port vs the JAX reference: CLAHE and its kernels K1/K2.

The port's plain versions (what the CUDA kernels are held against on the
card) are compared with the reference's XLA formula, bit for bit, and with
its Pallas kernels run in interpret mode.  K1 equals the Pallas kernel bit
for bit.  K2 keeps the XLA formula's f32 order (ops/clahe.py:135-137); the
reference's Pallas apply blends columns in a matrix product and differs
from its own XLA formula by 1 gray level on ~0.1% of pixels
(ops/clahe.py:84-85), so against it the port must differ exactly where the
reference's two paths differ, and nowhere else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.ops.clahe as jclahe
import opencv_traffic_sign_detector_tpu.ops.clahe_pallas as jpallas
import opencv_traffic_sign_detector_tpu.ops.preprocess as jpre
import opencv_traffic_sign_detector_tpu_torch.ops.clahe as tclahe
import opencv_traffic_sign_detector_tpu_torch.ops.clahe_cuda as tcuda
import opencv_traffic_sign_detector_tpu_torch.ops.preprocess as tpre
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames


# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

def _gray(kind: str, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    # smooth: gradient + low noise, so tiles have narrow, clipped histograms
    b, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = 60 + 80 * (yy / h) + 40 * np.sin(xx / 23.0)
    return np.clip(base[None] + rng.normal(0, 4, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind,shape", [("random", (2, 256, 256)), ("smooth", (2, 256, 256)),
                                        ("smooth", (1, 100, 172)), ("random", (3, 61, 77))])
def test_clahe_matches_xla_formula(kind, shape):
    g = _gray(kind, shape)
    want = np.asarray(jclahe.clahe_equalize(jnp.asarray(g)))
    got = tclahe.clahe_equalize(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_clahe_matches_pallas_interpret(kind):
    g = _gray(kind, (2, 128, 192), seed=1)
    pallas = np.asarray(jpallas.clahe_equalize_pallas(jnp.asarray(g), interpret=True))
    xla = np.asarray(jclahe.clahe_equalize(jnp.asarray(g)))
    got = tclahe.clahe_equalize(torch.from_numpy(g)).numpy()
    _assert_reference_gap(got, pallas, xla)


def _assert_reference_gap(got, pallas, xla):
    """``got`` equals the XLA formula and differs from the Pallas kernel only
    where the reference's two paths differ, by 1."""
    np.testing.assert_array_equal(got, xla)
    gap = pallas.astype(int) - xla.astype(int)
    assert np.abs(gap).max() <= 1
    np.testing.assert_array_equal(got != pallas, gap != 0)


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_k1_plain_matches_pallas_interpret(kind):
    g = _gray(kind, (2, 128, 192), seed=2)
    want = np.asarray(jpallas.tile_histograms_pallas(jnp.asarray(g), 8, interpret=True))
    np.testing.assert_array_equal(tcuda.tile_histograms_plain(torch.from_numpy(g)).numpy(), want)
    np.testing.assert_array_equal(tcuda.tile_histograms(torch.from_numpy(g)).numpy(), want)


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_k2_plain_matches_pallas_interpret(kind):
    g = _gray(kind, (2, 128, 192), seed=3)
    hist = jclahe._clip_and_redistribute(jclahe._tile_histograms(jnp.asarray(g), 8), 96)
    luts = np.array(jclahe._tile_luts(hist, 16 * 24))
    pallas = np.asarray(jpallas.clahe_apply_pallas(jnp.asarray(g), jnp.asarray(luts), 8,
                                                   interpret=True))
    # the XLA formula's apply step alone (ops/clahe.py:118-138)
    ty1, ty2, ya = jclahe._interp_coords(128, 8, 16)
    tx1, tx2, xa = jclahe._interp_coords(192, 8, 24)
    b = np.arange(2)[:, None, None]
    v = g.astype(np.int64)
    lut = lambda ty, tx: luts[b, ty[None, :, None], tx[None, None, :], v].astype(np.float32)  # noqa: E731
    xa, ya = xa[None, None, :], ya[None, :, None]
    top = lut(ty1, tx1) * (np.float32(1) - xa) + lut(ty1, tx2) * xa
    bot = lut(ty2, tx1) * (np.float32(1) - xa) + lut(ty2, tx2) * xa
    xla = np.clip(np.rint(top * (np.float32(1) - ya) + bot * ya), 0, 255).astype(np.uint8)
    got = tcuda.clahe_apply_plain(torch.from_numpy(g), torch.from_numpy(luts)).numpy()
    _assert_reference_gap(got, pallas, xla)
    np.testing.assert_array_equal(
        tcuda.clahe_apply(torch.from_numpy(g), torch.from_numpy(luts)).numpy(), got)


def test_clip_and_luts_match():
    g = _gray("smooth", (2, 64, 64), seed=4)
    hist = np.asarray(jclahe._tile_histograms(jnp.asarray(g), 8))
    for clip in (1, 3, 40):
        want = np.asarray(jclahe._clip_and_redistribute(jnp.asarray(hist), clip))
        got = tclahe._clip_and_redistribute(torch.from_numpy(hist), clip).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tclahe._tile_luts(torch.from_numpy(want), 64).numpy(),
                                      np.asarray(jclahe._tile_luts(jnp.asarray(want), 64)))


@pytest.mark.parametrize("tiles", [4, 8])
def test_interp_coords_copy_matches(tiles):
    for size in (8, 64, 100, 256, 800, 1360, 1366):
        tile = size // tiles
        for a, b in zip(tclahe._interp_coords(size, tiles, tile),
                        jclahe._interp_coords(size, tiles, tile)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_enhance_contrast_bit_exact():
    frames = make_frames(2, 256, 256, seed=5)
    want = np.asarray(jpre.enhance_contrast(jnp.asarray(frames)))
    got = tpre.enhance_contrast(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, want)
