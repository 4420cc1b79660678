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


K2_PLAN_SHAPES = [(tiles, th, tw) for tiles in range(1, 9)
                  for th, tw in [(1, 3), (3, 5), (7, 2), (25, 17), (50, 33), (51, 96), (101, 169)]]


@pytest.mark.parametrize("tiles,th,tw", K2_PLAN_SHAPES)
def test_k2_launch_plan(tiles, th, tw):
    """K2's row pieces cover every row once, in order, at most PIECE_ROWS
    each, with the tile rows of ``_interp_coords`` constant inside; each
    column's case names its (tx1, tx2); the segments cover every column."""
    h, w = tiles * th, tiles * tw
    pieces, ya, col_case, xa, max_cases = tcuda.apply_plan(h, w, tiles)
    ty1, ty2, ya_want = tclahe._interp_coords(h, tiles, th)
    assert pieces.dtype == np.int32 and pieces[0, 0] == 0 and pieces[-1, 1] == h
    np.testing.assert_array_equal(pieces[1:, 0], pieces[:-1, 1])
    assert ((pieces[:, 1] > pieces[:, 0]) & (pieces[:, 1] - pieces[:, 0] <= tcuda.PIECE_ROWS)).all()
    for r0, r1, t1, t2 in pieces:
        assert (ty1[r0:r1] == t1).all() and (ty2[r0:r1] == t2).all()
    np.testing.assert_array_equal(ya, ya_want)
    tx1, tx2, xa_want = tclahe._interp_coords(w, tiles, tw)
    k = col_case.astype(int)
    np.testing.assert_array_equal(np.maximum(k - 1, 0), tx1)
    np.testing.assert_array_equal(np.minimum(k, tiles - 1), tx2)
    np.testing.assert_array_equal(xa, xa_want)
    assert (np.diff(k) >= 0).all() and k.max() <= tiles  # a segment's cases are a range
    spans = [k[min(c + tcuda.SEG_COLS, w) - 1] - k[c] + 1 for c in range(0, w, tcuda.SEG_COLS)]
    assert max_cases == max(spans) <= tiles + 1


def _k2_emulated(x: np.ndarray, luts: np.ndarray, tiles: int) -> np.ndarray:
    """csrc/clahe.cu's clahe_apply_kernel in numpy: per row piece and column
    segment, the packed four-LUT table and the blend with its exact byte
    conversion and rounding by adds."""
    b, h, w = x.shape
    pieces, ya, col_case, xa, max_cases = tcuda.apply_plan(h, w, tiles)
    f32 = np.float32
    out = np.empty_like(x)

    def byte_float(e, i):
        return (((e >> np.uint32(8 * i)) & np.uint32(255)) | np.uint32(0x4B000000)).view(f32) \
            - f32(8388608.0)

    for f in range(b):
        for r0, r1, t1, t2 in pieces:
            for c0 in range(0, w, tcuda.SEG_COLS):
                c1 = min(c0 + tcuda.SEG_COLS, w)
                k = np.arange(col_case[c0], col_case[c1 - 1] + 1)
                assert len(k) <= max_cases
                a, c = np.maximum(k - 1, 0), np.minimum(k, tiles - 1)
                top, bot = luts[f, t1].astype(np.uint32), luts[f, t2].astype(np.uint32)
                tab = top[a] | top[c] << 8 | bot[a] << 16 | bot[c] << 24  # [cases, 256]
                e = tab[col_case[c0:c1][None, :] - k[0], x[f, r0:r1, c0:c1]]
                fx = xa[c0:c1][None, :]
                fy = ya[r0:r1, None]
                gx, gy = f32(1) - fx, f32(1) - fy
                tp = byte_float(e, 0) * gx + byte_float(e, 1) * fx
                bt = byte_float(e, 2) * gx + byte_float(e, 3) * fx
                o = tp * gy + bt * fy
                q = (o + f32(12582912.0)).view(np.int32) - 0x4B400000
                out[f, r0:r1, c0:c1] = np.clip(q, 0, 255)
    return out


@pytest.mark.parametrize("shape,tiles", [((1, 808, 1352), 8), ((2, 804, 200), 4),
                                         ((2, 60, 1100), 6), ((1, 33, 47), 1)])
def test_k2_kernel_arithmetic_matches_plain(shape, tiles):
    """The kernel's launch plan and arithmetic, emulated, equal the plain
    version bit for bit on random frames and LUTs (odd tile heights, ragged
    segments, one tile)."""
    rng = np.random.default_rng(sum(shape) + tiles)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    luts = rng.integers(0, 256, (shape[0], tiles, tiles, 256), dtype=np.uint8)
    want = tcuda.clahe_apply_plain(torch.from_numpy(x), torch.from_numpy(luts), tiles).numpy()
    np.testing.assert_array_equal(_k2_emulated(x, luts, tiles), want)


def test_k2_rounding_by_add_is_rint():
    """``rint`` by the add of 1.5 * 2^23 equals np.rint on the blend's range,
    ties included, and 2^23 + b - 2^23 is b for every byte."""
    f32 = np.float32
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-2, 258, 200000).astype(f32),
                        np.arange(-4, 520, dtype=f32) / f32(2),  # every half
                        np.nextafter(np.arange(0, 256, dtype=f32) + f32(0.5), f32(0))])
    q = (o + f32(12582912.0)).view(np.int32) - 0x4B400000
    np.testing.assert_array_equal(q, np.rint(o).astype(np.int32))
    b = np.arange(256, dtype=np.uint32)
    np.testing.assert_array_equal((b | np.uint32(0x4B000000)).view(f32) - f32(8388608.0),
                                  b.astype(f32))


def test_k2_tables_built_once_per_shape():
    """The kernel's plan tables are made and moved to the device once per
    (h, w, tiles, device): later calls reuse them, so no host-to-device copy
    of coordinates sits in a batch."""
    tcuda._apply_tables.cache_clear()
    first = tcuda._apply_tables(80, 96, 8, torch.device("cpu"))
    again = tcuda._apply_tables(80, 96, 8, torch.device("cpu"))
    assert all(a is b for a, b in zip(first[:4], again[:4])) and first[4] == again[4]
    assert tcuda._apply_tables.cache_info().misses == 1


def test_enhance_contrast_bit_exact():
    frames = make_frames(2, 256, 256, seed=5)
    want = np.asarray(jpre.enhance_contrast(jnp.asarray(frames)))
    got = tpre.enhance_contrast(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, want)
