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
    g[1, :32] = 77  # flat tiles: the excess is nearly the tile's area
    hist = np.asarray(jclahe._tile_histograms(jnp.asarray(g), 8))
    for clip in (1, 3, 40, 64):  # 64: the tile's area, no excess
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


def _k1_emulated(x: np.ndarray, tiles: int, pieces: int, base_mod16: int = 0) -> np.ndarray:
    """csrc/clahe.cu's tile_hist_kernel in numpy: a block a (frame, tile row,
    piece of its rows) reads its rows as one run of bytes (head bytes up to
    the first 16-byte boundary of an address that is ``base_mod16`` mod 16
    at the frame stack's start, aligned 16-byte words, tail bytes); a word's
    tile column comes from one division, and a word across a tile-column
    boundary or a row's end steps column and tile pixel by pixel; each
    thread adds into its warp's set of the block's ``HIST_COPIES`` sets
    (groups of equal bytes with one add); the sets are summed, and several
    pieces add into a zeroed output."""
    b, h, w = x.shape
    th, tw = h // tiles, w // tiles
    word, threads, copies = tcuda.HIST_WORD, tcuda.HIST_THREADS, tcuda.HIST_COPIES
    out = np.zeros((b, tiles, tiles, 256), np.int64)
    flat = x.reshape(-1)
    for f in range(b):
        for ty in range(tiles):
            for piece in range(pieces):
                r0, r1 = ty * th + piece * th // pieces, ty * th + (piece + 1) * th // pieces
                start, n = (f * h + r0) * w, (r1 - r0) * w
                p = flat[start:start + n]
                hist = np.zeros((copies, tiles, 256), np.int64)
                head = min(n, -(base_mod16 + start) % 16)
                words = (n - head) // word
                tail = head + word * words
                for i in range(head + n - tail):  # one byte a thread
                    idx = i if i < head else tail + (i - head)
                    hist[(i % threads // 32) % copies, idx % w // tw, p[idx]] += 1
                for i in range(words):
                    mine = hist[(i % threads // 32) % copies]
                    q = p[head + word * i: head + word * (i + 1)]
                    c0 = (head + word * i) % w
                    t = c0 // tw
                    nb = (t + 1) * tw
                    if c0 + word <= nb:  # one tile column: groups of equal bytes
                        if (q == q[0]).all():
                            mine[t, q[0]] += word
                            continue
                        for g in range(0, word, 4):
                            if (q[g:g + 4] == q[g]).all():
                                mine[t, q[g]] += 4
                            else:
                                np.add.at(mine[t], q[g:g + 4], 1)
                        continue
                    for k in range(word):
                        c = c0 + k
                        while c >= nb:
                            if nb >= w:  # the row's end
                                c0, c, t, nb = c0 - w, c - w, 0, tw
                            else:
                                t, nb = t + 1, nb + tw
                        mine[t, q[k]] += 1
                out[f, ty] += hist.sum(0)
    return out.astype(np.int32)


@pytest.mark.parametrize("shape,tiles,pieces,base", [
    ((2, 16, 1360), 8, 1, 0),   # tile width 170: a word across one boundary
    ((2, 24, 160), 8, 3, 0),    # tile width 20
    ((2, 16, 96), 8, 2, 0),     # tile width 12: a word across two boundaries
    ((1, 12, 1352), 4, 1, 0),   # rows not 16-byte aligned: words across rows' ends
    ((2, 20, 100), 4, 5, 0),    # width 100, a row a piece
    ((3, 9, 51), 3, 2, 5),      # odd width, a base address off 16 bytes
    ((1, 4, 8), 1, 1, 3),       # shorter than a word: head and tail bytes only
    ((2, 8, 12), 4, 2, 0),      # tile width 3
])
@pytest.mark.parametrize("kind", ["random", "flat", "two_valued"])
def test_k1_kernel_cut_matches_plain(shape, tiles, pieces, base, kind):
    """K1's row-wise cut, emulated (16-pixel words across tile-column
    boundaries and rows' ends, head and tail bytes, private sets, pieces),
    equals the plain version exactly, on random frames and on the contention
    cases (one and two values)."""
    rng = np.random.default_rng(sum(shape) + tiles)
    x = {"random": rng.integers(0, 256, shape, dtype=np.uint8),
         "flat": np.full(shape, 97, np.uint8),
         "two_valued": rng.choice(np.array([31, 200], np.uint8), shape)}[kind]
    want = tcuda.tile_histograms_plain(torch.from_numpy(x), tiles).numpy()
    np.testing.assert_array_equal(_k1_emulated(x, tiles, pieces, base), want)


def test_k1_kernel_cut_matches_pallas_interpret():
    """The same emulation against the reference kernel in interpret mode,
    exactly."""
    g = _gray("smooth", (2, 64, 192), seed=6)
    want = np.asarray(jpallas.tile_histograms_pallas(jnp.asarray(g), 8, interpret=True))
    np.testing.assert_array_equal(_k1_emulated(g, 8, 2), want)


@pytest.mark.parametrize("b,tiles,th,want", [(32, 8, 100, 1), (16, 8, 100, 2), (4, 4, 200, 16),
                                             (3, 1, 100, 86), (1, 8, 2, 2), (1000, 8, 100, 1)])
def test_k1_pieces(b, tiles, th, want):
    """A tile row is one block's once the frames give ``HIST_MIN_BLOCKS``
    blocks, else cut into row pieces, never more than its rows."""
    assert tcuda.hist_pieces(b, tiles, th) == want
    assert 1 <= want <= th and (want == 1 or b * tiles * (want - 1) < tcuda.HIST_MIN_BLOCKS)


def _lut_tail_emulated(hist: np.ndarray, clip: int, tile_area: int) -> np.ndarray:
    """csrc/clahe.cu's tile_lut in numpy integers: a warp a tile, 8 bins a
    lane; the excess summed over the warp, ``excess >> 8`` to every bin and
    the residual one a bin at stride ``max(256 // residual, 1)``; the lane's
    running sums plus the lanes before it; one f32 product rounded half to
    even and clamped to a byte."""
    hv = hist.reshape(-1, 32, 8).astype(np.int32)
    excess = np.maximum(hv - clip, 0).sum((1, 2), dtype=np.int32)[:, None, None]
    batch, residual = excess >> 8, excess & 255
    step = np.maximum(256 // np.maximum(residual, 1), 1)
    bins = np.arange(256, dtype=np.int32).reshape(1, 32, 8)
    bonus = (residual > 0) & (bins % step == 0) & (bins // step < residual)
    val = np.minimum(hv, clip) + batch + bonus.astype(np.int32)
    run = np.cumsum(val, axis=2, dtype=np.int32)              # within a lane
    upto = np.cumsum(run[:, :, -1], axis=1, dtype=np.int32)   # the warp's scan
    cdf = run + (upto - run[:, :, -1])[:, :, None]
    scale = np.float32(255.0 / tile_area)
    q = np.rint(cdf.astype(np.float32) * scale).astype(np.int64)
    return np.clip(q, 0, 255).astype(np.uint8).reshape(hist.shape)


@pytest.mark.parametrize("kind", ["smooth", "random", "flat", "two_valued"])
def test_lut_tail_matches_both_packages(kind):
    """The LUT tail's integer clip, scan and rounding, emulated, equal
    ``_tile_luts(_clip_and_redistribute(hist))`` of the port and of the
    reference exactly: at the CLAHE clip, with no excess (clip at the tile's
    area), at clip 1, and on flat tiles (excess near the tile's area)."""
    shape, tiles = (2, 64, 128), 8
    area = (shape[1] // tiles) * (shape[2] // tiles)
    rng = np.random.default_rng(8)
    g = {"smooth": _gray("smooth", shape, seed=7), "random": _gray("random", shape, seed=7),
         "flat": np.full(shape, 140, np.uint8),
         "two_valued": rng.choice(np.array([31, 200], np.uint8), shape)}[kind]
    hist = tcuda.tile_histograms_plain(torch.from_numpy(g), tiles)
    for clip in (max(int(2.0 * area / 256.0), 1), 3, area, 1):
        port = tclahe._tile_luts(tclahe._clip_and_redistribute(hist, clip), area).numpy()
        ref = np.asarray(jclahe._tile_luts(
            jclahe._clip_and_redistribute(jnp.asarray(hist.numpy()), clip), area))
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(_lut_tail_emulated(hist.numpy(), clip, area), port)
        got = tcuda.tile_luts(torch.from_numpy(g), clip, area, tiles)
        assert got.dtype == torch.uint8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), port)


def test_lut_rounding_is_half_even_f32():
    """A tile whose scale is exactly 0.5 (area 510) and whose cdf runs
    through every odd count: each product is a tie, which the LUT entry, the
    port's and the reference's ``_tile_luts`` and the kernel's emulated
    ``__float2int_rn(__fmul_rn(...))`` all round to even, exactly; rounding
    half up would differ at every other bin."""
    area = 15 * 34
    values = np.concatenate([np.arange(255), np.full(area - 255, 255)]).astype(np.uint8)
    g = values.reshape(1, 15, 34)
    hist = tcuda.tile_histograms_plain(torch.from_numpy(g), 1)
    cdf = np.cumsum(hist.numpy().reshape(-1))
    assert (cdf[:255] == np.arange(1, 256)).all() and cdf[255] == area
    want = np.minimum(np.rint(cdf * 0.5), 255).astype(np.uint8).reshape(hist.shape)
    half_up = np.minimum(np.floor(cdf * 0.5 + 0.5), 255).astype(np.uint8).reshape(hist.shape)
    assert (want != half_up).sum() == 64
    np.testing.assert_array_equal(tclahe._tile_luts(hist, area).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jclahe._tile_luts(jnp.asarray(hist.numpy()), area)), want)
    np.testing.assert_array_equal(_lut_tail_emulated(hist.numpy(), area, area), want)
    np.testing.assert_array_equal(tcuda.tile_luts(torch.from_numpy(g), area, area, 1).numpy(), want)


@pytest.mark.parametrize("entry", ["tile_histograms", "tile_luts", "clahe_apply"])
def test_kernels_refuse_more_than_8_tiles(entry, monkeypatch):
    """The kernels keep at most 8 tile rows' worth in shared memory; CPU
    tensors take the plain versions at any tile count, so the refusal is
    shown for tensors bound for the kernel, before the library is reached."""
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    x = torch.zeros((1, 32, 32), dtype=torch.uint8)
    assert tcuda.tile_histograms(x, 16).shape == (1, 16, 16, 256)
    monkeypatch.setattr(rt, "uses_plain", lambda *tensors: False)
    monkeypatch.setattr(rt, "library", lambda: pytest.fail("the library was reached"))
    calls = {"tile_histograms": lambda: tcuda.tile_histograms(x, 16),
             "tile_luts": lambda: tcuda.tile_luts(x, 1, 4, 16),
             "clahe_apply": lambda: tcuda.clahe_apply(
                 x, torch.zeros((1, 16, 16, 256), dtype=torch.uint8), 16)}
    with pytest.raises(ValueError, match="at most 8x8 tiles"):
        calls[entry]()
