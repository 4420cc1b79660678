"""K4's bit-parallel flood (``csrc/flood.cu``) written out with Python ints,
held against the port's plain version (``prop_cuda.flood_bbox_plain``) and
the JAX reference's ``flood_bbox_pallas`` in interpret mode.

The CUDA kernel cannot run here, so this file mirrors its arithmetic step
by step: a 128-pixel row is one 128-bit int (bit c = column c), a lane owns
four consecutive rows, a row resolve is the carry fill on the row and on
its bit reversal, a column resolve is the segmented OR scan over each
lane's rows and across the 32 lanes (five doubling steps), and the result
is reduced from popcounts, row tests and the OR of the rows.  Inputs are
random windows made with numpy from fixed seeds.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.ops.pallas_prop as jprop
from opencv_traffic_sign_detector_tpu_torch.ops import prop_cuda

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

BITS = 128
ONES = (1 << BITS) - 1
LANES = 32


def _rev(x: int) -> int:
    """Bit reversal of a 128-bit row (the kernel's word swap and __brevll)."""
    return int(f"{x:0{BITS}b}"[::-1], 2)


def _fill_up(m: int, s: int) -> int:
    """Every pixel of m from the lowest pixel of s in its run to the run's top."""
    total = (m + s) & ONES  # the carry out of bit 127 is dropped, as in the kernel
    return s | ((total ^ m ^ s) & m)


def resolve_row(m: int, s: int) -> int:
    return _fill_up(m, s) | _rev(_fill_up(_rev(m), _rev(s)))


def _scan(out, t, order):
    """The kernel's shuffle scan: lane ``order[i]`` takes from ``order[i - d]``."""
    d = 1
    while d < LANES:
        po, pt = list(out), list(t)  # a shuffle reads the values before the step
        for i in range(d, LANES):
            lane, src = order[i], order[i - d]
            out[lane] |= po[src] & t[lane]
            t[lane] &= pt[src]
        d *= 2
    return out


def resolve_cols(m: list, r: list) -> list:
    """Column resolve of 128 rows held four a lane: down, then up."""
    m = [m[4 * ln:4 * ln + 4] for ln in range(LANES)]
    r = [list(r[4 * ln:4 * ln + 4]) for ln in range(LANES)]
    open_ = [a & b & c & d for a, b, c, d in m]
    for ln in range(LANES):
        for s in range(1, 4):
            r[ln][s] |= r[ln][s - 1] & m[ln][s]
    out = _scan([r[ln][3] for ln in range(LANES)], list(open_), list(range(LANES)))
    for ln in range(LANES):
        r[ln][0] |= (out[ln - 1] if ln else 0) & m[ln][0]
        for s in range(1, 4):
            r[ln][s] |= r[ln][s - 1] & m[ln][s]
    for ln in range(LANES):
        for s in (2, 1, 0):
            r[ln][s] |= r[ln][s + 1] & m[ln][s]
    out = _scan([r[ln][0] for ln in range(LANES)], list(open_), list(range(LANES))[::-1])
    for ln in range(LANES):
        r[ln][3] |= (out[ln + 1] if ln < LANES - 1 else 0) & m[ln][3]
        for s in (2, 1, 0):
            r[ln][s] |= r[ln][s + 1] & m[ln][s]
    return [row for lane in r for row in lane]


def flood_bbox_bits(planes: np.ndarray, cand: np.ndarray, wh: int, ww: int, passes: int,
                    big: int) -> np.ndarray:
    """The kernel's algorithm for each candidate -> [N, 5] int32."""
    p, h, w = planes.shape
    out = []
    for plane, y0, x0, sy, sx, level in cand.tolist():
        plane = min(max(plane, 0), p - 1)
        y0, x0 = min(max(y0, 0), h - wh), min(max(x0, 0), w - ww)
        win = planes[plane, y0:y0 + wh, x0:x0 + ww].astype(int)
        if not (0 < sy < wh - 1 and 0 < sx < ww - 1 and win[sy, sx] <= level):
            out.append((big, -1, big, -1, 0))
            continue
        m = [0] * BITS
        for y in range(1, wh - 1):  # the ballots of the inner ring's pixels
            m[y] = sum(1 << x for x in range(1, ww - 1) if win[y, x] <= level)
        r = [0] * BITS
        r[sy] = 1 << sx
        for _ in range(passes):
            r = [resolve_row(a, b) for a, b in zip(m, r)]
            r = resolve_cols(m, r)
        r = [resolve_row(a, b) for a, b in zip(m, r)]
        rows = [y for y in range(BITS) if r[y]]
        cols = 0
        for row in r:
            cols |= row
        if not rows:
            out.append((big, -1, big, -1, 0))
            continue
        area = sum(bin(row).count("1") for row in r)
        out.append((rows[0], rows[-1], (cols & -cols).bit_length() - 1, cols.bit_length() - 1,
                    area))
    return np.array(out, np.int32).reshape(-1, 5)


def _runs_filled(m: int, s: int) -> int:
    """Per-run reference: every run of m that holds a bit of s."""
    out, x = 0, 0
    while x < BITS:
        if not (m >> x) & 1:
            x += 1
            continue
        start = x
        while x < BITS and (m >> x) & 1:
            x += 1
        run = ((1 << (x - start)) - 1) << start
        if s & run:
            out |= run
    return out


def test_row_resolve_is_run_fill():
    """The carry fill equals the per-run rule on random 128-bit rows, with
    several seeds in a run, runs across the 64-bit word boundary and bit 127
    set."""
    rng = np.random.default_rng(0)
    for i in range(4000):
        density = rng.uniform(0.3, 0.97)
        m = sum(1 << b for b in range(BITS) if rng.random() < density)
        s = m & sum(1 << b for b in range(BITS) if rng.random() < rng.uniform(0.005, 0.2))
        assert resolve_row(m, s) == _runs_filled(m, s), (i, hex(m), hex(s))
    assert resolve_row(ONES, 1 << 127) == ONES
    assert resolve_row(ONES ^ (1 << 64), 1 << 63) == (1 << 64) - 1


def _planes(seed: int, shape=(3, 150, 160)) -> np.ndarray:
    """Smooth random planes (long mask runs at mid levels), with noise."""
    rng = np.random.default_rng(seed)
    p, h, w = shape
    coarse = rng.uniform(0, 255, (p, h // 10 + 2, w // 10 + 2))
    yy = np.arange(h) / 10
    xx = np.arange(w) / 10
    iy, ix = yy.astype(int), xx.astype(int)
    fy, fx = (yy - iy)[None, :, None], (xx - ix)[None, None, :]
    c = coarse
    smooth = ((c[:, iy][:, :, ix] * (1 - fx) + c[:, iy][:, :, ix + 1] * fx) * (1 - fy)
              + (c[:, iy + 1][:, :, ix] * (1 - fx) + c[:, iy + 1][:, :, ix + 1] * fx) * fy)
    return np.clip(smooth + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)


def _candidates(planes: np.ndarray, wh: int, ww: int, n: int, seed: int) -> np.ndarray:
    """Random candidates with clamped origins and levels a little above their
    seed's pixel; the first few are empty on purpose."""
    rng = np.random.default_rng(seed)
    p, h, w = planes.shape
    plane = rng.integers(0, p, n)
    y0 = rng.integers(-10, h - wh + 11, n)
    x0 = rng.integers(-10, w - ww + 11, n)
    sy = rng.integers(1, max(wh - 1, 2), n)
    sx = rng.integers(1, max(ww - 1, 2), n)
    cy0, cx0 = np.clip(y0, 0, h - wh), np.clip(x0, 0, w - ww)
    pix = planes[plane, cy0 + np.minimum(sy, wh - 1), cx0 + np.minimum(sx, ww - 1)].astype(int)
    level = pix + rng.integers(0, 50, n)
    sy[0], sx[1] = 0, ww - 1  # seeds on the unmasked ring
    level[2] = pix[2] - 1  # a seed above its level
    sy[3] = wh + 5  # a seed outside the window
    level[4] = 255  # the whole inner window
    return np.stack([plane, y0, x0, sy, sx, level], -1).astype(np.int32)


def _reference(planes, cand, wh, ww, passes, big):
    """flood_bbox_pallas on the materialised windows (interpret mode)."""
    p, h, w = planes.shape
    n = cand.shape[0]
    seed_map = np.full((n, wh, ww), big, np.int32)
    mask = np.zeros((n, wh, ww), bool)
    for i, (plane, y0, x0, sy, sx, level) in enumerate(cand.tolist()):
        y0, x0 = min(max(y0, 0), h - wh), min(max(x0, 0), w - ww)
        win = planes[min(max(plane, 0), p - 1), y0:y0 + wh, x0:x0 + ww].astype(int)
        mask[i, 1:-1, 1:-1] = win[1:-1, 1:-1] <= level
        if 0 <= sy < wh and 0 <= sx < ww:
            seed_map[i, sy, sx] = 0
    return np.asarray(jprop.flood_bbox_pallas(jnp.asarray(seed_map), jnp.asarray(mask), big,
                                              passes, interpret=True))[:, :5]


@pytest.mark.parametrize("wh,ww", [(128, 5), (37, 33), (100, 100), (128, 128)])
def test_k4_bit_algorithm_matches_plain_and_reference(wh, ww):
    planes = _planes(ww)
    cand = _candidates(planes, wh, ww, 16, seed=wh + ww)
    big = wh * ww + 1
    for passes in range(4):
        bits = flood_bbox_bits(planes, cand, wh, ww, passes, big)
        plain = prop_cuda.flood_bbox_plain(torch.from_numpy(planes), torch.from_numpy(cand),
                                           wh, ww, passes, big).numpy()
        np.testing.assert_array_equal(bits, plain)
        np.testing.assert_array_equal(bits, _reference(planes, cand, wh, ww, passes, big))
        assert (bits[:4, 4] == 0).all()
        if passes and wh > 2 and ww > 2:
            assert bits[4, 4] == (wh - 2) * (ww - 2)  # the whole inner window
    # long components, and runs that cross 32-pixel word boundaries
    assert (bits[:, 4] > 3 * ww).sum() >= 2
    if ww > 64:
        for edge in (32, 64, 96)[:(ww - 2) // 32]:
            assert ((bits[:, 2] < edge) & (bits[:, 3] >= edge)).sum() >= 2, edge
