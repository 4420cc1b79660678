"""PyTorch port vs the JAX reference: min-key propagation and kernels K5, K6.

All comparisons are bit-exact.  K5's plain version is held against the
reference kernel body (``pallas_prop._kernel``) run through the Pallas
interpreter, K6's against ``propagate_scan_pallas(interpret=True)``.
``propagate_min_keys`` is compared without ``TSD_PALLAS_INTERPRET``: with it
the reference's jump-free rank-3 branch calls ``propagate_rolls_pallas``,
which has no interpret switch and refuses the CPU backend; without it the
reference takes its XLA roll passes, which compute the same keys.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import opencv_traffic_sign_detector_tpu.ops.ccl as jccl
import opencv_traffic_sign_detector_tpu.ops.pallas_prop as jprop
import opencv_traffic_sign_detector_tpu_torch.ops.ccl as tccl
import opencv_traffic_sign_detector_tpu_torch.ops.prop_cuda as tprop
from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_interpret(monkeypatch):
    monkeypatch.delenv("TSD_PALLAS_INTERPRET", raising=False)


def _random_mask(rng, shape, density, border):
    mask = rng.random(shape) < density
    if not border:
        mask[..., 0, :] = mask[..., -1, :] = mask[..., :, 0] = mask[..., :, -1] = False
    return mask


def _index_keys(rng, shape):
    """``intensity * H*W + flat index``, the sweep's composite keys."""
    h, w = shape[-2:]
    return (rng.integers(0, 256, shape) * (h * w)
            + np.arange(h * w).reshape(h, w)).astype(np.int32)


@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("density,passes", [(0.3, 7), (0.6, 24), (0.9, 0)])
def test_k5_plain_matches_kernel_interpret(density, passes, border):
    rng = np.random.default_rng(int(density * 10) + passes)
    shape = (3, 24, 40)
    keys = rng.integers(-5, 2**20, shape).astype(np.int32)
    mask = _random_mask(rng, shape, density, border)
    big = 2**21
    kern = functools.partial(jprop._kernel, num_rolls=passes, big=big)
    want = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(keys), jnp.asarray(mask).astype(jnp.int8))
    got = tprop.propagate_rolls(torch.from_numpy(keys), torch.from_numpy(mask), big, passes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(30, 44), (3, 30, 44), (2, 2, 30, 44)],
                         ids=["rank2", "rank3", "rank4"])
@pytest.mark.parametrize("edges_safe", [True, False])
@pytest.mark.parametrize("num_jumps", [0, 1])
def test_propagate_min_keys_matches(shape, edges_safe, num_jumps):
    rng = np.random.default_rng(len(shape) * 10 + num_jumps)
    mask = _random_mask(rng, shape, 0.7, border=True)
    keys = _index_keys(rng, shape)
    big = 256 * shape[-1] * shape[-2]
    keys = np.where(mask, keys, big).astype(np.int32)
    want = np.asarray(jccl.propagate_min_keys(jnp.asarray(keys), jnp.asarray(mask), big,
                                              num_rolls=3, num_jumps=num_jumps,
                                              edges_safe=edges_safe))
    rt.reset_launch_counts()
    got = tccl.propagate_min_keys(torch.from_numpy(keys), torch.from_numpy(mask), big,
                                  num_rolls=3, num_jumps=num_jumps, edges_safe=edges_safe)
    assert got.shape == keys.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != keys).any()  # some keys moved
    assert rt.launch_counts() == dict.fromkeys(rt.KERNELS, 0)  # CPU: plain only


def _flood_inputs(rng, n, h, w):
    mask = _random_mask(rng, (n, h, w), 0.62, border=False)
    big = h * w + 1
    seeds = np.full((n, h, w), big, np.int32)
    sy, sx = rng.integers(1, h - 1, n), rng.integers(1, w - 1, n)
    seeds[np.arange(n), sy, sx] = 0
    mask[np.arange(n - 1), sy[:-1], sx[:-1]] = True  # all seeds but the last on the mask
    return seeds, mask, big


@pytest.mark.parametrize("passes", [0, 1, 3])
def test_k6_plain_matches_scan_interpret(passes):
    rng = np.random.default_rng(40 + passes)
    seeds, mask, big = _flood_inputs(rng, 6, 40, 56)
    keys = np.where(rng.random(seeds.shape) < 0.1, rng.integers(0, big, seeds.shape),
                    seeds).astype(np.int32)
    for k in (seeds, keys):
        want = np.asarray(jprop.propagate_scan_pallas(jnp.asarray(k), jnp.asarray(mask),
                                                      big, passes, interpret=True))
        got = tprop.propagate_scan(torch.from_numpy(k), torch.from_numpy(mask), big, passes)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("passes", [1, 2])
def test_k6_bbox_equals_k4(passes):
    """bbox and area of ``K6(seed map, mask) == 0`` equal K4's output on the
    same candidate windows (the identity chip_smoke.py checks on the card)."""
    rng = np.random.default_rng(50 + passes)
    planes = rng.integers(0, 256, (3, 90, 100)).astype(np.uint8)
    planes[:, 30:60, 20:70] //= 3  # dark blobs: components larger than a pixel
    n, win = 16, 48
    cand = np.stack([rng.integers(0, 3, n), rng.integers(0, 90 - win, n),
                     rng.integers(0, 100 - win, n), rng.integers(0, win, n),
                     rng.integers(0, win, n), rng.integers(40, 200, n)], -1).astype(np.int32)
    planes_t, cand_t = torch.from_numpy(planes), torch.from_numpy(cand)
    big = win * win + 1
    k4 = tprop.flood_bbox(planes_t, cand_t, win, win, passes, big)
    mask, seed = tprop.candidate_windows(planes_t, cand_t, win, win)
    seed_map = torch.where(seed, 0, big).to(torch.int32)
    k6 = tprop.propagate_scan(seed_map, mask, big, passes)
    np.testing.assert_array_equal(tprop.bbox_area(k6 == 0, big).numpy(), k4.numpy())
    assert (k4[:, 4] > 1).sum() >= 3 and (k4[:, 4] == 0).sum() >= 1


def test_k5_roll_flood_reaches_k6_component():
    """Enough roll passes reach the whole seed component: K5 then equals K6."""
    rng = np.random.default_rng(60)
    seeds, mask, big = _flood_inputs(rng, 5, 32, 32)
    k5 = tprop.propagate_rolls(torch.from_numpy(seeds), torch.from_numpy(mask), big, 32 * 32)
    k6 = tprop.propagate_scan(torch.from_numpy(seeds), torch.from_numpy(mask), big, 256)
    np.testing.assert_array_equal(k5.numpy(), k6.numpy())


@pytest.mark.parametrize("case", ["keys_dtype", "mask_dtype", "shape", "rank", "scan_size"])
def test_wrappers_reject_bad_input(case, monkeypatch):
    k = torch.zeros((2, 16, 16), dtype=torch.int32)
    m = torch.zeros((2, 16, 16), dtype=torch.bool)
    if case == "scan_size":
        # K6's kernel takes planes of at most 128x128; CPU tensors take the
        # plain version at any size, so the refusal is shown for tensors
        # bound for the kernel, before the library is reached
        monkeypatch.setattr(rt, "uses_plain", lambda *tensors: False)
        monkeypatch.setattr(rt, "library", lambda: pytest.fail("the library was reached"))
    calls = {
        "keys_dtype": lambda: tprop.propagate_rolls(k.long(), m, 9, 2),
        "mask_dtype": lambda: tprop.propagate_rolls(k, m.to(torch.uint8), 9, 2),
        "shape": lambda: tprop.propagate_rolls(k, m[:, :8].contiguous(), 9, 2),
        "rank": lambda: tprop.propagate_scan(k[0], m[0], 9, 2),
        "scan_size": lambda: tprop.propagate_scan(
            torch.zeros((1, 130, 8), dtype=torch.int32),
            torch.zeros((1, 130, 8), dtype=torch.bool), 9, 2),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()


def _k5_tile_span(src, mask, big, h, w, ty, tx, core, span, npass, early):
    """One block of csrc/prop_rolls.cu's rolls_tile_kernel in numpy: the
    region loaded through the plane's wraparound (whole lanes of 4 columns,
    rows in use only), ``npass`` Jacobi passes with the kernel's own
    neighbour rule on the region's border (lane 0's left is its last
    column, the last lane's right its first; the first and last rows read
    themselves), the early stop, and the core's pixels that lie in the
    plane as ``(rows, cols, values)``."""
    core_h, core_w = core
    rh_all, rw_all = tprop.ROLLS_REGION_H, tprop.ROLLS_REGION_W
    row0, col0 = ty * core_h - span, tx * core_w - span
    rh, rw = core_h + 2 * span, core_w + 2 * span
    assert rh <= rh_all and rw <= rw_all and core_w % 4 == 0
    i, j = np.arange(rh_all), np.arange(rw_all)
    used = (i < rh)[:, None] & (j // 4 * 4 < rw)[None, :]
    gr, gc = (row0 + i) % h, (col0 + j) % w
    m = mask[gr[:, None], gc[None, :]] & used
    v = np.where(m, src[gr[:, None], gc[None, :]], big).astype(np.int32)
    inner = ((i > 0) & (i < rh - 1))[:, None] & ((j > 0) & (j < rw - 1))[None, :] & used
    for p in range(npass):
        up = np.concatenate([v[:1], v[:-1]])
        dn = np.concatenate([v[1:], v[-1:]])
        lf = np.concatenate([v[:, 3:4], v[:, :-1]], 1)
        rt_ = np.concatenate([v[:, 1:], v[:, -4:-3]], 1)
        new = np.where(m, np.minimum(np.minimum(np.minimum(v, up), np.minimum(dn, lf)), rt_), v)
        changed = ((new != v) & inner).any()
        v = new
        if p == 0 and early and not changed:
            break  # at rest: no core pixel changes in this span
    ci = i[(i >= span) & (i < span + core_h) & (row0 + i < h)]
    cj = j[(j >= span) & (j < span + core_w) & (col0 + j < w)]
    return row0 + ci, col0 + cj, v[np.ix_(ci, cj)]


def _k5_tiled_model(keys, mask, big, passes, early=True):
    """The tiled form's launches over a [P, H, W] stack: spans of
    ``rolls_spans``, cores of ``rolls_tiles``, ping-pong between ``out`` and
    ``scratch`` so that the last launch lands in ``out``; only cores are
    written (the buffers start as garbage)."""
    p, h, w = keys.shape
    if passes == 0:
        return np.where(mask, keys, big).astype(np.int32)
    spans = tprop.rolls_spans(passes)
    core = tprop.rolls_tiles(h, w, spans[0])
    tiles_y, tiles_x = -(-h // core[0]), -(-w // core[1])
    bufs = [np.full(keys.shape, -77, np.int32), np.full(keys.shape, -99, np.int32)]
    src = keys
    for n, npass in enumerate(spans):
        dst = bufs[(len(spans) - 1 - n) % 2]
        for q in range(p):
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    rows, cols, vals = _k5_tile_span(src[q], mask[q], big, h, w, ty, tx, core,
                                                     spans[0], npass, early)
                    dst[q][np.ix_(rows, cols)] = vals
        src = dst
    return bufs[0]


_S = tprop.ROLLS_SPAN
K5_MODEL_CASES = [  # planes narrower / shorter than a region, ragged, several tiles
    ((2, 90, 50), 0), ((2, 90, 50), 1), ((2, 90, 50), _S - 1), ((2, 90, 50), 2 * _S + 3),
    ((2, 20, 300), _S), ((2, 20, 300), _S + 1), ((1, 131, 307), _S), ((1, 131, 307), 2 * _S + 3),
    ((3, 7, 3), _S + 1), ((1, 100, 236), 1), ((1, 100, 236), _S - 1), ((1, 49, 113), 3 * _S),
]


@pytest.mark.parametrize("early", [True, False], ids=["early_stop", "all_passes"])
@pytest.mark.parametrize("shape,passes", K5_MODEL_CASES)
def test_k5_tiled_model_matches_plain(shape, passes, early):
    """K5's tiled design written out in numpy (regions through the
    wraparound, a span of passes on the region, only the core kept, the span
    sequence and buffer parity, the early stop) equals the plain version
    exactly, on random keys with masks of density 0.1 and 0.9 that touch all
    four edges (the wraparound then carries keys across)."""
    rng = np.random.default_rng(sum(shape) + passes)
    for density in (0.1, 0.9):
        keys = rng.integers(-5, 2**20, shape).astype(np.int32)
        mask = _random_mask(rng, shape, density, border=True)
        mask[:, 0, ::2] = mask[:, -1, ::2] = mask[:, ::2, 0] = mask[:, ::2, -1] = True
        big = 2**21
        want = tprop.propagate_rolls_plain(torch.from_numpy(keys), torch.from_numpy(mask), big,
                                           passes).numpy()
        got = _k5_tiled_model(keys, mask, big, passes, early)
        np.testing.assert_array_equal(got, want)
        if passes:
            assert (want != np.where(mask, keys, big)).any()  # some keys moved


@pytest.mark.parametrize("shape,passes", [((2, 24, 40), _S + 3), ((1, 70, 150), 2 * _S)])
def test_k5_tiled_model_matches_kernel_interpret(shape, passes):
    """The same model against the reference kernel body run through the
    Pallas interpreter, exactly, on converged and unconverged planes: a
    sparse mask is at rest after a few passes (blocks stop early), a dense
    one is not."""
    rng = np.random.default_rng(passes)
    big = 2**21
    for density in (0.15, 0.95):
        keys = rng.integers(-5, 2**20, shape).astype(np.int32)
        mask = _random_mask(rng, shape, density, border=True)
        kern = functools.partial(jprop._kernel, num_rolls=passes, big=big)
        want = pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(jnp.asarray(keys), jnp.asarray(mask).astype(jnp.int8))
        np.testing.assert_array_equal(_k5_tiled_model(keys, mask, big, passes), np.asarray(want))


def test_k5_early_stop_fires_and_is_exact():
    """On keys already at their fixed point a span's first pass changes no
    block's core and the span returns the input; with one key lowered the
    span still equals the plain version."""
    rng = np.random.default_rng(7)
    shape, big = (1, 100, 236), 2**21
    mask = _random_mask(rng, shape, 0.8, border=True)
    keys = rng.integers(0, 2**20, shape).astype(np.int32)
    rest = tprop.propagate_rolls_plain(torch.from_numpy(keys), torch.from_numpy(mask), big,
                                       100 * 236).numpy()
    np.testing.assert_array_equal(_k5_tiled_model(rest, mask, big, _S), rest)
    core = tprop.rolls_tiles(100, 236, _S)
    stopped = 0
    for ty in range(-(-100 // core[0])):
        for tx in range(-(-236 // core[1])):
            rows, cols, vals = _k5_tile_span(rest[0], mask[0], big, 100, 236, ty, tx, core, _S, 1,
                                             False)
            stopped += np.array_equal(vals, rest[0][np.ix_(rows, cols)])
    assert stopped == -(-100 // core[0]) * -(-236 // core[1])
    poked = rest.copy()
    y, x = np.argwhere(mask[0])[len(np.argwhere(mask[0])) // 2]
    poked[0, y, x] = -3
    want = tprop.propagate_rolls_plain(torch.from_numpy(poked), torch.from_numpy(mask), big,
                                       _S).numpy()
    np.testing.assert_array_equal(_k5_tiled_model(poked, mask, big, _S), want)
    assert (want != poked).any()


@pytest.mark.parametrize("h,w,span", [(402, 682, 8), (802, 1362, 8), (30, 700, 1), (7, 3, 5),
                                      (64, 128, 8), (1000, 1000, 3)])
def test_k5_tile_geometry(h, w, span):
    """The cores cover the plane, fit the region with their halos, and are a
    multiple of a lane's 4 columns wide; the spans add up to the passes."""
    core_h, core_w = tprop.rolls_tiles(h, w, span)
    assert core_w % 4 == 0 and core_h >= 1 and core_w >= 4
    assert core_h + 2 * span <= tprop.ROLLS_REGION_H and core_w + 2 * span <= tprop.ROLLS_REGION_W
    assert -(-h // core_h) * core_h >= h and -(-w // core_w) * core_w >= w
    for passes in (0, 1, span, 5 * _S + 2):
        spans = tprop.rolls_spans(passes)
        assert sum(spans) == passes and len(spans) == -(-passes // _S)
        assert all(0 < s <= _S for s in spans)


# --- K5's window form and K6's scans, as csrc/window_regs.cuh lays them out ---
# A [128, 128] plane is [warp 16][row 8][lane 32][column 4]: pixel (i, j) is
# row i % 8 of warp i // 8, column j % 4 of lane j // 4.
_WARPS, _ROWS, _LANES, _COLS = 16, 8, 32, 4
_NO_KEY = np.int32(2**31 - 1)


def _to_regs(plane, fill):
    """[h, w] (h, w <= 128) -> [16, 8, 32, 4], padded with ``fill`` as the
    kernels' loader pads a smaller plane with pixels off the mask."""
    h, w = plane.shape
    full = np.full((_WARPS * _ROWS, _LANES * _COLS), fill, plane.dtype)
    full[:h, :w] = plane
    return full.reshape(_WARPS, _ROWS, _LANES, _COLS).copy()


def _from_regs(regs, h, w):
    return regs.reshape(_WARPS * _ROWS, _LANES * _COLS)[:h, :w]


def _k5_window_model(keys, mask, big, passes):
    """One block of rolls_window_kernel (S = 128) or rolls_window64_kernel
    (S = 64) in numpy on an [S, S] plane: registers [warp S / 8, row 8, lane
    32, column C = S / 32], pixel (i, j) being row i % 8 of warp i // 8 and
    column j % C of lane j // C.  Each
    pass reads up and down from the lane's own rows or the exchange rows of
    the warps (wp - 1) and (wp + 1) modulo the warps, left and right from its
    own columns or lanes (lane + 31) % 32 and (lane + 1) % 32; the mask is a
    floor under the neighbours' minimum (the least int32 on the mask, ``big``
    off it); the barrier of pass p leaves the loop when pass p - 1 changed
    no pixel.  -> (keys, passes run)."""
    side = keys.shape[0]
    cols, warps = side // 32, side // _ROWS

    def to_regs(x):
        return x.reshape(warps, _ROWS, 32, cols).copy()

    m = to_regs(mask)
    v = np.where(m, to_regs(keys), big).astype(np.int32)
    floor = np.where(m, np.iinfo(np.int32).min, big).astype(np.int32)
    wp, lane = np.arange(warps), np.arange(32)
    changed, ran = True, 0
    for _ in range(passes):
        first, last = v[:, 0].copy(), v[:, _ROWS - 1].copy()  # the exchange rows
        if not changed:
            break
        prev, below = last[(wp + warps - 1) % warps], first[(wp + 1) % warps]
        up = np.concatenate([prev[:, None], v[:, :-1]], 1)
        dn = np.concatenate([v[:, 1:], below[:, None]], 1)
        lf_in = v[:, :, (lane + 31) & 31, cols - 1]  # the shuffle of the last column
        rt_in = v[:, :, (lane + 1) & 31, 0]          # the shuffle of the first
        lf = np.concatenate([lf_in[..., None], v[..., :-1]], -1)
        rt_ = np.concatenate([v[..., 1:], rt_in[..., None]], -1)
        new = np.maximum(np.minimum(np.minimum(np.minimum(v, up), np.minimum(dn, lf)), rt_), floor)
        changed = bool((new ^ v).any())
        v = new
        ran += 1
    return v.reshape(side, side), ran


def _edge_mask(rng, shape, density):
    mask = _random_mask(rng, shape, density, border=True)
    mask[..., 0, ::2] = mask[..., -1, ::2] = mask[..., ::2, 0] = mask[..., ::2, -1] = True
    return mask


@pytest.mark.parametrize("density", [0.1, 0.9])
@pytest.mark.parametrize("passes", [0, 1, 2, 95, 96])
def test_k5_window_model_matches_plain(passes, density):
    """K5's window form written out in numpy (lane and warp indexing, the
    wrap through lane 31 and warp 15, the stop on a pass without change)
    equals the plain version exactly, on random keys with masks that touch
    all four edges, so that the wraparound carries keys across."""
    rng = np.random.default_rng(passes * 10 + int(density * 10))
    shape, big = (2, 128, 128), 2**21
    keys = rng.integers(-5, 2**20, shape).astype(np.int32)
    mask = _edge_mask(rng, shape, density)
    want = tprop.propagate_rolls_plain(torch.from_numpy(keys), torch.from_numpy(mask), big,
                                       passes).numpy()
    for q in range(shape[0]):
        got, ran = _k5_window_model(keys[q], mask[q], big, passes)
        np.testing.assert_array_equal(got, want[q])
        assert ran <= passes
    if passes:
        assert (want != np.where(mask, keys, big)).any()  # some keys moved


@pytest.mark.parametrize("density,passes", [(0.15, 40), (0.95, 9)])
def test_k5_window_model_matches_kernel_interpret(density, passes):
    """The same model against the reference kernel body run through the
    Pallas interpreter, exactly: a sparse mask comes to rest before its
    passes are up (the model stops), a dense one does not."""
    rng = np.random.default_rng(passes)
    shape, big = (2, 128, 128), 2**21
    keys = rng.integers(-5, 2**20, shape).astype(np.int32)
    mask = _edge_mask(rng, shape, density)
    kern = functools.partial(jprop._kernel, num_rolls=passes, big=big)
    want = np.asarray(pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(keys), jnp.asarray(mask).astype(jnp.int8)))
    rans = []
    for q in range(shape[0]):
        got, ran = _k5_window_model(keys[q], mask[q], big, passes)
        np.testing.assert_array_equal(got, want[q])
        rans.append(ran)
    assert (max(rans) < passes) == (density < 0.5)


def _serpentine(n=128):
    """A one-pixel path through every other row of an n x n plane, joined at
    alternating ends: a flood from its head needs its length in passes."""
    mask = np.zeros((n, n), bool)
    mask[1:-1:2, 1:-1] = True
    for i, r in enumerate(range(2, n - 2, 2)):
        mask[r, n - 2 if i % 2 == 0 else 1] = True
    return mask


def test_k5_window_stop_fires_only_at_rest():
    """A seed flood along a serpentine needs more passes than the refine's
    96: the stop must not fire and the result equals the plain version.  A
    seed whose component is a small blob is at rest after its radius in
    passes: the model stops at the first pass that changes nothing, one
    more than the passes that changed a pixel, with the plain result."""
    big = 128 * 128 + 1
    snake = _serpentine()
    seed = np.full((128, 128), big, np.int32)
    seed[1, 1] = 0
    got, ran = _k5_window_model(seed, snake, big, 96)
    want = tprop.propagate_rolls_plain(torch.from_numpy(seed[None]), torch.from_numpy(snake[None]),
                                       big, 96).numpy()[0]
    np.testing.assert_array_equal(got, want)
    assert ran == 96 and (got == 0).sum() == 97

    blob = np.zeros((128, 128), bool)
    blob[60:70, 50:75] = True
    seed = np.full((128, 128), big, np.int32)
    seed[64, 60] = 0
    plain = [np.where(blob, seed, big)]
    for _ in range(96):
        plain.append(tprop.propagate_rolls_plain(
            torch.from_numpy(plain[-1][None]), torch.from_numpy(blob[None]), big, 1).numpy()[0])
    moved = sum(not np.array_equal(a, b) for a, b in zip(plain, plain[1:]))
    got, ran = _k5_window_model(seed, blob, big, 96)
    np.testing.assert_array_equal(got, plain[-1])
    assert ran == moved + 1 and moved == (69 - 64) + (74 - 60) and (got == 0).sum() == 250
    off = seed.copy()
    off[64, 60], off[3, 3] = big, 0  # a seed off its mask: at rest after one pass
    got, ran = _k5_window_model(off, blob, big, 96)
    assert ran == 1 and (got == big).all()


@pytest.mark.parametrize("density", [0.1, 0.9])
@pytest.mark.parametrize("passes", [0, 1, 2, 95, 96])
def test_k5_window64_model_matches_plain(passes, density):
    """K5's 64-px register form written out in numpy (lanes of 2 columns,
    the wrap through lane 31 and warp 7, the stop on a pass without change)
    equals the plain version exactly on 3 planes of random keys with masks
    that touch all four edges."""
    rng = np.random.default_rng(passes * 10 + int(density * 10))
    shape, big = (3, 64, 64), 2**21
    keys = rng.integers(-5, 2**20, shape).astype(np.int32)
    mask = _edge_mask(rng, shape, density)
    want = tprop.propagate_rolls_plain(torch.from_numpy(keys), torch.from_numpy(mask), big,
                                       passes).numpy()
    for q in range(shape[0]):
        got, ran = _k5_window_model(keys[q], mask[q], big, passes)
        np.testing.assert_array_equal(got, want[q])
        assert ran <= passes
    if passes:
        assert (want != np.where(mask, keys, big)).any()  # some keys moved


@pytest.mark.parametrize("density,passes", [(0.15, 40), (0.95, 9)])
def test_k5_window64_model_matches_kernel_interpret(density, passes):
    """The 64-px model against the reference kernel body run through the
    Pallas interpreter at (2, 64, 64), exactly: a sparse mask comes to rest
    before its passes are up (the model stops), a dense one does not."""
    rng = np.random.default_rng(passes + 64)
    shape, big = (2, 64, 64), 2**21
    keys = rng.integers(-5, 2**20, shape).astype(np.int32)
    mask = _edge_mask(rng, shape, density)
    kern = functools.partial(jprop._kernel, num_rolls=passes, big=big)
    want = np.asarray(pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(keys), jnp.asarray(mask).astype(jnp.int8)))
    rans = []
    for q in range(shape[0]):
        got, ran = _k5_window_model(keys[q], mask[q], big, passes)
        np.testing.assert_array_equal(got, want[q])
        rans.append(ran)
    assert (max(rans) < passes) == (density < 0.5)


def test_k5_window64_stop_fires_only_at_rest():
    """At 64 px: a seed flood along a serpentine needs more than 96 passes,
    so the stop must not fire; a seed in a 6x15 blob is at rest after
    (35 - 32) + (34 - 25) = 12 changing passes and the model stops at the
    13th, with the plain result."""
    big = 64 * 64 + 1
    snake = _serpentine(64)
    seed = np.full((64, 64), big, np.int32)
    seed[1, 1] = 0
    got, ran = _k5_window_model(seed, snake, big, 96)
    want = tprop.propagate_rolls_plain(torch.from_numpy(seed[None]), torch.from_numpy(snake[None]),
                                       big, 96).numpy()[0]
    np.testing.assert_array_equal(got, want)
    assert ran == 96 and (got == 0).sum() == 97

    blob = np.zeros((64, 64), bool)
    blob[30:36, 20:35] = True
    seed = np.full((64, 64), big, np.int32)
    seed[32, 25] = 0
    got, ran = _k5_window_model(seed, blob, big, 96)
    want = tprop.propagate_rolls_plain(torch.from_numpy(seed[None]), torch.from_numpy(blob[None]),
                                       big, 96).numpy()[0]
    np.testing.assert_array_equal(got, want)
    assert ran == 13 and (got == 0).sum() == 6 * 15


@pytest.mark.parametrize("h,w,form", [(128, 128, "window"), (64, 64, "window64"),
                                      (98, 98, "resident"), (100, 128, "resident"),
                                      (37, 100, "resident"), (402, 682, "tiled"),
                                      (160, 161, "resident"), (161, 161, "tiled")])
def test_k5_rolls_form(h, w, form):
    """K5's form by plane shape, as csrc/prop_rolls.cu chooses it: the two
    register forms at exactly 128x128 and 64x64, the resident form for any
    other plane whose 9 bytes a pixel fit a block's 232448 bytes of shared
    memory (25,827 pixels), the tiled form beyond."""
    assert tprop.rolls_form(h, w) == form


def test_k5_rolls_form_mirrors_the_library_source():
    """``rolls_form`` and ``ROLLS_FORMS`` against ``csrc/prop_rolls.cu:
    rolls_form``, read from the source: the codes' order, the two register
    forms' sides, and the resident form's limit (``kResidentBytes``, bytes a
    pixel) at the planes on either side of it.  On the card the wrapper
    checks the built library's choice at every call."""
    import re
    from pathlib import Path

    src = (Path(tprop.__file__).parents[1] / "csrc" / "prop_rolls.cu").read_text()
    body = src[src.index("inline int rolls_form(int h, int w)"):]
    body = body[:body.index("\n}\n")]
    sides = dict(re.findall(r"struct (\w+) \{.*?static constexpr int kSide = (\w+)", src, re.S))
    sides = {k: 32 * 4 if v == "kStripW" else int(v) for k, v in sides.items()}
    for name, code in re.findall(r"if \(h == (\w+)::kSide && w == \1::kSide\) return (\d);",
                                 body):
        assert tprop.ROLLS_FORMS[int(code)] == name.lower()
        assert tprop.rolls_form(sides[name], sides[name]) == name.lower()
    on, off = re.search(r"return resident_bytes\(h, w\) <= kResidentBytes \? (\d) : (\d);",
                        body).groups()
    assert (tprop.ROLLS_FORMS[int(on)], tprop.ROLLS_FORMS[int(off)]) == ("resident", "tiled")
    limit = int(re.search(r"constexpr long long kResidentBytes = (\d+);", src).group(1))
    per_px = int(re.search(r"return \(long long\)h \* w \* (\d+);", src).group(1))
    assert tprop.ROLLS_RESIDENT_BYTES == limit
    most = limit // per_px
    for h, w in ((160, 161), (161, 161), (1, most), (1, most + 1), (most, 1), (most + 1, 1)):
        want = "resident" if h * w * per_px <= limit else "tiled"
        assert tprop.rolls_form(h, w) == want, (h, w)
    assert tprop.rolls_form(160, 161) == "resident" and tprop.rolls_form(161, 161) == "tiled"


def _k5_resident_model(keys, mask, big, passes, threads):
    """One block of rolls_resident_kernel in numpy on an [h, w] plane: thread
    (tx, ty) of a 32 x threads / 32 block walks columns tx, tx + 32, ... and
    in each its run of rows [ty * run, (ty + 1) * run), carrying the rows
    above, at and below down the run; each pixel takes the maximum of the
    neighbours' minimum and its floor (the mask byte 0 or -1 selects INT_MIN
    or ``big`` bitwise); every pixel is written once a pass; the barrier
    that starts a pass leaves the loop when the pass before changed no
    pixel.  -> (keys, passes run)."""
    h, w = keys.shape
    ny = threads // 32
    run = -(-h // ny)
    on = np.where(mask, -1, 0).astype(np.int32)
    floor = (on & np.int32(np.iinfo(np.int32).min)) | (~on & np.int32(big))
    a = np.where(mask, keys, big).astype(np.int32)
    changed, ran = True, 0
    for _ in range(passes):
        if not changed:
            break
        b = np.zeros_like(a)
        written = np.zeros((h, w), np.int32)
        for ty in range(ny):
            r0, r1 = ty * run, min(h, ty * run + run)
            for tx in range(32):
                cols = np.arange(tx, w, 32)
                if r0 >= r1 or not cols.size:
                    continue
                lc, rc = np.where(cols == 0, w - 1, cols - 1), np.where(cols == w - 1, 0, cols + 1)
                up, cur = a[h - 1 if r0 == 0 else r0 - 1, cols], a[r0, cols]
                for r in range(r0, r1):
                    dn = a[0 if r == h - 1 else r + 1, cols]
                    mn = np.minimum(np.minimum(np.minimum(cur, up), np.minimum(dn, a[r, lc])),
                                    a[r, rc])
                    b[r, cols] = np.maximum(mn, floor[r, cols])
                    written[r, cols] += 1
                    up, cur = cur, dn
        assert (written == 1).all()
        changed = bool((b != a).any())
        a = b
        ran += 1
    return a, ran


@pytest.mark.parametrize("threads", [1024, 512, 256])
@pytest.mark.parametrize("h,w", [(98, 98), (100, 128), (37, 100), (5, 3)])
def test_k5_resident_model_matches_plain(h, w, threads):
    """The shared-memory form's walk and stop in numpy equal the plain
    version exactly at 0, 1, 8 and 96 passes, with masks of density 0.3 and
    0.9 on all four edges; a run of passes at rest stops early."""
    rng = np.random.default_rng(h * w + threads)
    big = 2**21
    for passes, density in ((0, 0.9), (1, 0.3), (8, 0.9), (96, 0.3)):
        keys = rng.integers(-5, 2**20, (1, h, w)).astype(np.int32)
        mask = _edge_mask(rng, (1, h, w), density)
        want = tprop.propagate_rolls_plain(torch.from_numpy(keys), torch.from_numpy(mask), big,
                                           passes).numpy()[0]
        got, ran = _k5_resident_model(keys[0], mask[0], big, passes, threads)
        np.testing.assert_array_equal(got, want)
        assert ran <= passes


def test_k5_resident_stop_fires_only_at_rest():
    """On a 98x98 plane a blob's seed flood stops one pass after the last
    pass that changed a key; a serpentine's runs all 96 passes."""
    big = 98 * 98 + 1
    blob = np.zeros((98, 98), bool)
    blob[40:47, 10:30] = True
    seed = np.full((98, 98), big, np.int32)
    seed[43, 15] = 0
    got, ran = _k5_resident_model(seed, blob, big, 96, 1024)
    want = tprop.propagate_rolls_plain(torch.from_numpy(seed[None]), torch.from_numpy(blob[None]),
                                       big, 96).numpy()[0]
    np.testing.assert_array_equal(got, want)
    assert ran == (46 - 43) + (29 - 15) + 1 and (got == 0).sum() == 7 * 20
    snake = _serpentine(98)
    head = np.full((98, 98), big, np.int32)
    head[1, 1] = 0
    got, ran = _k5_resident_model(head, snake, big, 96, 1024)
    want = tprop.propagate_rolls_plain(torch.from_numpy(head[None]),
                                       torch.from_numpy(snake[None]), big, 96).numpy()[0]
    np.testing.assert_array_equal(got, want)
    assert ran == 96 and (got == 0).sum() == 97


def _carry_min(on, val, carry):
    """csrc/flood.cu's scan step: ``val`` joined by the carry where they
    connect; ``val`` is the no-key sentinel off the mask."""
    return np.minimum(val, np.where(on, carry, _NO_KEY))


def _shfl(x, d):
    """``__shfl_up_sync`` (d > 0) or ``__shfl_down_sync`` (d < 0) along the
    lane axis, the last: a lane with no lane d away reads itself."""
    lane = np.arange(_LANES)
    src = lane - d
    return x[..., np.where((src >= 0) & (src < _LANES), src, lane)]


def _k6_scan_rows(v, m, fwd):
    """One direction of the row resolve on [16, 8, 32, 4] registers: inside
    the lane, a Kogge-Stone scan of (key leaving, open through) across the
    32 lanes, inside the lane again from the key entering."""
    cols = range(_COLS) if fwd else range(_COLS - 1, -1, -1)
    out = np.full(v.shape[:-1], _NO_KEY, np.int32)
    for q in cols:
        out = _carry_min(m[..., q], v[..., q], out)
    t = m.all(-1)
    d = 1
    while d < _LANES:
        pt, po = _shfl(t, d if fwd else -d), _shfl(out, d if fwd else -d)
        out = _carry_min(t, out, po)
        t = t & pt
        d *= 2
    carry = _shfl(out, 1 if fwd else -1)
    carry[..., 0 if fwd else _LANES - 1] = _NO_KEY  # runs end at the plane's edge
    for q in cols:
        v[..., q] = carry = _carry_min(m[..., q], v[..., q], carry)


def _k6_resolve_cols(v, m):
    """The column resolve: each warp's (key leaving downward, key leaving
    upward, open through its 8 rows), a scan of the warps above and below,
    then down inside the lane and up over that result."""
    none = np.full(v.shape[:1] + v.shape[2:], _NO_KEY, np.int32)  # [warp, lane, col]
    down, up = none.copy(), none.copy()
    for k in range(_ROWS):
        down = _carry_min(m[:, k], v[:, k], down)
    for k in range(_ROWS - 1, -1, -1):
        up = _carry_min(m[:, k], v[:, k], up)
    opened = m.all(1)
    in_down, in_up = none.copy(), none.copy()
    for wp in range(_WARPS):
        for j in range(wp):
            in_down[wp] = _carry_min(opened[j], down[j], in_down[wp])
        for j in range(_WARPS - 1, wp, -1):
            in_up[wp] = _carry_min(opened[j], up[j], in_up[wp])
    for k in range(_ROWS):
        v[:, k] = in_down = _carry_min(m[:, k], v[:, k], in_down)
    for k in range(_ROWS - 1, -1, -1):
        v[:, k] = in_up = _carry_min(m[:, k], v[:, k], in_up)


def _k6_scan_model(keys, mask, big, passes):
    """One block of propagate_scan_kernel in numpy on an [h, w] plane."""
    h, w = keys.shape
    m = _to_regs(mask, False)
    v = np.where(m, _to_regs(keys, 0), _NO_KEY).astype(np.int32)
    for k in range(passes + 1):
        _k6_scan_rows(v, m, True)
        _k6_scan_rows(v, m, False)
        if k < passes:
            _k6_resolve_cols(v, m)
    return _from_regs(np.where(m, v, big).astype(np.int32), h, w)


K6_MODEL_SHAPES = [(128, 128), (37, 100), (3, 128), (21, 67)]


def _k6_model_inputs(rng, shape, density):
    keys = rng.integers(-2**30, 2**30, shape).astype(np.int32)
    return keys, _random_mask(rng, shape, density, border=False), 2**30 + 5


@pytest.mark.parametrize("passes", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", K6_MODEL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k6_scan_model_matches_plain(shape, passes):
    """K6's two-level segmented min scans written out in numpy (inside a
    lane, across lanes, across warps; planes smaller than 128x128 padded off
    the mask) equal the plain version exactly, on random keys of both signs
    under masks of density 0.1, 0.5 and 0.9 with the border off."""
    rng = np.random.default_rng(shape[0] * 7 + passes)
    for density in (0.1, 0.5, 0.9):
        keys, mask, big = _k6_model_inputs(rng, shape, density)
        want = tprop.propagate_scan_plain(torch.from_numpy(keys[None]),
                                          torch.from_numpy(mask[None]), big, passes).numpy()[0]
        np.testing.assert_array_equal(_k6_scan_model(keys, mask, big, passes), want)
        assert (want != np.where(mask, keys, big)).any() or density < 0.2


@pytest.mark.parametrize("passes", [0, 2])
@pytest.mark.parametrize("shape", K6_MODEL_SHAPES[:3], ids=lambda s: f"{s[0]}x{s[1]}")
def test_k6_scan_model_matches_scan_interpret(shape, passes):
    """The same model against ``propagate_scan_pallas(interpret=True)``,
    exactly."""
    rng = np.random.default_rng(shape[1] + passes)
    keys, mask, big = _k6_model_inputs(rng, shape, 0.6)
    want = np.asarray(jprop.propagate_scan_pallas(jnp.asarray(keys[None]), jnp.asarray(mask[None]),
                                                  big, passes, interpret=True))[0]
    np.testing.assert_array_equal(_k6_scan_model(keys, mask, big, passes), want)


def test_k6_scan_model_single_runs():
    """One run spanning a whole inner row and one a whole inner column,
    crossing: with the least key at the column's foot, the row resolve alone
    leaves the row's ends short of it, one pass more reaches every pixel."""
    h = w = 128
    mask = np.zeros((h, w), bool)
    mask[40, 1:-1] = mask[1:-1, 77] = True
    rng = np.random.default_rng(3)
    keys = rng.integers(-2**20, 2**20, (h, w)).astype(np.int32)
    keys[h - 2, 77] = -2**21
    for passes in (0, 1):
        want = tprop.propagate_scan_plain(torch.from_numpy(keys[None]), torch.from_numpy(mask[None]),
                                          2**30, passes).numpy()[0]
        got = _k6_scan_model(keys, mask, 2**30, passes)
        np.testing.assert_array_equal(got, want)
        assert (got[mask] == -2**21).all() == (passes == 1)
