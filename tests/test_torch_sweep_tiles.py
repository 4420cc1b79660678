"""The tiled level sweep's decomposition (K3 and K7), modelled on the CPU.

``csrc/mser_sweep.cu: sweep_tile_kernel`` cannot run here, so this file
writes out in torch what its launches do and holds that against the plain
versions, exactly:

* ``run_tiles``: ``ceil(levels * passes / SWEEP_SPAN)`` launches, the state
  ping-ponging between two buffers that start as garbage;
* one block a tile (:func:`tmc.sweep_tiles`): its region, the core plus a
  halo of ``SWEEP_SPAN`` pixels on every side, cut through the window's
  wraparound; the span's passes (pixels on the region's border keep their
  values) with the warm starts and emits that fall inside it, a span that
  ends inside a level included; the dead mark; rings read and written only
  at the pixels that emit, in a per-tile scratch that starts as garbage and
  that the first level fills; only the core written back;
* the two outputs: K3's level-collapsed max, read and written only on a
  candidate and at the last level, and K7's byte of every level.

The kernel's bbox planes are int16 pairs merged by packed min/max; the model
keeps the four coordinates apart with the same sentinels (INT16_MAX, -1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu_torch.ops.mser_cuda as tmc
from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames
from opencv_traffic_sign_detector_tpu_torch.ops.preprocess import enhance_contrast

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SPAN = tmc.SWEEP_SPAN
LO_INIT, HI_INIT = 32767, -1  # the kernel's (ymin, xmin) and (ymax, xmax) sentinels


def _nb_inner(x: torch.Tensor, op) -> torch.Tensor:
    """4-neighbour ``op`` of the region's inner pixels, inside the region."""
    c = x[:, 1:-1, 1:-1]
    return op(op(op(c, x[:, :-2, 1:-1]), op(x[:, 2:, 1:-1], x[:, 1:-1, :-2])), x[:, 1:-1, 2:])


def _jacobi_pass(state: list, act: torch.Tensor) -> list:
    """One pass over the region: active (inner and mask) pixels read the old
    values of their neighbours; all others keep theirs."""
    keys, ymin, xmin, ymax, xmax = state
    a = act[:, 1:-1, 1:-1]
    nk = _nb_inner(keys, torch.minimum)
    live = a & (nk >= 0)
    new = []
    for x, op, sentinel in ((keys, None, None), (ymin, torch.minimum, LO_INIT),
                            (xmin, torch.minimum, LO_INIT), (ymax, torch.maximum, HI_INIT),
                            (xmax, torch.maximum, HI_INIT)):
        y = x.clone()
        inner = x[:, 1:-1, 1:-1]
        if op is None:
            y[:, 1:-1, 1:-1] = torch.where(a, nk, inner)
        else:
            y[:, 1:-1, 1:-1] = torch.where(live, _nb_inner(x, op),
                                           torch.where(a, sentinel, inner))
        new.append(y)
    return new


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _tile_span(win, s_in, s_out, ring, out, p, nl, lbits, core_rows, halo, tile, t0, p0,
               npass):
    """One block of ``sweep_tile_kernel``: tile ``(ty, tx, th, tw)`` of every
    window, passes ``[t0 * num_passes + p0, ... + npass)``.  ``ring``: this
    tile's scratch, bf16 [n, d + 4, region rows, region columns].  Returns
    the dead marks set on the core."""
    n, r, w = win.shape
    ty, tx, th, tw = tile
    hw, nring = r * w, p.d + 1
    big = 256 * hw
    row0, col0 = ty * th - SPAN, tx * tw - SPAN
    rh, rw = th + 2 * SPAN, tw + 2 * SPAN
    i, j = torch.arange(rh), torch.arange(rw)
    gr, gc = (row0 + i) % r, (col0 + j) % w  # the region through the wraparound
    v = win[:, gr][:, :, gc]
    rows = gr.to(torch.int32)[:, None].expand_as(v)
    cols = gc.to(torch.int32)[None, :].expand_as(v)
    keys0 = v * hw + rows * w + cols
    if t0 == 0 and p0 == 0:
        state = [torch.full_like(v, x) for x in (big, LO_INIT, LO_INIT, HI_INIT, HI_INIT)]
    else:
        state = [s[:, gr][:, :, gc] for s in s_in]
    inner = ((i > 0) & (i < rh - 1))[:, None] & ((j > 0) & (j < rw - 1))[None, :]
    on_rows = ((gr > 0) & (gr < r - 1))[:, None]
    ci = i[(i >= SPAN) & (i < SPAN + th) & (row0 + i < r)]  # core rows and columns
    cj = j[(j >= SPAN) & (j < SPAN + tw) & (col0 + j < w)]
    ei = ci[(row0 + ci >= halo) & (row0 + ci < halo + core_rows)]  # rows that emit
    emit = torch.zeros((rh, rw), dtype=torch.bool)
    emit[ei[:, None], cj[None, :]] = True
    rows_out, cols_out = (row0 + ei)[:, None], (col0 + cj)[None, :]
    one, zero, inf = _f32(1.0), _f32(0.0), _f32(float("inf"))
    dead = 0

    t, pp, left = t0, p0, npass
    while True:
        mask = (v <= t * p.step) & on_rows
        if pp == 0:  # warm start
            keys, ymin, xmin, ymax, xmax = state
            state = [torch.where(mask, torch.minimum(keys, keys0), big),
                     torch.where(mask, torch.minimum(ymin, rows), LO_INIT),
                     torch.where(mask, torch.minimum(xmin, cols), LO_INIT),
                     torch.where(mask, torch.maximum(ymax, rows), HI_INIT),
                     torch.where(mask, torch.maximum(xmax, cols), HI_INIT)]
        while pp < p.num_passes and left > 0:
            state = _jacobi_pass(state, inner & mask)
            pp, left = pp + 1, left - 1
        if pp < p.num_passes:
            break  # the span ends inside level t

        keys, ymin, xmin, ymax, xmax = state
        anchor = mask & (keys == keys0)
        bb = ((ymax - ymin + 1).to(torch.float32) * (xmax - xmin + 1).to(torch.float32))
        a_cur = torch.where(anchor, torch.minimum(bb, _f32(65535.0)), zero)
        killed = anchor & (a_cur > p.max_area)
        state[0] = torch.where(killed, -1, keys)
        dead += int(killed[:, ci[:, None], cj[None, :]].sum())

        old_a = t % nring  # also the slot this level writes
        td_a = (t + nring - p.d % nring) % nring
        v_new_s = (t + 2 * nring - p.d) % 2
        s_vc, s_vp, s_last = nring + 1 - v_new_s, nring + v_new_s, nring + 2
        if t:
            area, a_td, v_c, v_prev, last = (ring[:, s].to(torch.float32)
                                             for s in (old_a, td_a, s_vc, s_vp, s_last))
        else:  # the first level reads what the rings start as
            area = a_td = last = torch.zeros_like(a_cur)
            v_c = v_prev = torch.full_like(a_cur, float("inf"))
        v_new = torch.where((a_td > 0) & (a_cur > 0),
                            (a_cur - a_td) / torch.maximum(a_td, one), inf)
        cand = ((area >= p.min_area) & (area <= p.max_area) & (v_c < p.max_variation)
                & (v_c <= v_prev) & (v_c <= v_new))
        cand &= (last <= 0) | ((area - last) >= _f32(p.min_diversity) * torch.maximum(area, one))
        qv = torch.clamp(_f32(254.0) - torch.floor(v_c * _f32(253.0)), 1.0, 254.0)
        byte = torch.where(cand, qv, zero).to(torch.int32)

        writes = {old_a: a_cur, s_vp: v_new, s_last: torch.where(cand, area, last)}
        if t == 0:  # the first level writes every slot
            writes.update({s: zero.expand_as(a_cur) for s in range(nring) if s != old_a})
            writes[s_vc] = v_c
        for s, val in writes.items():
            ring[:, s] = torch.where(emit, val.to(torch.bfloat16), ring[:, s])

        got = byte[:, ei[:, None], cj[None, :]]
        if lbits is None:  # K7: this level's byte
            out[:, t, rows_out, cols_out] = got.to(torch.uint8)
        else:  # K3: the running max, on a candidate and at the last level
            packed = got * (1 << lbits) + t
            o = out[:, rows_out - halo, cols_out]
            if t == 0:
                o = packed
            elif t == nl - 1:
                o = torch.maximum(o, packed)
            else:
                o = torch.where(cand[:, ei[:, None], cj[None, :]], torch.maximum(o, packed), o)
            out[:, rows_out - halo, cols_out] = o
        t, pp = t + 1, 0
        if t == nl or left == 0:
            break

    for s, x in zip(s_out, state):  # write back the core
        s[:, (row0 + ci)[:, None], (col0 + cj)[None, :]] = x[:, ci[:, None], cj[None, :]]
    return dead


def _tiled_sweep(windows, p, nl, core_rows, halo, lbits=None):
    """``run_tiles`` over [N, R, W] u8 windows: K3's int32 [N, core_rows, W]
    with ``lbits``, else K7's u8 [N, nl, R, W]; and the dead marks set."""
    n, r, w = windows.shape
    th, tw = tmc.sweep_tiles(r, w)
    tiles = [(ty, tx, th, tw) for ty in range(-(-r // th)) for tx in range(-(-w // tw))]
    win = windows.to(torch.int32)
    bufs = [[torch.full((n, r, w), -55, dtype=torch.int32) for _ in range(5)] for _ in range(2)]
    rings = torch.full((len(tiles), n, p.d + 4, th + 2 * SPAN, tw + 2 * SPAN), 77.0,
                       dtype=torch.bfloat16)
    if lbits is None:
        out = torch.full((n, nl, r, w), 77, dtype=torch.uint8)
    else:
        out = torch.full((n, core_rows, w), -99, dtype=torch.int32)
    passes = nl * p.num_passes
    dead = 0
    for k, s0 in enumerate(range(0, passes, SPAN)):
        t0, p0 = divmod(s0, p.num_passes)
        for b, tile in enumerate(tiles):
            dead += _tile_span(win, bufs[k % 2], bufs[1 - k % 2], rings[b], out, p, nl, lbits,
                               core_rows, halo, tile, t0, p0, min(SPAN, passes - s0))
    return out, dead


def _schedule(cfg: MSERConfig):
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d_idx = max(1, round(cfg.delta / s))
    return d_idx, len(range(0, 256 + (d_idx + 1) * s + 1, s))


@pytest.fixture(scope="module")
def planes():
    """Polarity stack of 2 enhanced synthetic frames, [4, 80, 112] u8."""
    gray = enhance_contrast(torch.from_numpy(make_frames(2, 80, 112, seed=17)))
    return torch.cat([gray, 255 - gray])


TUNED = MSERConfig(delta=7, min_area=10, max_area=500, max_variation=1.0, ccl_iters=2,
                   ccl_jumps=0, level_step=9)
CFGS = {  # name: config; passes a level against the span of 6
    "iters2": TUNED,  # 4: every other span ends inside a level
    "iters3": dataclasses.replace(TUNED, ccl_iters=3),  # 6: spans end on levels
    "iters5": dataclasses.replace(TUNED, ccl_iters=5),  # 10: spans end inside levels
    "dead_marks": dataclasses.replace(TUNED, min_area=5, max_area=30),
    "ring3_step5": MSERConfig(delta=10, min_area=10, max_area=600, max_variation=0.8,
                              level_step=5, ccl_iters=3, ccl_jumps=0, topk_pool=2),
}
CASES = [  # config, plane rows and columns, strip halo (K3 only), outputs
    ("iters2", 37, 53, 0, ("full", "collapsed")),  # ragged: tiles of 27 columns
    ("iters2", 20, 30, 0, ("full", "collapsed")),  # smaller than a tile
    ("iters3", 20, 90, 0, ("full", "collapsed")),
    ("iters5", 37, 53, 0, ("full", "collapsed")),
    ("iters5", 3, 40, 0, ("full",)),  # 3 rows: one row on the mask
    ("dead_marks", 37, 53, 0, ("full", "collapsed")),
    ("ring3_step5", 37, 53, 0, ("full", "collapsed")),
    ("iters2", 37, 53, 8, ("collapsed",)),  # strip halo: core rows 8..28
    ("iters5", 45, 61, 12, ("collapsed",)),
]


@pytest.mark.parametrize("name,h,w,halo,mode", [
    (name, h, w, halo, mode) for name, h, w, halo, modes in CASES for mode in modes])
def test_tiled_model_matches_plain(planes, name, h, w, halo, mode):
    cfg = CFGS[name]
    d_idx, nl = _schedule(cfg)
    p = tmc.SweepParams.from_config(cfg, d_idx)
    windows = planes[:, 17:17 + h, 29:29 + w].contiguous()
    th, tw = tmc.sweep_tiles(h, w)
    if (h, w) == (37, 53):
        assert -(-w // tw) * tw > w  # a ghost column past the window's edge
    if (h, w) == (20, 30):
        assert h + 2 * SPAN > th == h and w + 2 * SPAN > tw == w  # the window wraps into itself
    if mode == "full":
        got, dead = _tiled_sweep(windows, p, nl, h, 0)
        want = tmc.fused_level_sweep_full_plain(windows, cfg, d_idx, nl)
        cands = int((want > 0).sum())
    else:
        _, lbits = tmc.packing_bits(cfg.topk_pool, nl)
        core = h - 2 * halo
        got, dead = _tiled_sweep(windows, p, nl, core, halo, lbits)
        want = tmc.level_sweep_windows_plain(windows, p, core, halo, nl, lbits)
        cands = int((want >> lbits > 0).sum())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    print(f"{name} {h}x{w} halo {halo} {mode}: candidates {cands}, dead marks {dead}")
    assert cands > 0
    assert dead > 0 or name != "dead_marks"
