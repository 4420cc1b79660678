"""Plain PyTorch reference of the MSER detection path at the tuned point.

A frozen, self-contained copy of the port's plain (CPU) versions of each
stage, as they stood when this benchmark was written: gray, CLAHE (clip 2,
8x8 tiles), the 3x3 Gaussian, the gamma LUT; the 2x2-mean downscale, the
255-bordered polarity stack and the fused bbox-area level sweep with Jacobi
passes; the pooled top-k; the native-resolution seed flood (scan resolves)
and the bbox; the aspect filter and grow, crop and bilinear resize, the two
dedup passes and the mean-mask classifier.  It imports nothing of the
program.  Every op is a plain tensor op, so it runs on the CPU or on a card;
``tf32=True`` lets the float32 matrix products of the resize and the
histogram correlation run in TF32 (the benchmark's control, one precision
below the configuration's float32 with TF32 off).

Only the configuration the benchmark runs is implemented (``fused_sweep``,
``ccl_jumps == 0``, ``scan_passes == 0``, ``refine_scan_passes > 0``,
``sweep_res_pipeline`` off); :func:`detect` raises on another.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

# the program's constants (GTSDB práctica 1), frozen here
DETECT_CROP, DETECT_GROW = 25, 1.30
ASPECT_MIN, ASPECT_MAX = 0.8, 1.20
DEDUP_HIST_TOL, DEDUP_COORD_TOL, DEDUP_MERGE_BAND = 0.85, 0.95, 0.8823
RED_LOW_BAND = ((0, 50, 10), (10, 255, 255))
RED_HIGH_BAND = ((160, 50, 10), (179, 255, 255))
BLUE_BAND = ((90, 70, 10), (128, 255, 255))
H_BINS, S_BINS = 50, 60
_HSV_SHIFT = 12
_VMEM_PX = 1_110_000
_HALO_MIN, _HALO_MAX, _ROW_ALIGN = 32, 160, 8
_WIN, _CROP_WIN = 128, 192


@dataclasses.dataclass(frozen=True)
class Params:
    """The MSER and pipeline settings of a benchmark configuration."""

    delta: int
    min_area: int
    max_area: int
    max_variation: float
    min_diversity: float
    level_step: int
    ccl_iters: int
    topk_pool: int
    max_regions: int
    downscale: int
    bbox_area_cap_scale: float
    refine_scan_passes: int
    max_detections: int
    mask_corr_tol: float

    @classmethod
    def from_config(cls, c: dict) -> "Params":
        bad = {k: c[k] for k in ("ccl_jumps", "scan_passes", "sweep_extent_only",
                                 "sweep_res_pipeline", "fine_scores")
               if c.get(k)}
        if bad or not c.get("fused_sweep", True) or c["refine_scan_passes"] <= 0:
            raise ValueError(f"the reference implements the fused tuned path only, not {bad}")
        return cls(**{f.name: c[f.name] for f in dataclasses.fields(cls)})


def _f32(v: float, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


# ---------------------------------------------------------------- color


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).to(torch.uint8)


def bgr_to_hsv(bgr: torch.Tensor) -> torch.Tensor:
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    dev = bgr.device
    one, zero = _f32(1.0, dev), _f32(0.0, dev)
    sdiv_v = torch.where(v > 0, torch.round(_f32(float(255 << _HSV_SHIFT), dev)
                                            / torch.maximum(v.to(torch.float32), one)),
                         zero).to(torch.int32)
    hdiv_d = torch.where(diff > 0, torch.round(_f32(float(180 << _HSV_SHIFT) / 6.0, dev)
                                               / torch.maximum(diff.to(torch.float32), one)),
                         zero).to(torch.int32)
    s = (diff * sdiv_v + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    is_r = v == r
    is_g = (v == g) & ~is_r
    numer = torch.where(is_r, g - b, torch.where(is_g, b - r + 2 * diff, r - g + 4 * diff))
    h = (numer * hdiv_d + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def _in_range(hsv, lo, hi):
    x = hsv.to(torch.int32)
    ok = torch.ones(hsv.shape[:-1], dtype=torch.bool, device=hsv.device)
    for c in range(3):
        ok &= (x[..., c] >= lo[c]) & (x[..., c] <= hi[c])
    return ok


def color_mask(bgr: torch.Tensor, color: str) -> torch.Tensor:
    hsv = bgr_to_hsv(bgr)
    if color == "r":
        return _in_range(hsv, *RED_LOW_BAND) | _in_range(hsv, *RED_HIGH_BAND)
    return _in_range(hsv, *BLUE_BAND)


# ---------------------------------------------------------------- preprocess


def reflect101_index(size: int, before: int, after: int, dev) -> torch.Tensor:
    i = torch.arange(-before, size + after, device=dev)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= size, 2 * (size - 1) - i, i)


def _interp_coords(size: int, tiles: int, tile_size: int):
    pos = (np.arange(size, dtype=np.float64) / tile_size) - 0.5
    t1 = np.floor(pos).astype(np.int64)
    frac = (pos - t1).astype(np.float32)
    t2 = np.clip(t1 + 1, 0, tiles - 1)
    return np.clip(t1, 0, tiles - 1), t2, frac


def clahe(gray: torch.Tensor, clip_limit: float = 2.0, tiles: int = 8) -> torch.Tensor:
    """CLAHE of [B, H, W] uint8: reflect-101 pad to the tile grid, tile
    histograms, OpenCV's clip and redistribute, LUTs rounded half to even,
    the bilinear blend of four tile LUTs, crop."""
    b, h, w = gray.shape
    dev = gray.device
    pad_h, pad_w = (-h) % tiles, (-w) % tiles
    x = gray
    if pad_h or pad_w:
        x = x[:, reflect101_index(h, 0, pad_h, dev)][:, :, reflect101_index(w, 0, pad_w, dev)]
    hp, wp = h + pad_h, w + pad_w
    th, tw = hp // tiles, wp // tiles
    tile_area = th * tw
    clip = max(int(clip_limit * tile_area / 256.0), 1)
    tile = ((torch.arange(hp, device=dev) // th)[:, None] * tiles
            + (torch.arange(wp, device=dev) // tw)[None, :])[None]
    frame = torch.arange(b, device=dev)[:, None, None]
    idx = ((frame * tiles * tiles + tile) * 256 + x.long()).reshape(-1)
    hist = torch.bincount(idx, minlength=b * tiles * tiles * 256).to(torch.int32)
    hist = hist.reshape(b, tiles, tiles, 256)
    excess = torch.clamp(hist - clip, min=0).sum(-1, keepdim=True)
    clipped = torch.clamp(hist, max=clip)
    batch = excess // 256
    residual = excess - batch * 256
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    bins = torch.arange(256, dtype=hist.dtype, device=dev)
    bonus = (residual > 0) & (bins % step == 0) & (bins // step < residual)
    hist = (clipped + batch + bonus.to(hist.dtype)).to(torch.int32)
    cdf = torch.cumsum(hist, dim=-1).to(torch.float32)
    luts = torch.round(cdf * _f32(255.0 / tile_area, dev)).clamp(0, 255).to(torch.uint8)

    def axis(size, k):
        a = _interp_coords(size, tiles, size // tiles)[k]
        return torch.from_numpy(np.ascontiguousarray(a if k == 2 else a.astype(np.int32))).to(dev)

    ty1, ty2, ya, tx1, tx2, xa = (axis(s, k) for s in (hp, wp) for k in range(3))
    flat = luts.reshape(b, -1)
    v = x.long().reshape(b, -1)

    def lookup(ty, tx):
        cell = (ty.long()[:, None] * tiles + tx.long()[None, :]).reshape(1, -1)
        return torch.gather(flat, 1, cell * 256 + v).reshape(b, hp, wp).float()

    p11, p12, p21, p22 = lookup(ty1, tx1), lookup(ty1, tx2), lookup(ty2, tx1), lookup(ty2, tx2)
    one = torch.ones((), dtype=torch.float32, device=dev)
    xa, ya = xa[None, None, :], ya[None, :, None]
    top = p11 * (one - xa) + p12 * xa
    bot = p21 * (one - xa) + p22 * xa
    out = torch.round(top * (one - ya) + bot * ya).clamp(0, 255).to(torch.uint8)
    return out[:, :h, :w]


def gaussian_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    rows = reflect101_index(h, 1, 1, img.device)
    cols = reflect101_index(w, 1, 1, img.device)
    x = img.to(torch.int32)[..., rows, :][..., cols]
    horiz = x[..., :-2] + 2 * x[..., 1:-1] + x[..., 2:]
    total = horiz[..., :-2, :] + 2 * horiz[..., 1:-1, :] + horiz[..., 2:, :]
    return ((total + 8) >> 4).to(torch.uint8)


def enhance_contrast(bgr: torch.Tensor) -> torch.Tensor:
    """gray -> CLAHE -> blur -> gamma 2 (floor(sqrt(255 i)) as one f32 sqrt)."""
    eq = gaussian_blur_3x3(clahe(bgr_to_gray(bgr)))
    return torch.sqrt(eq.to(torch.float32) * _f32(255.0, eq.device)).to(torch.uint8)


# ---------------------------------------------------------------- sweep


def plan_halo(p: Params) -> int:
    dim = (float(p.max_area) * p.bbox_area_cap_scale) ** 0.5
    halo = -(-int(dim * 1.5) // _ROW_ALIGN) * _ROW_ALIGN
    return max(_HALO_MIN, min(halo, _HALO_MAX))


def sweep_plan(h: int, w: int, pool: int, halo: int):
    """(n_strips, core, halo) of a padded (h, w) frame, or None."""
    pool = max(1, pool)
    align = _ROW_ALIGN * pool // math.gcd(_ROW_ALIGN, pool)
    wp = -(-w // pool) * pool
    h_aligned = -(-h // align) * align
    rmax = _VMEM_PX // wp
    rmax -= rmax % _ROW_ALIGN
    if rmax >= h_aligned:
        return (1, h_aligned, 0)
    core = rmax - 2 * halo
    core -= core % align
    if core < align:
        return None
    return (-(-h // core), core, halo)


def packing_bits(pool: int, num_levels: int):
    pool = max(1, pool)
    return max((pool * pool - 1).bit_length(), 1), max((num_levels - 1).bit_length(), 1)


def level_count(p: Params):
    """(level step, d index, level count) of the sweep."""
    s = p.level_step if p.level_step > 0 else p.delta
    d_idx = max(1, round(p.delta / s))
    return s, d_idx, len(range(0, 256 + (d_idx + 1) * s + 1, s))


def pad_pol(gray: torch.Tensor) -> torch.Tensor:
    return F.pad(torch.stack([gray, 255 - gray], dim=1), (1, 1, 1, 1), value=255)


def nb4(x, op):
    return op(op(torch.roll(x, 1, -2), torch.roll(x, -1, -2)),
              op(torch.roll(x, 1, -1), torch.roll(x, -1, -1)))


def _sweep_levels(windows: torch.Tensor, p: Params, s: int, d: int, num_levels: int):
    """Per level, the candidate byte map (f32 [N, R, W]) of the bbox-area
    stability sweep with 2 * ccl_iters Jacobi passes a level."""
    n, r, w = windows.shape
    dev = windows.device
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
    hw = r * w
    big, bigc = 256 * hw, 1 << 28
    im = windows.to(i32)
    rows = torch.arange(r, device=dev, dtype=i32).view(1, r, 1)
    cols = torch.arange(w, device=dev, dtype=i32).view(1, 1, w)
    keys0 = im * hw + rows * w + cols

    def full(v):
        return torch.full((n, r, w), v, dtype=i32, device=dev)

    keys, ymin, xmin, ymax, xmax = full(big), full(bigc), full(bigc), full(-1), full(-1)
    nring = d + 1
    aring = torch.zeros((nring, n, r, w), dtype=bf16, device=dev)
    vring = torch.full((2, n, r, w), float("inf"), dtype=bf16, device=dev)
    lastemit = torch.zeros((n, r, w), dtype=bf16, device=dev)
    min_area = _f32(float(p.min_area), dev)
    max_area = _f32(float(p.max_area) * p.bbox_area_cap_scale, dev)
    max_var, min_div = _f32(float(p.max_variation), dev), _f32(float(p.min_diversity), dev)
    one, zero, inf = _f32(1.0, dev), _f32(0.0, dev), _f32(float("inf"), dev)
    cap, c253, c254 = _f32(65535.0, dev), _f32(253.0, dev), _f32(254.0, dev)
    mn, mx = torch.minimum, torch.maximum
    for t in range(num_levels):
        mask = (im <= t * s) & (rows > 0) & (rows < r - 1)
        keys = torch.where(mask, mn(keys, keys0), big)
        ymin = torch.where(mask, mn(ymin, rows), bigc)
        ymax = torch.where(mask, mx(ymax, rows), -1)
        xmin = torch.where(mask, mn(xmin, cols), bigc)
        xmax = torch.where(mask, mx(xmax, cols), -1)
        for _ in range(2 * p.ccl_iters):
            knew = torch.where(mask, mn(keys, nb4(keys, mn)), big)
            live = mask & (knew >= 0)
            ymin = torch.where(live, mn(ymin, nb4(ymin, mn)), bigc)
            ymax = torch.where(live, mx(ymax, nb4(ymax, mx)), -1)
            xmin = torch.where(live, mn(xmin, nb4(xmin, mn)), bigc)
            xmax = torch.where(live, mx(xmax, nb4(xmax, mx)), -1)
            keys = knew
        anchor = mask & (keys == keys0)
        bb = mn((ymax - ymin + 1).to(f32) * (xmax - xmin + 1).to(f32), cap)
        a_cur = torch.where(anchor, bb, zero)
        keys = torch.where(anchor & (bb > max_area), -1, keys)
        s_old = (t + nring - (d + 1) % nring) % nring
        s_td = (t + nring - d % nring) % nring
        s_v_new = (t + 2 * nring - d) % 2
        area_c = aring[s_old].to(f32)
        a_td = aring[s_td].to(f32)
        v_c = vring[1 - s_v_new].to(f32)
        v_prev = vring[s_v_new].to(f32)
        v_new = torch.where((a_td > 0) & (a_cur > 0), (a_cur - a_td) / mx(a_td, one), inf)
        cand = ((area_c >= min_area) & (area_c <= max_area) & (v_c < max_var)
                & (v_c <= v_prev) & (v_c <= v_new))
        last = lastemit.to(f32)
        cand = cand & ((last <= 0) | ((area_c - last) >= min_div * mx(area_c, one)))
        lastemit = torch.where(cand, area_c, last).to(bf16)
        qv = torch.clamp(c254 - torch.floor(v_c * c253), 1.0, 254.0)
        aring[t % nring] = a_cur.to(bf16)
        vring[s_v_new] = v_new.to(bf16)
        yield torch.where(cand, qv, zero)


def sweep_candidates(small: torch.Tensor, p: Params):
    """Sweep + pooled top-k on the downscaled frames [B, h, w] ->
    (seeds_yx [B, N, 2], level_vals [B, N], pol_idx [B, N], valid [B, N])."""
    s, d, num_levels = level_count(p)
    im2 = pad_pol(small)
    b, _, h, w = im2.shape
    pool = max(1, p.topk_pool)
    plan = sweep_plan(h, w, pool, plan_halo(p))
    if plan is None:
        raise ValueError(f"no strip plan for {h}x{w}")
    n_strips, core, halo = plan
    bits, lbits = packing_bits(pool, num_levels)
    wp = -(-w // pool) * pool
    im2p = torch.full((b * 2, n_strips * core + 2 * halo, wp), 255, dtype=torch.uint8,
                      device=im2.device)
    im2p[:, halo:halo + h, :w] = im2.reshape(b * 2, h, w)
    r = core + 2 * halo
    windows = im2p.unfold(1, r, core).permute(0, 1, 3, 2).reshape(b * 2 * n_strips, r, wp)
    cmap = torch.zeros((windows.shape[0], core, wp), dtype=torch.int32, device=im2.device)
    for t, qv in enumerate(_sweep_levels(windows.contiguous(), p, s, d, num_levels)):
        cmap = torch.maximum(cmap, qv[:, halo:halo + core].to(torch.int32) * (1 << lbits) + t)
    cmap = cmap.reshape(b, 2, n_strips * core, wp)
    # pooled top-k, the lower index first among ties
    hh, ww = cmap.shape[2:]
    rows = torch.arange(hh, device=cmap.device)[:, None]
    cols = torch.arange(ww, device=cmap.device)[None, :]
    local = ((rows % pool) * pool + cols % pool).to(torch.int32)
    comb = cmap * (1 << bits) + local
    h4, w4 = hh // pool, ww // pool
    best = comb.reshape(b, 2, h4, pool, w4, pool).amax(dim=(3, 5))
    vals, idx = torch.sort(best.reshape(b, -1), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :p.max_regions], idx[:, :p.max_regions]
    local = vals & ((1 << bits) - 1)
    t_idx = (vals >> bits) & ((1 << lbits) - 1)
    valid = (vals >> (bits + lbits)) > 0
    per_pol = h4 * w4
    pol_idx = idx // per_pol
    rem = idx - pol_idx * per_pol
    y4 = rem // w4
    x4 = rem - y4 * w4
    y = y4 * pool + local // pool
    x = x4 * pool + local % pool
    level_vals = torch.clamp(torch.clamp(t_idx, 0, num_levels - 1) * s - (d + 1) * s, min=0)
    return torch.stack([y, x], dim=-1).long(), level_vals.long(), pol_idx, valid


# ---------------------------------------------------------------- refine


def _axis_resolve(k, m, dim, big):
    """Segmented run-min of keys along ``dim`` (wrapping doubling scans)."""
    size = k.shape[dim]
    mi = m.to(torch.int32)

    def scan(x, f, fwd):
        step = 1
        while step < size:
            amt = step if fwd else -step
            x = torch.where(f > 0, x, torch.minimum(x, torch.roll(x, amt, dim)))
            f = torch.maximum(f, torch.roll(f, amt, dim))
            step *= 2
        return x

    v = torch.where(m, k, big)
    out = torch.minimum(scan(v, mi * (1 - torch.roll(mi, 1, dim)), True),
                        scan(v, mi * (1 - torch.roll(mi, -1, dim)), False))
    return torch.where(m, out, big)


def flood_bbox(planes, cand, win_h, win_w, passes, big):
    """[N, 5] (ymin, ymax, xmin, xmax, area) of each candidate's seed
    component in its window (scan resolves: rows, columns, ..., rows)."""
    plane, y0, x0, sy, sx, level = cand.long().unbind(-1)
    pn, h, w = planes.shape
    plane = plane.clamp(0, pn - 1)
    y0, x0 = y0.clamp(0, h - win_h), x0.clamp(0, w - win_w)
    ry = torch.arange(win_h, device=planes.device)
    rx = torch.arange(win_w, device=planes.device)
    wins = planes[plane[:, None, None], (y0[:, None] + ry)[:, :, None],
                  (x0[:, None] + rx)[:, None, :]]
    inner = (((ry > 0) & (ry < win_h - 1))[:, None] & ((rx > 0) & (rx < win_w - 1))[None, :])
    mask = (wins.long() <= level[:, None, None]) & inner
    seed = (ry[None, :, None] == sy[:, None, None]) & (rx[None, None, :] == sx[:, None, None])
    k = torch.where(mask & seed, 0, big).to(torch.int32)
    k = torch.where(mask, k, big)
    for _ in range(passes):
        k = _axis_resolve(k, mask, 2, big)
        k = _axis_resolve(k, mask, 1, big)
    sel = _axis_resolve(k, mask, 2, big) == 0
    rows = torch.arange(win_h, device=sel.device, dtype=torch.int32)[None, :, None]
    cols = torch.arange(win_w, device=sel.device, dtype=torch.int32)[None, None, :]
    return torch.stack([torch.where(sel, rows, big).amin((1, 2)),
                        torch.where(sel, rows, -1).amax((1, 2)),
                        torch.where(sel, cols, big).amin((1, 2)),
                        torch.where(sel, cols, -1).amax((1, 2)),
                        sel.sum((1, 2), dtype=torch.int32)], dim=-1).to(torch.int32)


def mser_regions(gray: torch.Tensor, p: Params):
    """[B, H, W] uint8 -> (boxes_xywh int32 [B, N, 4], valid [B, N])."""
    ds = max(1, p.downscale)
    b, h0, w0 = gray.shape
    hc, wc = (h0 // ds) * ds, (w0 // ds) * ds
    small = (gray[:, :hc, :wc].reshape(b, hc // ds, ds, wc // ds, ds).to(torch.int32)
             .sum(dim=(2, 4)) // (ds * ds)).to(torch.uint8)
    sub = dataclasses.replace(p, min_area=max(p.min_area // (ds * ds), 1),
                              max_area=max(p.max_area // (ds * ds), 1))
    seeds_s, levels, polarity, valid = sweep_candidates(small, sub)
    seeds = (seeds_s - 1) * ds + ds // 2 + 1
    slack = ds if ds > 1 else 0
    im2 = pad_pol(gray)
    _, _, h, w = im2.shape
    n = seeds.shape[1]
    win_h, win_w = min(_WIN, h), min(_WIN, w)
    big = win_h * win_w + 1
    planes = im2.reshape(b * 2, h, w)
    plane = torch.arange(b, device=gray.device)[:, None] * 2 + polarity
    y, x = seeds[..., 0], seeds[..., 1]
    y0 = torch.clamp(y - win_h // 2, 0, max(h - win_h, 0))
    x0 = torch.clamp(x - win_w // 2, 0, max(w - win_w, 0))
    sy, sx = y - y0, x - x0
    if slack > 0:
        k = 2 * slack + 1
        py = torch.clamp(sy - slack, 0, win_h - k)
        px = torch.clamp(sx - slack, 0, win_w - k)
        ar = torch.arange(k, device=gray.device)
        patch = planes[plane[..., None, None], (y0 + py)[..., None, None] + ar[:, None],
                       (x0 + px)[..., None, None] + ar[None, :]].reshape(b, n, k * k)
        first = torch.arange(k * k, device=gray.device)
        off = torch.where(patch == patch.amin(-1, keepdim=True), first, k * k).amin(-1)
        sy, sx = py + off // k, px + off % k
    cand = torch.stack([plane, y0, x0, sy, sx, levels], dim=-1).reshape(b * n, 6)
    out = flood_bbox(planes, cand.to(torch.int32), win_h, win_w, p.refine_scan_passes, big)
    ymin, ymax, xmin, xmax, area = out.reshape(b, n, 5).long().unbind(-1)
    boxes = torch.stack([x0 + xmin, y0 + ymin, xmax - xmin + 1, ymax - ymin + 1], dim=-1)
    valid = valid & (area >= p.min_area) & (area <= p.max_area)
    boxes[..., 0] -= 1
    boxes[..., 1] -= 1
    return torch.where(valid[..., None], boxes, 0).to(torch.int32), valid


# ---------------------------------------------------------------- classify


def filter_and_grow(boxes_xywh, valid, grow):
    bx = boxes_xywh.to(torch.float32)
    dev = bx.device
    x, y, w, h = bx.unbind(-1)
    zero = _f32(0.0, dev)
    ratio = w / torch.maximum(h, _f32(1.0, dev))
    keep = valid & (ratio > _f32(ASPECT_MIN, dev)) & (ratio < _f32(ASPECT_MAX, dev)) & (h > 0)
    g, half = _f32(grow - 1.0, dev), _f32(0.5, dev)
    dw, dh = w * g * half, h * g * half
    out = torch.stack([torch.maximum(x - dw, zero), torch.maximum(y - dh, zero),
                       torch.maximum(x + w + dw, zero), torch.maximum(y + h + dh, zero)], dim=-1)
    return out.to(torch.int32), keep


def crop_and_resize(image, boxes_xyxy, out_size):
    """Bilinear INTER_LINEAR crops [B, N, S, S, C] uint8 (the jit's
    reciprocal step), through 192-px windows and two hat-weight products
    where the frame holds such a window, else four corner gathers."""
    bsz, h, w, c = image.shape
    bb = boxes_xyxy.to(torch.float32)
    x1 = torch.clamp(bb[..., 0], 0.0, w - 1)
    y1 = torch.clamp(bb[..., 1], 0.0, h - 1)
    cw = torch.clamp(torch.clamp(bb[..., 2], 0.0, w) - x1, min=1.0)
    ch = torch.clamp(torch.clamp(bb[..., 3], 0.0, h) - y1, min=1.0)
    s = torch.arange(out_size, dtype=torch.float32, device=bb.device) + 0.5
    inv = _f32(float(np.float32(1.0) / np.float32(out_size)), bb.device)
    sx = x1[..., None] + s * (cw[..., None] * inv) - 0.5
    sy = y1[..., None] + s * (ch[..., None] * inv) - 0.5
    sx = torch.minimum(torch.maximum(sx, x1[..., None]), x1[..., None] + cw[..., None] - 1.0)
    sy = torch.minimum(torch.maximum(sy, y1[..., None]), y1[..., None] + ch[..., None] - 1.0)
    sx, sy = torch.clamp(sx, 0.0, w - 1.0), torch.clamp(sy, 0.0, h - 1.0)
    if h >= _CROP_WIN and w >= _CROP_WIN:
        n, win = boxes_xyxy.shape[1], _CROP_WIN
        wy0 = torch.clamp(y1.to(torch.int32), 0, h - win).long()
        wx0 = torch.clamp(x1.to(torch.int32), 0, w - win).long()
        rel_y = torch.clamp(sy - wy0[..., None].to(torch.float32), 0.0, win - 1.0)
        rel_x = torch.clamp(sx - wx0[..., None].to(torch.float32), 0.0, win - 1.0)
        ar = torch.arange(win, device=image.device)
        frame = torch.arange(bsz, device=image.device)[:, None, None, None]
        wins = image[frame, (wy0[..., None] + ar)[..., :, None],
                     (wx0[..., None] + ar)[..., None, :]].to(torch.float32)
        grid = ar.to(torch.float32)
        ry = torch.clamp(1.0 - torch.abs(rel_y[..., None] - grid), min=0.0)
        rx = torch.clamp(1.0 - torch.abs(rel_x[..., None] - grid), min=0.0)
        m = bsz * n
        tmp = torch.bmm(ry.reshape(m, out_size, win), wins.reshape(m, win, win * c))
        out = torch.matmul(rx.reshape(m, 1, out_size, win), tmp.reshape(m, out_size, win, c))
        out = torch.round(out).reshape(bsz, n, out_size, out_size, c)
    else:
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = sx - x0, sy - y0
        x0i, y0i = x0.long(), y0.long()
        x1i, y1i = torch.clamp(x0i + 1, max=w - 1), torch.clamp(y0i + 1, max=h - 1)
        flat = image.reshape(bsz, h * w, c).to(torch.float32)

        def sample(yi, xi):
            idx = (yi[..., :, None] * w + xi[..., None, :]).reshape(bsz, -1)
            got = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            return got.reshape(yi.shape[:2] + (out_size, out_size, c))

        fx2, fy2 = fx[..., None, :, None], fy[..., :, None, None]
        top = sample(y0i, x0i) * (1 - fx2) + sample(y0i, x1i) * fx2
        bot = sample(y1i, x0i) * (1 - fx2) + sample(y1i, x1i) * fx2
        out = torch.round(top * (1 - fy2) + bot * fy2)
    return out.clamp(0, 255).to(torch.uint8)


def _sigmoid_similarity(d):
    d = d.to(torch.float32)
    dsafe = torch.clamp(d, min=1e-20)
    sim = 1.0 / (1.0 + torch.exp((0.154 * dsafe ** 1.2 - 31.8) / (0.2 * dsafe)))
    return torch.where(d > 0, sim, torch.ones_like(sim))


def _coord_similarity(boxes):
    bx = boxes.to(torch.float32)
    tl, br = bx[..., :2], bx[..., 2:]
    d_tl = torch.linalg.vector_norm(tl[..., :, None, :] - tl[..., None, :, :], dim=-1)
    d_br = torch.linalg.vector_norm(br[..., :, None, :] - br[..., None, :, :], dim=-1)
    return torch.sqrt(_sigmoid_similarity(d_tl) * _sigmoid_similarity(d_br))


def _hist_correlation(crops):
    lead = crops.shape[:-3]
    hsv = bgr_to_hsv(crops).to(torch.int64).reshape(-1, crops.shape[-3] * crops.shape[-2], 3)
    hb = torch.clamp((hsv[..., 0] * H_BINS) // 180, 0, H_BINS - 1)
    sb = torch.clamp((hsv[..., 1] * S_BINS) // 256, 0, S_BINS - 1)
    hist = torch.bmm(F.one_hot(hb, H_BINS).to(torch.float32).transpose(1, 2),
                     F.one_hot(sb, S_BINS).to(torch.float32)).reshape(lead + (H_BINS * S_BINS,))
    mn = hist.amin(-1, keepdim=True)
    rng = hist.amax(-1, keepdim=True) - mn
    a = (hist - mn) * torch.where(rng > 0, 1.0 / torch.clamp(rng, min=1e-30),
                                  torch.zeros_like(rng))
    ac = a - a.mean(-1, keepdim=True)
    num = ac @ ac.transpose(-1, -2)
    va = (ac * ac).sum(-1)
    den = torch.sqrt(va[..., :, None] * va[..., None, :])
    return torch.where(den > 1e-12, num / torch.clamp(den, min=1e-30), torch.ones_like(num))


def _dedup(sims, crops, boxes, valid, tol):
    n = sims.shape[-1]
    ar = torch.arange(n, device=sims.device)
    vv = valid[..., :, None] & valid[..., None, :]
    later = ar[:, None] > ar[None, :]
    kill = vv & later & (sims >= DEDUP_MERGE_BAND * tol)
    alive = valid & ~kill.any(-2)
    merge = vv & later & (sims >= DEDUP_MERGE_BAND * tol) & (sims <= tol) & alive[..., :, None]
    group = merge | (torch.eye(n, dtype=torch.bool, device=sims.device) & alive[..., :, None])
    counts = torch.clamp(group.sum(-1).to(torch.float32), min=1.0)
    groupf = group.to(torch.float32)
    new_boxes = (groupf @ boxes.to(torch.float32)) / counts[..., None]
    new_boxes = torch.where(alive[..., None], new_boxes.to(torch.int32), boxes)
    lead = crops.shape[:-3]
    blended = torch.round((groupf @ crops.reshape(lead + (-1,)).to(torch.float32))
                          / counts[..., None]).to(crops.dtype).reshape(crops.shape)
    return torch.where(alive[..., None, None, None], blended, crops), new_boxes, alive


def _score_color(masks, templates):
    pix = DETECT_CROP * DETECT_CROP
    tp = masks @ templates.T
    fn = templates.sum(-1) - tp
    raw = 2.0 * tp / torch.clamp(2.0 * tp + fn, min=1e-9)
    raw = torch.where(tp + fn <= pix * 0.01, torch.zeros_like(raw), raw)
    score = torch.round(raw * 100.0) * _f32(float(np.float32(1.0) / np.float32(100.0)),
                                            raw.device)
    best = torch.argmax(score, dim=-1, keepdim=True)
    return torch.gather(score, -1, best)[..., 0], best[..., 0].to(torch.int32) + 1


def classify(crops, red, blue, tol):
    lead = crops.shape[:-3]
    red_m = color_mask(crops, "r").reshape(lead + (-1,)).to(torch.float32)
    blue_m = color_mask(crops, "b").reshape(lead + (-1,)).to(torch.float32)
    score_r, type_r = _score_color(red_m, red)
    score_b, type_b = _score_color(blue_m, blue)
    use_red = score_r > score_b
    score = torch.where(use_red, score_r, score_b)
    return torch.where(use_red, type_r, type_b), score, score > tol


def detect(frames: torch.Tensor, red: torch.Tensor, blue: torch.Tensor, p: Params,
           tf32: bool = False) -> list[list[tuple]]:
    """BGR uint8 [B, H, W, 3] -> per frame its records (x1, y1, x2, y2,
    type, score) in the program's order (the first ``max_detections`` kept
    and accepted proposals, most stable first)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        props, pvalid = mser_regions(enhance_contrast(frames), p)
        boxes, keep = filter_and_grow(props, pvalid, DETECT_GROW)
        crops = crop_and_resize(frames, boxes, DETECT_CROP)
        crops, boxes, keep = _dedup(_hist_correlation(crops), crops, boxes, keep,
                                    DEDUP_HIST_TOL)
        crops, boxes, keep = _dedup(_coord_similarity(boxes), crops, boxes, keep,
                                    DEDUP_COORD_TOL)
        types, scores, accept = classify(crops, red, blue, p.mask_corr_tol)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    final = (keep & accept).cpu()
    boxes, types, scores = boxes.cpu(), types.cpu(), scores.cpu()
    out = []
    for i in range(final.shape[0]):
        idx = torch.nonzero(final[i]).flatten()[:p.max_detections].tolist()
        out.append([(*(int(v) for v in boxes[i, j].tolist()), int(types[i, j]),
                     float(scores[i, j])) for j in idx])
    return out
