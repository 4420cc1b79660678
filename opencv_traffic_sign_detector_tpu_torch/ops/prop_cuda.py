"""K4: per-candidate seed flood with bbox and pixel-area reduction.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/pallas_prop.py:
flood_bbox_pallas``.  Where the reference takes materialised [N, 128, 128]
seed maps and masks, both versions here read each candidate's window
straight from the padded native intensity planes, given per candidate its
plane, window origin, seed and level (a ``[N, 6]`` int32 table).  The mask
is ``pixel <= level`` inside the window's inner ring and the seed map is
``{0 at the seed, big elsewhere}``; the flood resolves mask runs along rows
and columns (H, V, ..., H) and reduces the seed component to
``(ymin, ymax, xmin, xmax, area)``.

``flood_bbox`` launches the CUDA kernel (``csrc/flood.cu``) for CUDA tensors
and takes ``flood_bbox_plain`` for CPU tensors; the two are exact.
"""

from __future__ import annotations

import torch

from ..runtime import build as rt

MAX_WIN = 128


def _axis_resolve(k: torch.Tensor, m: torch.Tensor, big: int, dim: int) -> torch.Tensor:
    """Segmented run-min along ``dim`` by Hillis-Steele doubling over rolled
    copies (the reference kernel's own formulation)."""
    size = k.shape[dim]
    mi = m.to(torch.int32)
    seg_fwd = mi * (1 - torch.roll(mi, 1, dim))
    seg_bwd = mi * (1 - torch.roll(mi, -1, dim))

    def dir_scan(x, f, fwd):
        step = 1
        while step < size:
            amt = step if fwd else -step
            x = torch.where(f > 0, x, torch.minimum(x, torch.roll(x, amt, dim)))
            f = torch.maximum(f, torch.roll(f, amt, dim))
            step *= 2
        return x

    out = torch.minimum(dir_scan(k, seg_fwd, True), dir_scan(k, seg_bwd, False))
    return torch.where(m, out, big)


def _windows(planes: torch.Tensor, cand: torch.Tensor, win_h: int, win_w: int):
    """Gather each candidate's [win_h, win_w] window and mask."""
    plane, y0, x0, sy, sx, level = cand.long().unbind(-1)
    p, h, w = planes.shape
    plane = plane.clamp(0, p - 1)
    y0, x0 = y0.clamp(0, h - win_h), x0.clamp(0, w - win_w)
    ry = torch.arange(win_h, device=planes.device)
    rx = torch.arange(win_w, device=planes.device)
    wins = planes[plane[:, None, None], (y0[:, None] + ry)[:, :, None],
                  (x0[:, None] + rx)[:, None, :]]
    inner = torch.zeros((win_h, win_w), dtype=torch.bool, device=planes.device)
    inner[1:-1, 1:-1] = True
    mask = (wins.long() <= level[:, None, None]) & inner
    seed = (ry[None, :, None] == sy[:, None, None]) & (rx[None, None, :] == sx[:, None, None])
    return mask, seed


def flood_bbox_plain(planes: torch.Tensor, cand: torch.Tensor, win_h: int,
                     win_w: int, passes: int, big: int) -> torch.Tensor:
    """-> [N, 5] int32 (ymin, ymax, xmin, xmax, area) of each seed component."""
    mask, seed = _windows(planes, cand, win_h, win_w)
    k = torch.where(mask & seed, 0, big).to(torch.int32)
    for _ in range(passes):
        k = _axis_resolve(k, mask, big, 2)
        k = _axis_resolve(k, mask, big, 1)
    sel = _axis_resolve(k, mask, big, 2) == 0
    rows = torch.arange(win_h, device=planes.device, dtype=torch.int32)[None, :, None]
    cols = torch.arange(win_w, device=planes.device, dtype=torch.int32)[None, None, :]
    ymin = torch.where(sel, rows, big).amin((1, 2))
    ymax = torch.where(sel, rows, -1).amax((1, 2))
    xmin = torch.where(sel, cols, big).amin((1, 2))
    xmax = torch.where(sel, cols, -1).amax((1, 2))
    area = sel.sum((1, 2), dtype=torch.int32)
    return torch.stack([ymin, ymax, xmin, xmax, area], dim=-1).to(torch.int32)


def flood_bbox(planes: torch.Tensor, cand: torch.Tensor, win_h: int, win_w: int,
               passes: int, big: int) -> torch.Tensor:
    """K4: planes [P, H, W] uint8, cand [N, 6] int32 (plane, y0, x0, seed_y,
    seed_x, level) -> [N, 5] int32.

    Replaces ``pallas_prop.py: flood_bbox_pallas`` (lanes 0-4 of its
    output).  Plane and origin are clamped so that each window lies inside
    the planes, as the reference's dynamic_slice clamps its start.
    """
    rt.check_tensor(planes, "planes", torch.uint8, 3)
    rt.check_tensor(cand, "cand", torch.int32, 2)
    if cand.shape[1] != 6:
        raise ValueError(f"cand: expected [N, 6], got {tuple(cand.shape)}")
    p, h, w = planes.shape
    if not (0 < win_h <= min(h, MAX_WIN) and 0 < win_w <= min(w, MAX_WIN)):
        raise ValueError(f"window {win_h}x{win_w} does not fit planes {h}x{w} "
                         f"or the {MAX_WIN}-px kernel limit")
    if rt.uses_plain(planes, cand):
        return flood_bbox_plain(planes, cand, win_h, win_w, passes, big)
    n = cand.shape[0]
    out = torch.empty((n, 5), dtype=torch.int32, device=planes.device)
    rc = rt.library().tsd_flood_bbox(
        planes.data_ptr(), cand.data_ptr(), out.data_ptr(), n, p, h, w, win_h,
        win_w, passes, big, rt.stream_ptr(planes.device))
    rt.check(rc, "flood_bbox")
    rt.count_launch("flood_bbox")
    return out
