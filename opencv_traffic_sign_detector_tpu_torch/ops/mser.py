"""MSER region proposals, fused-sweep branch, batched over frames.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/mser.py:
mser_regions`` on its fused branch: optional 2x2-mean downscale (area
thresholds / 4), the 255-bordered polarity stack, the fused level sweep
(kernel K3), the pooled top-k over the level-collapsed map, and the
native-resolution seed flood refine (kernel K4) with the exact pixel-area
window.  Frames are a batch dimension throughout; there is no loop over
frames.

The XLA sweep (pixel-area stability, ``fused_sweep=False``), the low-res
refine (``sweep_res_pipeline``), the extent-only and scan-pass sweep
variants and the roll-based refine flood (``refine_scan_passes=0``) are not
ported yet (ROADMAP queue 1, slice 5); configs that ask for them raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import torch

from opencv_traffic_sign_detector_tpu.config import MSERConfig

from .mser_cuda import fused_level_sweep, packing_bits, plan_halo, sweep_plan
from .prop_cuda import flood_bbox

_WIN = 128


def check_supported(cfg: MSERConfig) -> None:
    """Raise NotImplementedError for MSER options outside this port slice."""
    unported = {
        "fused_sweep=False (XLA pixel-area sweep)": not cfg.fused_sweep,
        "ccl_jumps > 0 (XLA sweep)": cfg.ccl_jumps != 0,
        "sweep_res_pipeline": cfg.sweep_res_pipeline,
        "sweep_extent_only": cfg.sweep_extent_only,
        "scan_passes > 0": cfg.scan_passes > 0,
        "refine_scan_passes=0 (roll flood, kernel K5)": cfg.refine_scan_passes <= 0,
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(
            f"MSER option(s) {', '.join(missing)} are not ported to the "
            "PyTorch/CUDA package yet (ROADMAP.md queue 1, slice 5: off-path "
            "modes)")


def stage_scope(timer, name: str):
    """``timer(name)`` when a stage timer is given, else a no-op context."""
    return timer(name) if timer is not None else nullcontext()


def pad_pol(gray: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, 2, H+2, W+2] uint8 polarity stack (dark- and
    bright-on-background) with a 255 border."""
    both = torch.stack([gray, 255 - gray], dim=1)
    return torch.nn.functional.pad(both, (1, 1, 1, 1), value=255)


def pooled_topk_packed(cmap: torch.Tensor, cfg: MSERConfig, num_levels: int,
                       d_idx: int):
    """Candidate selection on the sweep's level-collapsed map.

    cmap: [B, 2, H, W] int32 (H, W pool multiples).  Max-pools
    (pool x pool) blocks with the in-block position packed into the low
    bits, then takes the ``max_regions`` largest values per frame, the lower
    index first among ties (a stable descending sort).
    -> (seeds_yx [B, N, 2], level_vals [B, N], pol_idx [B, N], valid [B, N]).
    """
    pool = max(1, cfg.topk_pool)
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    bits, lbits = packing_bits(pool, num_levels)
    b, p2, h, w = cmap.shape
    dev = cmap.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    local = ((rows % pool) * pool + cols % pool).to(torch.int32)
    comb = cmap * (1 << bits) + local
    h4, w4 = h // pool, w // pool
    best = comb.reshape(b, p2, h4, pool, w4, pool).amax(dim=(3, 5))

    vals, idx = torch.sort(best.reshape(b, -1), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :cfg.max_regions], idx[:, :cfg.max_regions]
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
    level_vals = torch.clamp(torch.clamp(t_idx, 0, num_levels - 1) * s
                             - (d_idx + 1) * s, min=0)
    seeds = torch.stack([y, x], dim=-1).long()
    return seeds, level_vals.long(), pol_idx, valid


def sweep_candidates(gray: torch.Tensor, cfg: MSERConfig, timer=None):
    """Run the fused level sweep on [B, H, W] frames; top-k candidates."""
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d_idx = max(1, round(cfg.delta / s))
    num_levels = len(range(0, 256 + (d_idx + 1) * s + 1, s))
    b = gray.shape[0]
    with stage_scope(timer, "sweep"):
        im2 = pad_pol(gray)
        _, _, h, w = im2.shape
        if sweep_plan(h, w, cfg.topk_pool, plan_halo(cfg)) is None:
            raise NotImplementedError(
                f"frame {h}x{w} has no strip plan; the XLA sweep that would "
                "take it is not ported yet (ROADMAP.md queue 1, slice 5)")
        cmap = fused_level_sweep(im2.reshape(b * 2, h, w), cfg, d_idx, num_levels)
    with stage_scope(timer, "topk"):
        out = pooled_topk_packed(cmap.reshape((b, 2) + cmap.shape[1:]), cfg,
                                 num_levels, d_idx)
    return out


def _refine_boxes(im2: torch.Tensor, seeds_yx: torch.Tensor, levels: torch.Tensor,
                  polarity: torch.Tensor, passes: int, seed_slack: int = 0,
                  win: int = _WIN):
    """Per candidate: flood its seed's component in a window centred on the
    seed at its level; bbox + pixel area.

    im2: [B, 2, H, W] uint8 padded polarity stacks; seeds_yx [B, N, 2],
    levels / polarity [B, N].  -> (boxes_xywh [B, N, 4], areas [B, N]).
    """
    b, _, h, w = im2.shape
    n = seeds_yx.shape[1]
    win_h, win_w = min(win, h), min(win, w)
    big = win_h * win_w + 1
    planes = im2.reshape(b * 2, h, w)
    plane = torch.arange(b, device=im2.device)[:, None] * 2 + polarity
    y, x = seeds_yx[..., 0], seeds_yx[..., 1]
    y0 = torch.clamp(y - win_h // 2, 0, max(h - win_h, 0))
    x0 = torch.clamp(x - win_w // 2, 0, max(w - win_w, 0))
    sy, sx = y - y0, x - x0
    if seed_slack > 0:
        # seeds from a downscaled sweep land near, not on, the native-res
        # extremum: snap to the first darkest pixel of the slack patch
        k = 2 * seed_slack + 1
        py = torch.clamp(sy - seed_slack, 0, win_h - k)
        px = torch.clamp(sx - seed_slack, 0, win_w - k)
        ar = torch.arange(k, device=im2.device)
        patch = planes[plane[..., None, None], (y0 + py)[..., None, None] + ar[:, None],
                       (x0 + px)[..., None, None] + ar[None, :]].reshape(b, n, k * k)
        first = torch.arange(k * k, device=im2.device)
        is_min = patch == patch.amin(-1, keepdim=True)
        off = torch.where(is_min, first, k * k).amin(-1)
        sy = py + off // k
        sx = px + off % k
    cand = torch.stack([plane, y0, x0, sy, sx, levels], dim=-1)
    out = flood_bbox(planes, cand.reshape(b * n, 6).to(torch.int32).contiguous(),
                     win_h, win_w, passes, big).reshape(b, n, 5).long()
    ymin, ymax, xmin, xmax, area = out.unbind(-1)
    boxes = torch.stack([x0 + xmin, y0 + ymin, xmax - xmin + 1, ymax - ymin + 1], dim=-1)
    return boxes, area


def mser_regions(gray: torch.Tensor, cfg: MSERConfig, timer=None):
    """MSER proposals on [B, H, W] uint8 frames.

    Returns (boxes_xywh int32 [B, max_regions, 4], valid bool
    [B, max_regions]), most stable first.  ``timer``, when given, is called
    with a stage name and returns a context manager around that stage.
    """
    check_supported(cfg)
    ds = max(1, cfg.downscale)
    b, h0, w0 = gray.shape
    if ds > 1:
        hc, wc = (h0 // ds) * ds, (w0 // ds) * ds
        with stage_scope(timer, "sweep"):
            blocks = gray[:, :hc, :wc].reshape(b, hc // ds, ds, wc // ds, ds)
            small = (blocks.to(torch.int32).sum(dim=(2, 4)) // (ds * ds)).to(torch.uint8)
        sub_cfg = dataclasses.replace(
            cfg, min_area=max(cfg.min_area // (ds * ds), 1),
            max_area=max(cfg.max_area // (ds * ds), 1), downscale=1)
        seeds_s, level_vals, pol_idx, valid = sweep_candidates(small, sub_cfg, timer)
        seeds = (seeds_s - 1) * ds + ds // 2 + 1  # block centre, native pad
        slack = ds
    else:
        seeds, level_vals, pol_idx, valid = sweep_candidates(gray, cfg, timer)
        slack = 0
    with stage_scope(timer, "refine"):
        boxes, areas = _refine_boxes(pad_pol(gray), seeds, level_vals, pol_idx,
                                     cfg.refine_scan_passes, seed_slack=slack)
        # the sweep filters on bbox area; enforce the exact pixel-area window
        valid = valid & (areas >= cfg.min_area) & (areas <= cfg.max_area)
        boxes[..., 0] -= 1
        boxes[..., 1] -= 1
        boxes = torch.where(valid[..., None], boxes, 0).to(torch.int32)
    return boxes, valid
