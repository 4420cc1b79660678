"""MSER region proposals, batched over frames.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/mser.py:
mser_regions``: optional 2x2-mean downscale (area thresholds / 4), the
255-bordered polarity stack, then one of two sweeps:

* the fused sweep (kernel K3) with the pooled top-k over its
  level-collapsed map, when ``cfg.fused_sweep``, ``cfg.ccl_jumps == 0`` and
  the frame has a strip plan;
* otherwise the XLA level sweep (:func:`_level_sweep`: pixel-count
  stability, propagation by :func:`.ccl.propagate_min_keys` with kernel K5)
  with an exact top-k over every level's byte map;

and the native-resolution refine: the seed flood (kernel K4) when
``refine_scan_passes > 0``, else the roll flood (kernel K5).  With
``sweep_res_pipeline`` and a downscale the refine runs on the sweep's own
small stack instead, in 64-px windows, and the boxes are scaled back.  The
exact pixel-area window is applied after the refine on the fused branch
only, as in the reference.  Frames are a batch dimension throughout; the
XLA sweep loops over levels, not frames.  The fused sweep's extent-only and
scan-pass bodies are K3's (``.mser_cuda``).
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import torch

from ..config import MSERConfig
from ..runtime.trace import TRACER
from .ccl import propagate_min_keys
from .mser_cuda import fused_level_sweep, packing_bits, plan_halo, sweep_plan
from .prop_cuda import bbox_area, candidate_windows, flood_bbox
from .resident import const_f32

_WIN = 128
# Roll-flood radius of the refine: two rounds of 48 passes, as the reference's
_REFINE_ROLLS = 48
# The XLA sweep's top-k key: (byte << 40) | (2^40 - 1 - flat index)
_IDX_BITS = 40


def stage_scope(timer, name: str):
    """``timer(name)`` when a stage timer is given, else a no-op context;
    inside a traced call (``runtime/trace.py``) also a device stamp at the
    stage's entry and exit."""
    stamps = TRACER.armed()
    if stamps is not None:
        return stamps.scope(name, timer)
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


def _level_sweep(im2: torch.Tensor, cfg: MSERConfig, d_idx: int, num_levels: int):
    """The XLA level sweep with pixel-count stability.

    im2: [B, 2, H, W] uint8 padded polarity stacks.  Yields, for scan step
    t, the byte map sb uint8 [B, 2, H, W]: 0 = not a candidate, else the
    quantized stability (higher = more stable) at each component's anchor
    pixel, for level ``t*step - (d_idx+1)*step``.  Counterpart of the
    reference's ``_level_sweep`` (its ``[L, 2, H*W]`` output, one level at a
    time).
    """
    b, p, h, w = im2.shape
    hw = h * w
    big = 256 * hw  # 2.8e8 at native 802x1362: int32 keys suffice
    dev = im2.device
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    im = im2.to(torch.int32)
    idx = torch.arange(hw, dtype=torch.int32, device=dev).reshape(h, w)
    keys0 = im * hw + idx
    plane_off = (torch.arange(b * p, device=dev) * hw).reshape(b, p, 1, 1)

    # comparisons and products with config floats round them to f32 first,
    # as JAX's weak typing does
    max_var = const_f32(cfg.max_variation, dev)
    min_div = const_f32(cfg.min_diversity, dev)
    one, inf = const_f32(1.0, dev), const_f32(float("inf"), dev)
    c253, c254 = const_f32(253.0, dev), const_f32(254.0, dev)
    keys = torch.full_like(keys0, big)
    # rings, oldest first: a_ring = A[t-d-1] .. A[t-1], v_ring = V[t-d-2], V[t-d-1]
    a_ring = [torch.zeros_like(keys0) for _ in range(d_idx + 1)]
    v_ring = [torch.full(im.shape, float("inf"), dtype=torch.float32, device=dev)] * 2
    last_emit = torch.zeros(im.shape, dtype=torch.float32, device=dev)

    for t in range(num_levels):
        mask = im <= t * s
        keys_in = torch.where(mask, torch.minimum(keys, keys0), big)
        keys = propagate_min_keys(keys_in, mask, big, num_rolls=cfg.ccl_iters,
                                  num_jumps=cfg.ccl_jumps, edges_safe=True)
        # area counts at anchor pixels.  Background pixels add 0 to their
        # own slot: the reference's shared dump slot would serialise most
        # of the atomic adds on one address per plane (5.8x slower on an
        # H100, PERF.md)
        slot = torch.where(mask, keys % hw, idx) + plane_off
        counts = torch.zeros(b * p * hw, dtype=torch.int32, device=dev)
        counts.index_add_(0, slot.reshape(-1), mask.reshape(-1).to(torch.int32))
        a_cur = counts.reshape(b, p, h, w).clamp(max=65535)  # the reference's uint16

        # V[t-d] on the seed chain.  The divisor is a tensor, so this is a
        # true division under jit too (no reciprocal rewrite).
        a_td, a_t = a_ring[1].to(torch.float32), a_cur.to(torch.float32)
        v_new = torch.where((a_td > 0) & (a_t > 0),
                            (a_t - a_td) / torch.maximum(a_td, one), inf)
        # candidates for level t-d-1
        v_c, area_c = v_ring[1], a_ring[0]
        cand = ((area_c >= cfg.min_area) & (area_c <= cfg.max_area) & (v_c < max_var)
                & (v_c <= v_ring[0]) & (v_c <= v_new))
        area_f = area_c.to(torch.float32)
        diverse = (last_emit <= 0) | ((area_f - last_emit)
                                      >= min_div * torch.maximum(area_f, one))
        cand = cand & diverse
        last_emit = torch.where(cand, area_f, last_emit)
        qv = torch.clamp(c254 - torch.floor(v_c * c253), 1.0, 254.0)
        yield torch.where(cand, qv, 0.0).to(torch.uint8)

        a_ring = a_ring[1:] + [a_cur]
        v_ring = [v_ring[1], v_new]


def _sweep_topk(im2: torch.Tensor, cfg: MSERConfig, d_idx: int, num_levels: int,
                timer=None):
    """Top ``max_regions`` of each frame's [L, 2, H*W] byte map, as
    ``lax.top_k`` over the flat map gives them (ties: lower index first).

    Each level's top-k is taken as the level is emitted and merged into the
    running top-k; under the total order of the packed key (byte, inverted
    flat index) every element of the global top-k is in its own level's
    top-k, so this is exact without materialising the map.
    -> (seeds_yx [B, N, 2], level_vals [B, N], pol_idx [B, N], valid [B, N]).
    """
    b, p, h, w = im2.shape
    hw, per_level = h * w, p * h * w
    n = cfg.max_regions
    low = (1 << _IDX_BITS) - 1
    inv_idx = low - torch.arange(per_level, dtype=torch.int64, device=im2.device)
    best = None
    levels = _level_sweep(im2, cfg, d_idx, num_levels)
    for t in range(num_levels):
        with stage_scope(timer, "sweep"):
            sb = next(levels)
        with stage_scope(timer, "topk"):
            packed = (sb.reshape(b, per_level).to(torch.int64) << _IDX_BITS) | (
                inv_idx - t * per_level)
            top = torch.topk(packed, min(n, per_level), dim=1).values
            if best is not None:
                top = torch.cat([best, top], dim=1)
                top = torch.topk(top, min(n, top.shape[1]), dim=1).values
            best = top
    with stage_scope(timer, "topk"):
        valid = (best >> _IDX_BITS) > 0
        flat = low - (best & low)
        t_idx = flat // per_level
        rem = flat - t_idx * per_level
        pol_idx = rem // hw
        q = rem - pol_idx * hw
        s = cfg.level_step if cfg.level_step > 0 else cfg.delta
        level_vals = torch.clamp(t_idx * s - (d_idx + 1) * s, min=0)
        seeds = torch.stack([q // w, q % w], dim=-1)
    return seeds, level_vals, pol_idx, valid


def sweep_candidates(gray: torch.Tensor, cfg: MSERConfig, timer=None):
    """Level sweep on [B, H, W] frames; top-k candidates.

    -> (seeds_yx [B, N, 2] padded coords, level_vals [B, N], pol_idx
    [B, N], valid [B, N], fused): the fused sweep (K3) when the config and
    the frame allow it, else the XLA sweep.
    """
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d_idx = max(1, round(cfg.delta / s))
    num_levels = len(range(0, 256 + (d_idx + 1) * s + 1, s))
    b = gray.shape[0]
    with stage_scope(timer, "sweep"):
        im2 = pad_pol(gray)
    _, _, h, w = im2.shape
    fused = (cfg.fused_sweep and cfg.ccl_jumps == 0
             and sweep_plan(h, w, cfg.topk_pool, plan_halo(cfg)) is not None)
    if not fused:
        return (*_sweep_topk(im2, cfg, d_idx, num_levels, timer), False)
    with stage_scope(timer, "sweep"):
        cmap = fused_level_sweep(im2.reshape(b * 2, h, w), cfg, d_idx, num_levels)
    with stage_scope(timer, "topk"):
        out = pooled_topk_packed(cmap.reshape((b, 2) + cmap.shape[1:]), cfg,
                                 num_levels, d_idx)
    return (*out, True)


def _refine_boxes(im2: torch.Tensor, seeds_yx: torch.Tensor, levels: torch.Tensor,
                  polarity: torch.Tensor, passes: int, seed_slack: int = 0,
                  win: int = _WIN):
    """Per candidate: flood its seed's component in a window centred on the
    seed at its level; bbox + pixel area.  ``passes > 0``: that many seed
    flood scan passes (K4); else the roll flood (K5).

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
    cand = cand.reshape(b * n, 6).to(torch.int32).contiguous()
    if passes > 0:
        out = flood_bbox(planes, cand, win_h, win_w, passes, big)
    else:  # roll flood of radius 2 * _REFINE_ROLLS over materialised windows
        mask, seed = candidate_windows(planes, cand, win_h, win_w)
        seed_map = torch.where(seed, 0, big).to(torch.int32)
        reach = propagate_min_keys(seed_map, mask, big, num_rolls=_REFINE_ROLLS,
                                   num_jumps=0, edges_safe=True,
                                   site="propagate_rolls_refine")
        out = bbox_area(reach == 0, big)
    ymin, ymax, xmin, xmax, area = out.reshape(b, n, 5).long().unbind(-1)
    boxes = torch.stack([x0 + xmin, y0 + ymin, xmax - xmin + 1, ymax - ymin + 1], dim=-1)
    return boxes, area


def mser_regions(gray: torch.Tensor, cfg: MSERConfig, timer=None):
    """MSER proposals on [B, H, W] uint8 frames.

    Returns (boxes_xywh int32 [B, max_regions, 4], valid bool
    [B, max_regions]), most stable first.  ``timer``, when given, is called
    with a stage name and returns a context manager around that stage.
    """
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
        seeds_s, level_vals, pol_idx, valid, fused = sweep_candidates(small, sub_cfg, timer)
        if cfg.sweep_res_pipeline:
            # the low-res refine: flood at sweep resolution in 64-px
            # windows, boxes scaled back to native coordinates
            with stage_scope(timer, "refine"):
                boxes, areas = _refine_boxes(pad_pol(small), seeds_s, level_vals, pol_idx,
                                             cfg.refine_scan_passes, win=64)
                if fused:
                    valid = (valid & (areas >= sub_cfg.min_area)
                             & (areas <= sub_cfg.max_area))
                boxes[..., 0] -= 1
                boxes[..., 1] -= 1
                boxes = torch.where(valid[..., None], boxes * ds, 0).to(torch.int32)
            return boxes, valid
        seeds = (seeds_s - 1) * ds + ds // 2 + 1  # block centre, native pad
        slack = ds
    else:
        seeds, level_vals, pol_idx, valid, fused = sweep_candidates(gray, cfg, timer)
        slack = 0
    with stage_scope(timer, "refine"):
        boxes, areas = _refine_boxes(pad_pol(gray), seeds, level_vals, pol_idx,
                                     cfg.refine_scan_passes, seed_slack=slack)
        if fused:
            # the fused sweep filters on bbox area; enforce the exact
            # pixel-area window (the XLA sweep already counted pixels)
            valid = valid & (areas >= cfg.min_area) & (areas <= cfg.max_area)
        boxes[..., 0] -= 1
        boxes[..., 1] -= 1
        boxes = torch.where(valid[..., None], boxes, 0).to(torch.int32)
    return boxes, valid


def mser_regions_batch(gray_batch: torch.Tensor, cfg: MSERConfig):
    """[B, H, W] -> ([B, N, 4], [B, N]): the reference's vmapped
    ``mser_regions``; :func:`mser_regions` takes the batch as it is."""
    return mser_regions(gray_batch, cfg)
