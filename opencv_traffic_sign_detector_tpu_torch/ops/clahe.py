"""CLAHE (cv2.createCLAHE(clipLimit=2).apply) on [..., H, W] uint8 tensors.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/clahe.py``: reflect-101
pad to a multiple of the tile grid, per-tile 256-bin histograms (kernel K1),
OpenCV's clip-and-redistribute rule, per-tile LUTs, bilinear LUT apply
(kernel K2), crop.  For CUDA tensors the histograms, the clip rule and the
LUTs are one launch (``clahe_cuda.tile_luts``: K1 with the LUT tail); for
CPU tensors they are the plain PyTorch steps below, which are XLA in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .resident import const_f32


def _clip_and_redistribute(hist: torch.Tensor, clip_limit: int) -> torch.Tensor:
    """OpenCV clip rule: cap bins, spread excess evenly, then the residual
    one-per-bin at stride max(256 // residual, 1)."""
    excess = torch.clamp(hist - clip_limit, min=0).sum(-1, keepdim=True)
    clipped = torch.clamp(hist, max=clip_limit)
    batch = excess // 256
    residual = excess - batch * 256
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    bins = torch.arange(256, dtype=hist.dtype, device=hist.device)
    bonus = (residual > 0) & (bins % step == 0) & (bins // step < residual)
    return (clipped + batch + bonus.to(hist.dtype)).to(torch.int32)


def _tile_luts(hist: torch.Tensor, tile_area: int) -> torch.Tensor:
    """Per-tile LUT: round-half-even(cumsum * 255 / tileArea), uint8."""
    cdf = torch.cumsum(hist, dim=-1).to(torch.float32)
    scale = const_f32(255.0 / tile_area, hist.device)
    return torch.round(cdf * scale).clamp(0, 255).to(torch.uint8)


def _interp_coords(size: int, tiles: int, tile_size: int):
    """Static per-pixel tile indices and bilinear weight along one axis."""
    pos = (np.arange(size, dtype=np.float64) / tile_size) - 0.5
    t1 = np.floor(pos).astype(np.int64)
    frac = (pos - t1).astype(np.float32)
    t2 = np.clip(t1 + 1, 0, tiles - 1)
    t1 = np.clip(t1, 0, tiles - 1)
    return t1, t2, frac


def reflect101_index(size: int, before: int, after: int,
                     device: torch.device) -> torch.Tensor:
    """Source indices of a reflect-101 pad (abc -> b|abc|b) along one axis."""
    i = torch.arange(-before, size + after, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= size, 2 * (size - 1) - i, i)


def clahe_equalize(gray: torch.Tensor, clip_limit: float = 2.0,
                   tiles: int = 8) -> torch.Tensor:
    """CLAHE over uint8 [..., H, W]; returns uint8 of the same shape."""
    from .clahe_cuda import clahe_apply, tile_luts

    lead = gray.shape[:-2]
    h, w = gray.shape[-2:]
    x = gray.reshape((-1, h, w))
    pad_h, pad_w = (-h) % tiles, (-w) % tiles
    if pad_h or pad_w:
        rows = reflect101_index(h, 0, pad_h, x.device)
        cols = reflect101_index(w, 0, pad_w, x.device)
        x = x[:, rows][:, :, cols]
    x = x.contiguous()
    hp, wp = h + pad_h, w + pad_w
    tile_area = (hp // tiles) * (wp // tiles)
    clip = max(int(clip_limit * tile_area / 256.0), 1)
    out = clahe_apply(x, tile_luts(x, clip, tile_area, tiles), tiles)
    if pad_h or pad_w:
        out = out[:, :h, :w]
    return out.reshape(lead + (h, w))
