"""CLAHE kernels K1 (tile histograms) and K2 (interpolated LUT apply).

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py``.
Each wrapper takes its plain PyTorch version for CPU tensors and launches
its CUDA kernel (``csrc/clahe.cu``) for CUDA tensors; there is no fallback
from one to the other.  Both kernels are exact against their plain
versions: K1 counts integers, K2 rounds every f32 product and sum on its
own, in the plain version's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import build as rt
from .clahe import _interp_coords


def _check_frames(x: torch.Tensor, tiles: int) -> None:
    rt.check_tensor(x, "x", torch.uint8, 3)
    _, h, w = x.shape
    if h % tiles or w % tiles:
        raise ValueError(f"frame {h}x{w} is not divisible by {tiles} tiles")


def tile_histograms_plain(x: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, T, T, 256] int32 per-tile histograms."""
    b, h, w = x.shape
    th, tw = h // tiles, w // tiles
    tile_y = torch.arange(h, device=x.device) // th
    tile_x = torch.arange(w, device=x.device) // tw
    tile = (tile_y[:, None] * tiles + tile_x[None, :])[None]
    frame = torch.arange(b, device=x.device)[:, None, None]
    idx = ((frame * tiles * tiles + tile) * 256 + x.long()).reshape(-1)
    hist = torch.bincount(idx, minlength=b * tiles * tiles * 256)
    return hist.to(torch.int32).reshape(b, tiles, tiles, 256)


def tile_histograms(x: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """K1: [B, H, W] uint8 (H, W divisible by tiles) -> [B, T, T, 256] int32.

    Replaces ``clahe_pallas.py: tile_histograms_pallas``.
    """
    _check_frames(x, tiles)
    if rt.uses_plain(x):
        return tile_histograms_plain(x, tiles)
    b, h, w = x.shape
    out = torch.empty((b, tiles, tiles, 256), dtype=torch.int32, device=x.device)
    rc = rt.library().tsd_tile_histograms(
        x.data_ptr(), out.data_ptr(), b, h, w, tiles, rt.stream_ptr(x.device))
    rt.check(rc, "tile_histograms")
    rt.count_launch("tile_histograms")
    return out


def _coords(h: int, w: int, tiles: int, device: torch.device):
    """Row and column tile indices and weights as tensors on ``device``."""
    ty1, ty2, ya = _interp_coords(h, tiles, h // tiles)
    tx1, tx2, xa = _interp_coords(w, tiles, w // tiles)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return (t(ty1, torch.int32), t(ty2, torch.int32), t(ya, torch.float32),
            t(tx1, torch.int32), t(tx2, torch.int32), t(xa, torch.float32))


def clahe_apply_plain(x: torch.Tensor, luts: torch.Tensor,
                      tiles: int = 8) -> torch.Tensor:
    """Bilinear blend of the 4 neighbouring tile LUTs at each pixel's value."""
    b, h, w = x.shape
    ty1, ty2, ya, tx1, tx2, xa = _coords(h, w, tiles, x.device)
    flat = luts.reshape(b, -1)
    v = x.long().reshape(b, -1)

    def lookup(ty, tx):
        cell = (ty.long()[:, None] * tiles + tx.long()[None, :]).reshape(1, -1)
        return torch.gather(flat, 1, cell * 256 + v).reshape(b, h, w).float()

    p11, p12 = lookup(ty1, tx1), lookup(ty1, tx2)
    p21, p22 = lookup(ty2, tx1), lookup(ty2, tx2)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    xa = xa[None, None, :]
    ya = ya[None, :, None]
    top = p11 * (one - xa) + p12 * xa
    bot = p21 * (one - xa) + p22 * xa
    out = torch.round(top * (one - ya) + bot * ya)
    return out.clamp(0, 255).to(torch.uint8)


def clahe_apply(x: torch.Tensor, luts: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """K2: x [B, H, W] uint8 + LUTs [B, T, T, 256] uint8 -> [B, H, W] uint8.

    Replaces ``clahe_pallas.py: clahe_apply_pallas``.
    """
    _check_frames(x, tiles)
    rt.check_tensor(luts, "luts", torch.uint8, 4)
    if tuple(luts.shape) != (x.shape[0], tiles, tiles, 256):
        raise ValueError(f"luts: expected {(x.shape[0], tiles, tiles, 256)}, "
                         f"got {tuple(luts.shape)}")
    if tiles > 8:
        raise ValueError(f"at most 8x8 tiles, got {tiles}")
    if rt.uses_plain(x, luts):
        return clahe_apply_plain(x, luts, tiles)
    b, h, w = x.shape
    coords = _coords(h, w, tiles, x.device)
    out = torch.empty_like(x)
    rc = rt.library().tsd_clahe_apply(
        x.data_ptr(), luts.data_ptr(), *(c.data_ptr() for c in coords),
        out.data_ptr(), b, h, w, tiles, rt.stream_ptr(x.device))
    rt.check(rc, "clahe_apply")
    rt.count_launch("clahe_apply")
    return out
