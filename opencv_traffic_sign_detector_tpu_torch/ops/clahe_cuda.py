"""CLAHE kernels K1 (tile histograms, and the per-tile LUTs as its tail)
and K2 (interpolated LUT apply).

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py``.
Each wrapper takes its plain PyTorch version for CPU tensors and launches
its CUDA kernel (``csrc/clahe.cu``) for CUDA tensors; there is no fallback
from one to the other.  The kernels are exact against their plain
versions: K1 counts integers, its LUT tail clips and sums integers and
rounds one f32 product, K2 rounds every f32 product and sum on its own, in
the plain version's order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime import build as rt
from .clahe import _clip_and_redistribute, _interp_coords, _tile_luts
from .resident import resident

# The kernels' limits: the tile rows and sets a block keeps in shared memory
# (csrc/clahe.cu: kMaxTiles) and, for K2, the grid's frame dimension
MAX_TILES = 8
MAX_FRAMES = 65535
# K1's block (csrc/clahe.cu: kHistThreads), the private histogram sets it
# keeps (kHistCopies, consecutive warps in turn), the bytes of one load
# (kVec) and the blocks below which a tile row is cut into pieces
HIST_THREADS, HIST_COPIES, HIST_WORD = 512, 8, 16
HIST_MIN_BLOCKS = 256


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


def hist_pieces(b: int, tiles: int, th: int) -> int:
    """Blocks K1 cuts a tile row of ``th`` rows into: one where the frames'
    tile rows alone give ``HIST_MIN_BLOCKS`` blocks (about two an SM), else
    enough row pieces to, which then add into a zeroed output."""
    return max(1, min(th, -(-HIST_MIN_BLOCKS // max(b * tiles, 1))))


def _check_kernel_tiles(tiles: int) -> None:
    if tiles > MAX_TILES:
        raise ValueError(f"the kernel takes at most {MAX_TILES}x{MAX_TILES} tiles, got {tiles}")


def tile_histograms(x: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """K1: [B, H, W] uint8 (H, W divisible by tiles) -> [B, T, T, 256] int32.

    Replaces ``clahe_pallas.py: tile_histograms_pallas``.  The kernel takes
    at most 8x8 tiles; the plain version has no such limit.
    """
    _check_frames(x, tiles)
    if rt.uses_plain(x):
        return tile_histograms_plain(x, tiles)
    _check_kernel_tiles(tiles)
    b, h, w = x.shape
    out = torch.empty((b, tiles, tiles, 256), dtype=torch.int32, device=x.device)
    rc = rt.library().tsd_tile_histograms(
        x.data_ptr(), out.data_ptr(), b, h, w, tiles, hist_pieces(b, tiles, h // tiles),
        rt.stream_ptr(x.device))
    rt.check(rc, "tile_histograms")
    rt.count_launch("tile_histograms")
    return out


def tile_luts_plain(x: torch.Tensor, clip: int, tile_area: int,
                    tiles: int = 8) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, T, T, 256] uint8 per-tile CLAHE LUTs."""
    hist = _clip_and_redistribute(tile_histograms_plain(x, tiles), clip)
    return _tile_luts(hist, tile_area).contiguous()


def tile_luts(x: torch.Tensor, clip: int, tile_area: int, tiles: int = 8) -> torch.Tensor:
    """K1 with the LUT tail: [B, H, W] uint8 -> [B, T, T, 256] uint8, each
    tile's histogram clipped at ``clip`` by OpenCV's rule, summed and scaled
    by ``f32(255 / tile_area)``, rounded half to even.

    Replaces the reference's XLA steps between its two kernels
    (``ops/clahe.py: _clip_and_redistribute`` and ``_tile_luts``).  One
    launch where a block owns a whole tile row (:func:`hist_pieces` is 1),
    else K1 and a second launch, a warp a tile.
    """
    _check_frames(x, tiles)
    if rt.uses_plain(x):
        return tile_luts_plain(x, clip, tile_area, tiles)
    _check_kernel_tiles(tiles)
    b, h, w = x.shape
    pieces = hist_pieces(b, tiles, h // tiles)
    luts = torch.empty((b, tiles, tiles, 256), dtype=torch.uint8, device=x.device)
    hist = None if pieces == 1 else torch.empty(luts.shape, dtype=torch.int32, device=x.device)
    rc = rt.library().tsd_tile_luts(
        x.data_ptr(), None if hist is None else hist.data_ptr(), luts.data_ptr(), b, h, w,
        tiles, pieces, int(clip), float(np.float32(255.0 / tile_area)),
        rt.stream_ptr(x.device))
    rt.check(rc, "tile_luts")
    rt.count_launch("tile_luts")
    return luts


def _axis_coords(size: int, tiles: int, k: int) -> np.ndarray:
    """Item ``k`` of :func:`_interp_coords` along one axis: the two tile
    indices as int32 (k 0, 1), the weight as f32 (k 2)."""
    a = _interp_coords(size, tiles, size // tiles)[k]
    return np.ascontiguousarray(a if k == 2 else a.astype(np.int32))


def _coords(h: int, w: int, tiles: int, device: torch.device):
    """Row and column tile indices and weights (ty1, ty2, ya, tx1, tx2, xa)
    on ``device``, made there once (``ops/resident.py``)."""
    return tuple(resident(_axis_coords, size, tiles, k, device=device)
                 for size in (h, w) for k in range(3))


# Columns a K2 block covers (csrc/clahe.cu: kSegCols) and the most rows it
# covers (kTileRows; a strip longer than that is cut into even pieces).
SEG_COLS = 512
PIECE_ROWS = 32


def apply_plan(h: int, w: int, tiles: int):
    """K2's launch plan for [*, h, w] frames.

    Returns ``(pieces, ya, col_case, xa, max_cases)``: ``pieces`` int32
    [P, 4] rows ``(r0, r1, ty1, ty2)``, runs of rows with constant tile rows
    under ``_interp_coords``, cut into even pieces of at most
    ``PIECE_ROWS``; the row weights ``ya``; per column the case ``k`` whose
    tile columns ``(max(k - 1, 0), min(k, tiles - 1))`` are its
    ``(tx1, tx2)``; the column weights ``xa``; the most cases in one column
    segment (``SEG_COLS`` wide), which sizes a block's LUT table.
    """
    ty1, ty2, ya = _interp_coords(h, tiles, h // tiles)
    cuts = np.flatnonzero((np.diff(ty1) != 0) | (np.diff(ty2) != 0)) + 1
    bounds = np.concatenate([[0], cuts, [h]])
    pieces = []
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        n = -(-(r1 - r0) // PIECE_ROWS)
        edges = r0 + (np.arange(n + 1) * (r1 - r0)) // n
        pieces += [(a, b, ty1[r0], ty2[r0]) for a, b in zip(edges[:-1], edges[1:])]
    tx1, tx2, xa = _interp_coords(w, tiles, w // tiles)
    col_case = np.where(tx1 < tx2, tx2, np.where(tx1 == 0, 0, tiles))
    max_cases = max(int(col_case[min(c + SEG_COLS, w) - 1] - col_case[c]) + 1
                    for c in range(0, w, SEG_COLS))
    return (np.array(pieces, np.int32).reshape(-1, 4), ya.astype(np.float32),
            col_case.astype(np.int32), xa.astype(np.float32), max_cases)


@functools.lru_cache(maxsize=32)
def _apply_tables(h: int, w: int, tiles: int, device: torch.device):
    """:func:`apply_plan`'s tables on ``device``, uploaded once per shape and
    device, and its case count."""
    *tables, max_cases = apply_plan(h, w, tiles)
    return (*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in tables), max_cases)


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

    Replaces ``clahe_pallas.py: clahe_apply_pallas``.  The kernel takes at
    most 8x8 tiles and 65535 frames; the plain version has no such limit.
    """
    _check_frames(x, tiles)
    rt.check_tensor(luts, "luts", torch.uint8, 4)
    if tuple(luts.shape) != (x.shape[0], tiles, tiles, 256):
        raise ValueError(f"luts: expected {(x.shape[0], tiles, tiles, 256)}, "
                         f"got {tuple(luts.shape)}")
    if rt.uses_plain(x, luts):
        return clahe_apply_plain(x, luts, tiles)
    b, h, w = x.shape
    _check_kernel_tiles(tiles)
    if b > MAX_FRAMES:
        raise ValueError(f"the kernel takes at most {MAX_FRAMES} frames, got {b}")
    pieces, ya, col_case, xa, max_cases = _apply_tables(h, w, tiles, x.device)
    out = torch.empty_like(x)
    rc = rt.library().tsd_clahe_apply(
        x.data_ptr(), luts.data_ptr(), pieces.data_ptr(), ya.data_ptr(),
        col_case.data_ptr(), xa.data_ptr(), out.data_ptr(), pieces.shape[0], b, h, w,
        tiles, max_cases, rt.stream_ptr(x.device))
    rt.check(rc, "clahe_apply")
    rt.count_launch("clahe_apply")
    return out
