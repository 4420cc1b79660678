"""Batched HOG descriptors matching cv2.HOGDescriptor's 32x32 configuration.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/hog.py``: window
32x32, block 16x16, stride 8x8, cell 8x8, 9 signed bins, Gaussian block
weighting (sigma 4, centred at blockSize*0.5 as OpenCV does), trilinear
cell/bin interpolation, L2-Hys with OpenCV's epsilons, blocks and cells in
cv2's column-major order: 3x3 blocks x 2x2 cells x 9 bins = 324 floats.

Per-pixel soft bin votes [N,32,32,9] are contracted against a (Gaussian x
bilinear) spatial weight tensor [16,16,2,2] per block.  The contraction is
a matrix product: on the card it must run in full f32 (no TF32), which the
callers set with ``models.detector.full_f32_matmuls``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import (
    HOG_BLOCK_SIZE,
    HOG_CELL_SIZE,
    HOG_NBINS,
    HOG_WIN_SIZE,
)
from .resident import const_f32, resident

_WIN = HOG_WIN_SIZE[0]
_BLK = HOG_BLOCK_SIZE[0]
_CELL = HOG_CELL_SIZE[0]
_STRIDE = 8
_NB = HOG_NBINS
_NBLOCKS = (_WIN - _BLK) // _STRIDE + 1  # 3 per axis
_CPB = _BLK // _CELL  # 2 cells per block axis


def _spatial_weights() -> np.ndarray:
    """[16, 16, 2, 2] per-block-pixel weight to each of the 2x2 cells,
    Gaussian * bilinear, OpenCV conventions."""
    sigma = (HOG_BLOCK_SIZE[0] + HOG_BLOCK_SIZE[1]) / 8.0  # 4.0
    scale = 1.0 / (2.0 * sigma * sigma)
    w = np.zeros((_BLK, _BLK, _CPB, _CPB), np.float64)
    for i in range(_BLK):
        for j in range(_BLK):
            # OpenCV centres the Gaussian at blockSize*0.5 = (8, 8)
            di = i - _BLK * 0.5
            dj = j - _BLK * 0.5
            gauss = math.exp(-(di * di + dj * dj) * scale)
            cy = (i + 0.5) / _CELL - 0.5
            cx = (j + 0.5) / _CELL - 0.5
            iy0 = math.floor(cy)
            ix0 = math.floor(cx)
            fy = cy - iy0
            fx = cx - ix0
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = iy0 + dy, ix0 + dx
                    if 0 <= yy < _CPB and 0 <= xx < _CPB:
                        w[i, j, yy, xx] = gauss * wy * wx
    return w.astype(np.float32)


def _gradients(img: torch.Tensor):
    """Central differences with reflect-101 borders on [..., 32, 32]."""
    f = img.to(torch.float32)
    left = torch.cat([f[..., :, 1:2], f[..., :, :-1]], dim=-1)
    right = torch.cat([f[..., :, 1:], f[..., :, -2:-1]], dim=-1)
    up = torch.cat([f[..., 1:2, :], f[..., :-1, :]], dim=-2)
    down = torch.cat([f[..., 1:, :], f[..., -2:-1, :]], dim=-2)
    return right - left, down - up


def hog_descriptors(crops: torch.Tensor) -> torch.Tensor:
    """[N, 32, 32] uint8 gray -> [N, 324] float32 descriptors."""
    dx, dy = _gradients(crops)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)  # [-pi, pi]: signed gradients span 2*pi

    dev = crops.device
    fbin = ang * const_f32(_NB / (2.0 * math.pi), dev) - const_f32(0.5, dev)
    b0 = torch.floor(fbin)
    w1 = fbin - b0
    b0i = torch.remainder(b0.to(torch.int32), _NB)
    b1i = torch.remainder(b0i + 1, _NB)
    bins = torch.arange(_NB, dtype=torch.int32, device=dev)
    votes = mag[..., None] * ((1.0 - w1)[..., None] * (b0i[..., None] == bins)
                              + w1[..., None] * (b1i[..., None] == bins))  # [N,32,32,9]

    wts = resident(_spatial_weights, device=dev)  # [16,16,2,2]
    block_hists = []
    # blocks scan x-outer and cells within a block likewise (cv2's layout)
    for bx in range(_NBLOCKS):
        for by in range(_NBLOCKS):
            blk = votes[..., by * _STRIDE:by * _STRIDE + _BLK,
                        bx * _STRIDE:bx * _STRIDE + _BLK, :]  # [N,16,16,9]
            h = torch.einsum("nijb,ijyx->nxyb", blk, wts)  # [N,cx,cy,9]
            block_hists.append(h.reshape(h.shape[0], -1))  # [N,36]
    blocks = torch.stack(block_hists, dim=1)  # [N, 9, 36]

    # L2-Hys with OpenCV's epsilons
    sz = blocks.shape[-1]
    s1 = torch.sqrt(torch.sum(blocks * blocks, dim=-1, keepdim=True))
    blocks = torch.minimum(blocks / (s1 + const_f32(sz * 0.1, dev)), const_f32(0.2, dev))
    s2 = torch.sqrt(torch.sum(blocks * blocks, dim=-1, keepdim=True))
    blocks = blocks / (s2 + const_f32(1e-3, dev))
    return blocks.reshape(blocks.shape[0], -1)


def gray_descriptors(crops: torch.Tensor) -> torch.Tensor:
    """The 'GRAY' feature: raw flattened pixels [N, 1024] float32."""
    return crops.reshape(crops.shape[0], -1).to(torch.float32)
