"""JPEG 4:2:0 -> BGR on the device: libjpeg's fancy upsample and fixed-point
YCbCr->RGB, bit for bit.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/yuv.py``.  The host
ships raw Y/Cb/Cr planes (1.5 bytes/px instead of BGR's 3) and the device
finishes the decode in integer math:

* h2v2 fancy upsampling (libjpeg ``jdsample.c``): vertically
  ``3*row[r] + row[r-1]`` (even output rows) or ``+ row[r+1]`` (odd),
  clamped at the edges; horizontally ``(3*this + left + 8) >> 4`` (even
  columns) and ``(3*this + right + 7) >> 4`` (odd).  The asymmetric
  rounding is what makes the result byte-identical to libjpeg.
* ``ycc_rgb_convert`` (``jdcolor.c``): SCALEBITS=16 fixed point, clamped.

``>>`` on int32 tensors is an arithmetic shift in PyTorch, as in XLA, so
negative chroma differences floor the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .resident import resident

# jdcolor.c build_ycc_rgb_table constants: FIX(x) = round(x * 2^16).
_FIX_1_40200 = 91881
_FIX_1_77200 = 116130
_FIX_0_34414 = 22554
_FIX_0_71414 = 46802
_ONE_HALF = 1 << 15


def _fancy_upsample_plane(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2_fancy_upsample of [..., ch, cw] chroma -> [..., 2ch, 2cw]
    int32 (values in 0..255)."""
    c = c.to(torch.int32)
    up = torch.cat([c[..., :1, :], c[..., :-1, :]], dim=-2)
    down = torch.cat([c[..., 1:, :], c[..., -1:, :]], dim=-2)
    v = torch.stack([3 * c + up, 3 * c + down], dim=-2)  # rows 2r, 2r+1
    v = v.reshape(*v.shape[:-3], -1, v.shape[-1])
    left = torch.cat([v[..., :, :1], v[..., :, :-1]], dim=-1)
    right = torch.cat([v[..., :, 1:], v[..., :, -1:]], dim=-1)
    out = torch.stack([(3 * v + left + 8) >> 4, (3 * v + right + 7) >> 4], dim=-1)
    return out.reshape(*out.shape[:-2], -1)


def _ycc_to_bgr(y: torch.Tensor, cb_full: torch.Tensor, cr_full: torch.Tensor) -> torch.Tensor:
    """Fixed-point YCbCr -> [..., 3] BGR uint8 (jdcolor.c ycc_rgb_convert)."""
    yi = y.to(torch.int32)
    cbd = cb_full - 128
    crd = cr_full - 128
    r = yi + ((_FIX_1_40200 * crd + _ONE_HALF) >> 16)
    g = yi + ((-_FIX_0_34414 * cbd + _ONE_HALF - _FIX_0_71414 * crd) >> 16)
    b = yi + ((_FIX_1_77200 * cbd + _ONE_HALF) >> 16)
    return torch.stack([b, g, r], dim=-1).clamp(0, 255).to(torch.uint8)


@functools.cache
def _fancy_kernel_and_bias() -> tuple[np.ndarray, np.ndarray]:
    """[3, 3, 16, 64] HWIO kernel + [64] bias of the fancy upsample on the
    patch grid: ``floor((K * c + bias) / 16)`` with integer taps {9, 3, 3, 1}
    (libjpeg's vertical pass is unrounded, so one ``>> 4`` remains)."""
    k = np.zeros((3, 3, 16, 64), np.float32)
    bias = np.zeros(64, np.float32)
    for ky in range(8):
        r = ky // 2
        vtaps = [(r, 3.0), (r - 1 if ky % 2 == 0 else r + 1, 1.0)]
        for kx in range(8):
            cc = kx // 2
            htaps = [(cc, 3.0), (cc - 1 if kx % 2 == 0 else cc + 1, 1.0)]
            bias[ky * 8 + kx] = 8.0 if kx % 2 == 0 else 7.0
            for ry, wy in vtaps:
                dy, cy = divmod(ry + 4, 4)      # patch offset in {0, 1, 2}
                for cx_, wx in htaps:
                    dx, cx = divmod(cx_ + 4, 4)
                    k[dy, dx, cy * 4 + cx, ky * 8 + kx] += wy * wx
    return k, bias


def _fancy_weight() -> torch.Tensor:
    """The fancy-upsample kernel as an OIHW view."""
    return torch.from_numpy(_fancy_kernel_and_bias()[0]).permute(3, 2, 0, 1)


def _fancy_bias() -> np.ndarray:
    return _fancy_kernel_and_bias()[1]


def _pad_chroma_patches(c_p: torch.Tensor) -> torch.Tensor:
    """[B, P, Q, 16] -> [B, P+2, Q+2, 16] halo with libjpeg's clamp: the conv
    reads only row 3 of the top halo patch, row 0 of the bottom one, column 3
    of the left and column 0 of the right, each set to the frame's edge; the
    rest is 0 and never read."""
    b, p, q, _ = c_p.shape
    z12 = c_p.new_zeros((b, 1, q, 12))
    top = torch.cat([z12, c_p[:, :1, :, 0:4]], dim=-1)
    bot = torch.cat([c_p[:, -1:, :, 12:16], z12], dim=-1)
    c4 = torch.cat([top, c_p, bot], dim=1).reshape(b, p + 2, q, 4, 4)
    z3 = c_p.new_zeros((b, p + 2, 1, 4, 3))
    left = torch.cat([z3, c4[:, :, :1, :, 0:1]], dim=-1)
    right = torch.cat([c4[:, :, -1:, :, 3:4], z3], dim=-1)
    return torch.cat([left, c4, right], dim=2).reshape(b, p + 2, q + 2, 16)


def _fancy_upsample_patches(c_p: torch.Tensor) -> torch.Tensor:
    """Patchified chroma [B, P, Q, 16] (k = cy*4 + cx) -> luma-grid patches
    [B, P, Q, 64] (k = ky*8 + kx), int32, equal to ``_fancy_upsample_plane``
    on the same data, as one 3x3 conv over the patch grid.

    The sums are integers <= 4095, exact in f32 with TF32 off; the conv's
    result is rounded to the nearest integer before the floor so that a
    convolution algorithm that is not exact in f32 (Winograd, FFT) cannot
    move a value across a multiple of 16.
    """
    weight = resident(_fancy_weight, device=c_p.device)
    cp = _pad_chroma_patches(c_p).to(torch.float32).permute(0, 3, 1, 2)
    acc = torch.round(F.conv2d(cp, weight)).permute(0, 2, 3, 1)
    acc = acc + resident(_fancy_bias, device=c_p.device)
    return torch.floor(acc * (1.0 / 16.0)).to(torch.int32)


def yuv420_patches_to_bgr_patches8(y_p: torch.Tensor, cb_p: torch.Tensor,
                                   cr_p: torch.Tensor) -> torch.Tensor:
    """Patchified 4:2:0 planes -> BGR in the ``patches8`` stem layout.

    ``y_p`` [B, H/8, W/8, 64] (k = ky*8 + kx), ``cb_p``/``cr_p``
    [B, H/8, W/8, 16] (k = cy*4 + cx).  Returns [B, H/8, W/8, 192] uint8 with
    k = ky*24 + kx*3 + c, equal to ``yuv420_to_bgr`` followed by an 8x8
    patchify, with no relayout of the frame."""
    bgr = _ycc_to_bgr(y_p, _fancy_upsample_patches(cb_p), _fancy_upsample_patches(cr_p))
    return bgr.reshape(*y_p.shape[:-1], 192)


def patchify_yuv_planes(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """Host (numpy) repack of tight 4:2:0 planes into the patchified layouts
    ``yuv420_patches_to_bgr_patches8`` takes.  Requires h, w multiples of 8."""
    b, h, w = y.shape
    yp = (y.reshape(b, h // 8, 8, w // 8, 8)
          .transpose(0, 1, 3, 2, 4).reshape(b, h // 8, w // 8, 64))
    ch, cw = cb.shape[1:]

    def chroma(c):
        return (c.reshape(b, ch // 4, 4, cw // 4, 4)
                .transpose(0, 1, 3, 2, 4).reshape(b, ch // 4, cw // 4, 16))

    return (np.ascontiguousarray(yp), np.ascontiguousarray(chroma(cb)),
            np.ascontiguousarray(chroma(cr)))


def yuv420_to_bgr(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """[..., h, w] luma + [..., ceil(h/2), ceil(w/2)] chroma -> BGR uint8
    [..., h, w, 3], byte-identical to libjpeg's BGR decode of the stream."""
    h, w = y.shape[-2], y.shape[-1]
    cb_full = _fancy_upsample_plane(cb)[..., :h, :w]
    cr_full = _fancy_upsample_plane(cr)[..., :h, :w]
    return _ycc_to_bgr(y, cb_full, cr_full)
