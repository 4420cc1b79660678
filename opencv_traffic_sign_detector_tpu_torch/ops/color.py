"""Color-space ops with OpenCV-exact uint8 fixed-point semantics.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/color.py`` on
channel-last tensors with any leading batch dims.  Integer math only, in
int32: torch's uint8 arithmetic wraps, so every input is widened before the
first operation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    BLUE_BAND,
    RED_HIGH_BAND,
    RED_LOW_BAND,
)
from .resident import const_f32, resident

_HSV_SHIFT = 12


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BGR uint8 [..., 3] -> gray uint8 [...]: (R*9798 + G*19235 + B*3735 +
    2^14) >> 15."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
    return y.to(torch.uint8)


def bgr_to_hsv(bgr: torch.Tensor) -> torch.Tensor:
    """BGR uint8 [..., 3] -> HSV uint8 [..., 3], H in [0, 179].

    The fixed-point reciprocal tables are evaluated as f32 divisions, which
    round exactly like the tables (see the reference module's proof).
    """
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn

    dev = bgr.device
    one, zero = const_f32(1.0, dev), const_f32(0.0, dev)
    sdiv_v = torch.where(
        v > 0,
        torch.round(const_f32(float(255 << _HSV_SHIFT), dev)
                    / torch.maximum(v.to(torch.float32), one)),
        zero,
    ).to(torch.int32)
    hdiv_d = torch.where(
        diff > 0,
        torch.round(const_f32(float(180 << _HSV_SHIFT) / 6.0, dev)
                    / torch.maximum(diff.to(torch.float32), one)),
        zero,
    ).to(torch.int32)
    s = (diff * sdiv_v + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT

    # hue numerator: priority V==R, then V==G, then V==B (OpenCV)
    is_r = v == r
    is_g = (v == g) & ~is_r
    numer = torch.where(is_r, g - b, torch.where(is_g, b - r + 2 * diff, r - g + 4 * diff))
    h = (numer * hdiv_d + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def _in_range(hsv: torch.Tensor, lo: tuple, hi: tuple) -> torch.Tensor:
    x = hsv.to(torch.int32)
    ok = torch.ones(hsv.shape[:-1], dtype=torch.bool, device=hsv.device)
    for c in range(3):
        ok &= (x[..., c] >= lo[c]) & (x[..., c] <= hi[c])
    return ok


def color_mask(bgr: torch.Tensor, color: str) -> torch.Tensor:
    """Red/blue HSV threshold mask -> uint8 {0, 255} [...]."""
    hsv = bgr_to_hsv(bgr)
    if color == "r":
        m = _in_range(hsv, *RED_LOW_BAND) | _in_range(hsv, *RED_HIGH_BAND)
    elif color == "b":
        m = _in_range(hsv, *BLUE_BAND)
    else:
        raise ValueError(f"color must be 'r' or 'b', got {color!r}")
    return m.to(torch.uint8) * 255


def gamma_lut(gamma: float) -> np.ndarray:
    """256-entry uint8 gamma table with the reference's truncation."""
    i = np.arange(256, dtype=np.float64)
    table = ((i / 255.0) ** (1.0 / gamma)) * 255.0
    return table.astype(np.uint8)


def gamma_correct(img: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """Apply the uint8 gamma LUT elementwise (cv2.LUT equivalent).

    For gamma 2 the table is floor(sqrt(255*i)), which one correctly rounded
    f32 sqrt evaluates exactly; other gammas index the table.
    """
    if float(gamma) == 2.0:
        y = torch.sqrt(img.to(torch.float32) * const_f32(255.0, img.device))
        return y.to(torch.uint8)  # truncates toward zero, y >= 0
    return resident(gamma_lut, float(gamma), device=img.device)[img.long()]
