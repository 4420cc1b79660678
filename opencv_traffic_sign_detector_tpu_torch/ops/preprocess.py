"""The detector's contrast-enhancement chain: gray -> CLAHE(clip 2) ->
Gaussian 3x3 -> gamma LUT (gamma 2).

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/preprocess.py``.
"""

from __future__ import annotations

import torch

from .blur import gaussian_blur_3x3
from .clahe import clahe_equalize
from .color import bgr_to_gray, gamma_correct


def enhance_contrast(bgr: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """BGR uint8 [..., H, W, 3] -> enhanced gray uint8 [..., H, W]."""
    return enhance_gray(bgr_to_gray(bgr), gamma)


def enhance_gray(gray: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """The same chain on an already-gray frame (any resolution)."""
    eq = clahe_equalize(gray, clip_limit=2.0, tiles=8)
    return gamma_correct(gaussian_blur_3x3(eq), gamma)
