"""3x3 Gaussian blur on uint8 with OpenCV-exact integer arithmetic.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/blur.py``: the
separable [1,2,1]/4 kernel, BORDER_REFLECT_101 edges, +8 rounding bias.
"""

from __future__ import annotations

import torch

from .clahe import reflect101_index


def gaussian_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """Blur uint8 [..., H, W] with the separable [1,2,1]/4 kernel."""
    h, w = img.shape[-2:]
    rows = reflect101_index(h, 1, 1, img.device)
    cols = reflect101_index(w, 1, 1, img.device)
    x = img.to(torch.int32)[..., rows, :][..., cols]
    horiz = x[..., :-2] + 2 * x[..., 1:-1] + x[..., 2:]
    total = horiz[..., :-2, :] + 2 * horiz[..., 1:-1, :] + horiz[..., 2:, :]
    return ((total + 8) >> 4).to(torch.uint8)
