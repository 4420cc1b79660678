"""Hue/Saturation 2-D histograms and Pearson correlation of crop stacks.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/histogram.py``
(cv2.calcHist 50x60 H/S bins, NORM_MINMAX, HISTCMP_CORREL).  Every function
takes any leading batch dims.  The histogram is a product of one-hot
matrices, exact in f32; the correlation sums in another order than the
reference, so it agrees within f32 rounding (1e-5).
"""

from __future__ import annotations

import torch

from .color import bgr_to_hsv

H_BINS = 50
S_BINS = 60


def hs_histograms(crops_bgr: torch.Tensor) -> torch.Tensor:
    """[..., N, H, W, 3] BGR uint8 -> [..., N, H_BINS*S_BINS] f32 counts."""
    lead = crops_bgr.shape[:-3]
    hsv = bgr_to_hsv(crops_bgr).to(torch.int64).reshape(-1, crops_bgr.shape[-3] * crops_bgr.shape[-2], 3)
    hb = torch.clamp((hsv[..., 0] * H_BINS) // 180, 0, H_BINS - 1)
    sb = torch.clamp((hsv[..., 1] * S_BINS) // 256, 0, S_BINS - 1)
    oh_h = torch.nn.functional.one_hot(hb, H_BINS).to(torch.float32)
    oh_s = torch.nn.functional.one_hot(sb, S_BINS).to(torch.float32)
    hist = torch.bmm(oh_h.transpose(1, 2), oh_s)
    return hist.reshape(lead + (H_BINS * S_BINS,))


def minmax_normalize(hist: torch.Tensor) -> torch.Tensor:
    """Per-row NORM_MINMAX to [0, 1]; constant rows map to 0 (cv2 rule)."""
    mn = hist.amin(-1, keepdim=True)
    rng = hist.amax(-1, keepdim=True) - mn
    scale = torch.where(rng > 0, 1.0 / torch.clamp(rng, min=1e-30), torch.zeros_like(rng))
    return (hist - mn) * scale


def correlation_matrix(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise HISTCMP_CORREL over the last dim: [..., N, D] x [..., M, D]
    -> [..., N, M]; zero-variance rows correlate to 1.0 (OpenCV)."""
    if b is None:
        b = a
    ac = a - a.mean(-1, keepdim=True)
    bc = b - b.mean(-1, keepdim=True)
    num = ac @ bc.transpose(-1, -2)
    va = (ac * ac).sum(-1)
    vb = (bc * bc).sum(-1)
    den = torch.sqrt(va[..., :, None] * vb[..., None, :])
    return torch.where(den > 1e-12, num / torch.clamp(den, min=1e-30),
                       torch.ones_like(num))


def hist_correlation(crops_bgr: torch.Tensor) -> torch.Tensor:
    """All-pairs appearance similarity of crop stacks: [..., N, N] f32."""
    return correlation_matrix(minmax_normalize(hs_histograms(crops_bgr)))
