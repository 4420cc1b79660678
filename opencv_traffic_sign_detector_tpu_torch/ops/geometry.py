"""Box geometry: aspect filter + grow, pairwise corner similarity, the
statistics' match score, IoU.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/geometry.py``, with
the same f32 operation order.  Every function takes any leading batch dims.
"""

from __future__ import annotations

import torch

from ..constants import ASPECT_MAX, ASPECT_MIN
from .resident import const_f32


def filter_and_grow_boxes(boxes_xywh: torch.Tensor, valid: torch.Tensor,
                          grow: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep ASPECT_MIN < w/h < ASPECT_MAX, grow by ``grow`` about the centre,
    clamp at 0, truncate.  -> (boxes_xyxy int32 [..., N, 4], keep [..., N])."""
    b = boxes_xywh.to(torch.float32)
    dev = b.device
    x, y, w, h = b.unbind(-1)
    zero = const_f32(0.0, dev)
    hsafe = torch.maximum(h, const_f32(1.0, dev))
    ratio = w / hsafe
    keep = (valid & (ratio > const_f32(ASPECT_MIN, dev)) & (ratio < const_f32(ASPECT_MAX, dev))
            & (h > 0))
    g = const_f32(grow - 1.0, dev)  # in f64 first, like the reference's weak scalar
    half = const_f32(0.5, dev)
    dw = w * g * half
    dh = h * g * half
    x1 = torch.maximum(x - dw, zero)
    y1 = torch.maximum(y - dh, zero)
    x2 = torch.maximum(x + w + dw, zero)
    y2 = torch.maximum(y + h + dh, zero)
    return torch.stack([x1, y1, x2, y2], dim=-1).to(torch.int32), keep


def sigmoid_distance_similarity(d: torch.Tensor) -> torch.Tensor:
    """Distance -> closeness in (0, 1]; 1 at d == 0."""
    d = d.to(torch.float32)
    dsafe = torch.clamp(d, min=1e-20)
    z = (0.154 * dsafe ** 1.2 - 31.8) / (0.2 * dsafe)
    sim = 1.0 / (1.0 + torch.exp(z))
    return torch.where(d > 0, sim, torch.ones_like(sim))


def pairwise_coord_similarity(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] -> [..., N, N] geometric mean of corner similarities."""
    b = boxes_xyxy.to(torch.float32)
    tl, br = b[..., :2], b[..., 2:]
    d_tl = torch.linalg.vector_norm(tl[..., :, None, :] - tl[..., None, :, :], dim=-1)
    d_br = torch.linalg.vector_norm(br[..., :, None, :] - br[..., None, :, :], dim=-1)
    return torch.sqrt(sigmoid_distance_similarity(d_tl)
                      * sigmoid_distance_similarity(d_br))


def boxes_match_score(det_xyxy: torch.Tensor, gt_xyxy: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] geometric means of the
    corner-wise sigmoid similarities (the statistics' match score)."""
    d = det_xyxy.to(torch.float32)
    g = gt_xyxy.to(device=d.device, dtype=torch.float32)
    d_tl = torch.linalg.vector_norm(d[..., :, None, :2] - g[..., None, :, :2], dim=-1)
    d_br = torch.linalg.vector_norm(d[..., :, None, 2:] - g[..., None, :, 2:], dim=-1)
    return torch.sqrt(sigmoid_distance_similarity(d_tl) * sigmoid_distance_similarity(d_br))


def iou_matrix(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """[N, 4] x [M, 4] -> [N, M] f32 IoU with the inclusive +1 pixel
    convention of the recognition trainer's intersectionOverUnion."""
    a = torch.as_tensor(a_xyxy).to(torch.float32)
    b = torch.as_tensor(b_xyxy).to(device=a.device, dtype=torch.float32)
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x2 - x1 + 1, min=0) * torch.clamp(y2 - y1 + 1, min=0)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def mean_coords(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """Integer midpoint of two int boxes (floor division, like the reference)."""
    return torch.div(a_xyxy.to(torch.int32) + b_xyxy.to(torch.int32), 2, rounding_mode="floor")
