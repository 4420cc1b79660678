"""Duplicate-detection suppression as masked pairwise-matrix reductions.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/dedup.py``: the
reference's sequential fold (a later item deletes an earlier one at
similarity >= 0.8823*tol, merging when <= tol) as one upper-triangular
matrix reduction.  Every function takes any leading batch dims.
"""

from __future__ import annotations

import torch

from ..constants import DEDUP_MERGE_BAND
from .geometry import pairwise_coord_similarity
from .histogram import hist_correlation


def _dedup_from_sims(sims, crops, boxes, valid, tol: float):
    """Given [..., N, N] similarities, apply the fold contract."""
    n = sims.shape[-1]
    band_lo = DEDUP_MERGE_BAND * tol
    ar = torch.arange(n, device=sims.device)
    vv = valid[..., :, None] & valid[..., None, :]
    later = ar[:, None] > ar[None, :]  # i processed after j

    kill = vv & later & (sims >= band_lo)
    alive = valid & ~kill.any(-2)
    merge = vv & later & (sims >= band_lo) & (sims <= tol) & alive[..., :, None]
    group = merge | (torch.eye(n, dtype=torch.bool, device=sims.device) & alive[..., :, None])
    counts = torch.clamp(group.sum(-1).to(torch.float32), min=1.0)
    groupf = group.to(torch.float32)

    new_boxes = (groupf @ boxes.to(torch.float32)) / counts[..., None]
    new_boxes = torch.where(alive[..., None], new_boxes.to(torch.int32), boxes)

    lead = crops.shape[:-3]
    crops_f = crops.reshape(lead + (-1,)).to(torch.float32)
    blended = torch.round((groupf @ crops_f) / counts[..., None])
    blended = blended.to(crops.dtype).reshape(crops.shape)
    new_crops = torch.where(alive[..., None, None, None], blended, crops)
    return new_crops, new_boxes, alive


def dedup_by_histogram(crops, boxes, valid, tol: float):
    """Pass 1: appearance dedup via HS-histogram correlation of the crops."""
    return _dedup_from_sims(hist_correlation(crops), crops, boxes, valid, tol)


def dedup_by_coords(crops, boxes, valid, tol: float):
    """Pass 2: geometric dedup via corner-sigmoid similarity of the boxes."""
    return _dedup_from_sims(pairwise_coord_similarity(boxes), crops, boxes, valid, tol)
