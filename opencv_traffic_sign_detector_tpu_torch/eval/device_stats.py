"""Detection statistics on the device, totals reduced over a data mesh.

Counterpart of ``opencv_traffic_sign_detector_tpu/eval/device_stats.py``.
The host engine (:mod:`.stats`) is the parity-exact scorer; this is its
batched tensor form for large runs: padded per-frame detections and ground
truth are matched on the device (a detection is correct iff its best
same-type GT in the frame scores > 0.85 on the corner-sigmoid geometric
mean; a GT counts as detected iff some correct detection chose it as its
best match) and the per-type counts go through one :func:`..parallel.mesh.
psum` a total.  The reference's greedy loop marks GTs "seen" but still
counts re-matches as correct, so each detection's correctness stands alone,
as here.
"""

from __future__ import annotations

import torch

from ..constants import STATS_MATCH_TOL
from ..ops.geometry import boxes_match_score
from ..ops.resident import const_f32
from ..parallel.mesh import device_scope, psum

N_TYPES = 6


def frame_type_counts(det_boxes: torch.Tensor, det_types: torch.Tensor,
                      det_valid: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_types: torch.Tensor):
    """Frames -> (correct, incorrect, missed) per type, each [..., 6] int32.

    det_boxes [..., D, 4] xyxy, det_types [..., D] (1..6), det_valid
    [..., D] bool, gt_boxes [..., G, 4], gt_types [..., G] (0 or -1: an
    unused slot); any leading frame dims.  A detection's best GT is the
    first of the highest score, as ``jnp.argmax`` picks it.
    """
    scores = boxes_match_score(det_boxes, gt_boxes)  # [..., D, G]
    gt_alive = gt_types > 0
    same_type = det_types[..., :, None] == gt_types[..., None, :]
    eligible = same_type & gt_alive[..., None, :] & det_valid[..., :, None]
    eff = torch.where(eligible, scores, const_f32(float("-inf"), scores.device))
    # one -inf column past the last GT: the max of a frame without GT slots
    eff = torch.cat([eff, eff.new_full(eff.shape[:-1] + (1,), float("-inf"))], dim=-1)
    best_gt = torch.argmax(eff, dim=-1)
    best_score = torch.amax(eff, dim=-1)
    det_correct = det_valid & (best_score > const_f32(STATS_MATCH_TOL, scores.device))

    # a GT is detected iff it is some correct detection's best match
    chosen = torch.zeros(eff.shape[:-2] + eff.shape[-1:], dtype=torch.int32,
                         device=eff.device)
    chosen = chosen.scatter_reduce(-1, best_gt, det_correct.to(torch.int32), "amax")
    chosen = chosen[..., :-1] > 0

    types = torch.arange(1, N_TYPES + 1, device=det_types.device)
    det_of_type = det_valid[..., None] & (det_types[..., None] == types)  # [..., D, 6]
    correct = (det_of_type & det_correct[..., None]).sum(dim=-2)
    incorrect = (det_of_type & ~det_correct[..., None]).sum(dim=-2)
    gt_of_type = gt_alive[..., None] & (gt_types[..., None] == types)
    missed = (gt_of_type & ~chosen[..., None]).sum(dim=-2)
    return correct.to(torch.int32), incorrect.to(torch.int32), missed.to(torch.int32)


def distributed_statistics(mesh):
    """The mesh-wide scorer.

    fn: (det_boxes, det_types, det_valid, gt_boxes, gt_types), each a list
    of one [b, ...] tensor a shard (:func:`..parallel.mesh.shard_batch`)
    -> (correct [6], incorrect [6], missed [6]) int64 totals over every
    shard of every rank, on the mesh's first device.
    """

    def score(db, dt, dv, gb, gt):
        parts = []
        for dev, *frames in zip(mesh.devices, db, dt, dv, gb, gt):
            with device_scope(dev):
                counts = frame_type_counts(*frames)
                parts.append(torch.stack([c.sum(dim=0, dtype=torch.int64) for c in counts]))
        c, i, m = psum(mesh, parts)
        return c, i, m

    return score
