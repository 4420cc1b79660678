"""Distributed training: one SPMD step over a data mesh.

Counterpart of ``opencv_traffic_sign_detector_tpu/parallel/train.py``.  The
framework's "training" is closed-form (mean-mask blends, LDA fits), so the
distributed form is sufficient statistics and one reduction rather than a
gradient all-reduce:

* every shard runs the whole proposal pipeline on its frames (MSER ->
  crops -> HOG features) and labels its proposals from its frames' GT boxes
  by IoU (positives keep the GT super-type, low-IoU proposals are
  background: the reference's negative-mining rule);
* per-class statistics (counts, feature sums, second moments) are summed
  over every shard of every rank (:func:`.mesh.psum`);
* the small (324-dim) Gaussian-LDA system is solved once from the totals.

Products and the solve are f32 without TF32 on the card
(``models.detector.full_f32_matmuls``), as the reference computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MSERConfig
from ..constants import NEGATIVE_IOU_MAX
from ..models.detector import full_f32_matmuls
from ..models.lda import LDAParams
from ..ops.color import bgr_to_gray
from ..ops.geometry import filter_and_grow_boxes, iou_matrix
from ..ops.hog import hog_descriptors
from ..ops.mser import mser_regions
from ..ops.preprocess import enhance_contrast
from ..ops.resize import crop_and_resize
from .mesh import device_scope, psum, rank_slice, shard_batch

N_CLASSES = 7


def _class_statistics(feats: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                      n_classes: int = N_CLASSES):
    """Per-class statistics of [N, D] features: counts [C], sums [C, D] and
    second moments [C, D, D]."""
    classes = torch.arange(n_classes, device=labels.device)
    onehot = (labels[:, None] == classes[None, :]).to(feats.dtype) * weights[:, None]
    counts = onehot.sum(dim=0)
    sums = onehot.T @ feats
    sq = torch.matmul((onehot.T[:, :, None] * feats[None]).transpose(1, 2), feats)
    return counts, sums, sq


def lda_from_statistics(counts: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor,
                        eps: float = 1e-6):
    """Closed-form Gaussian LDA from summed statistics -> (coef [C, D],
    intercept [C]): the pooled within-class covariance with the (n - C)
    normalisation; the ridge ``eps`` keeps the solve well-posed on shards
    without some class."""
    n = counts.sum()
    c, d = sums.shape
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    sw = sq.sum(dim=0) - torch.einsum("c,cd,ce->de", counts, means, means)
    cov = sw / torch.clamp(n - c, min=1.0) + eps * torch.eye(d, dtype=sums.dtype,
                                                              device=sums.device)
    icov_means = torch.linalg.solve(cov, means.T).T  # [C, D]
    priors = torch.clamp(counts, min=1e-6) / torch.clamp(n, min=1.0)
    intercept = -0.5 * (means * icov_means).sum(dim=1) + torch.log(priors)
    return icov_means, intercept


def _propose_and_label(frames: torch.Tensor, gt_boxes: torch.Tensor, gt_types: torch.Tensor,
                       cfg: MSERConfig, grow: float, crop: int):
    """[B, H, W, 3] frames -> (features [B, N, D], labels [B, N], weights
    [B, N]).  The reference jits this: the crops' sample step multiplies by
    the reciprocal of ``crop`` (``crop_and_resize``'s default)."""
    gray = enhance_contrast(frames)
    props, pvalid = mser_regions(gray, cfg)
    boxes, keep = filter_and_grow_boxes(props, pvalid, grow)
    crops = bgr_to_gray(crop_and_resize(frames, boxes, crop))
    b, n = keep.shape
    feats = hog_descriptors(crops.reshape(b * n, crop, crop)).reshape(b, n, -1)

    gt_valid = gt_types > 0
    ious = torch.stack([iou_matrix(boxes[i], gt_boxes[i]) for i in range(b)])  # [B, N, G]
    ious = torch.where(gt_valid[:, None, :], ious, -1.0)
    best = torch.argmax(ious, dim=-1)
    best_iou = torch.amax(ious, dim=-1)
    labels = torch.where(best_iou > NEGATIVE_IOU_MAX, torch.gather(gt_types, 1, best), 0)
    return feats, labels.to(torch.int32), keep.to(feats.dtype)


def distributed_train_step(mesh, cfg: MSERConfig, grow: float = 1.15, crop: int = 32):
    """The SPMD train step over ``mesh``.

    Returned fn: (frames, gt_boxes [b, G, 4], gt_types [b, G]), each a list
    of one tensor a shard (:func:`.mesh.shard_batch`) -> (coef [7, D],
    intercept [7], class_counts [7]) from the statistics of every shard, on
    the mesh's first device.
    """

    def step(frames, gt_boxes, gt_types):
        full_f32_matmuls()
        stats = []
        for dev, f, gb, gt in zip(mesh.devices, frames, gt_boxes, gt_types):
            with device_scope(dev):
                feats, labels, weights = _propose_and_label(f, gb, gt, cfg, grow, crop)
                d = feats.shape[-1]
                stats.append(_class_statistics(feats.reshape(-1, d), labels.reshape(-1),
                                               weights.reshape(-1)))
        counts, sums, sq = (psum(mesh, list(s)) for s in zip(*stats))
        coef, intercept = lda_from_statistics(counts, sums, sq)
        return coef, intercept, counts

    return step


def distributed_lda_fit(mesh, n_classes: int = N_CLASSES):
    """Sharded-features LDA fit: (X, y, w), each a list of one [n, ...]
    tensor a shard -> (coef, intercept) from the statistics of every shard,
    on the mesh's first device."""

    def fit(X, y, w):
        full_f32_matmuls()
        stats = []
        for dev, xs, ys, ws in zip(mesh.devices, X, y, w):
            with device_scope(dev):
                stats.append(_class_statistics(xs, ys, ws, n_classes))
        counts, sums, sq = (psum(mesh, list(s)) for s in zip(*stats))
        return lda_from_statistics(counts, sums, sq)

    return fit


def _pad_to_multiple(arrs, weights, k: int):
    """Pad N-leading arrays (+ weights with 0) so N % k == 0."""
    n = len(weights)
    pad = (-n) % k
    if pad == 0:
        return arrs, weights
    out = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrs]
    w = np.concatenate([weights, np.zeros(pad, weights.dtype)])
    return out, w


def fit_classifier_distributed(features_by_class, config, mesh):
    """The product-path classifier fit (LDABAYES heads) over ``mesh``.

    The training sets of ``models.recognizer.fit_classifier`` (per type, its
    positives with every mined negative, binary labels), each head fit from
    the summed statistics of its descriptor matrix sharded over the mesh:
    every rank holds the whole matrix and feeds its part to its shards.
    The heads carry zero ``xbar`` and ``scalings``: they only ever run
    ``lda_decision``/``lda_predict_proba``, never ``lda_transform``; the
    KNN path needs the transform and keeps the host fit.
    """
    from ..models.recognizer import SignClassifier, fit_classifier

    if config.classifier != "LDABAYES":
        return fit_classifier(features_by_class, config)

    fit = distributed_lda_fit(mesh, n_classes=2)
    negatives = features_by_class[0]
    d = negatives.shape[1] if len(negatives) else 324
    heads: list = []
    for t in range(1, 7):
        pos = features_by_class[t]
        if len(pos) == 0:
            heads.append(None)
            continue
        X = np.concatenate([negatives, pos]).astype(np.float32)
        y = np.concatenate([np.zeros(len(negatives), np.int32), np.ones(len(pos), np.int32)])
        w = np.ones(len(y), np.float32)
        (X, y), w = _pad_to_multiple([X, y], w, mesh.shards)
        coef, intercept = fit(*(shard_batch(mesh, rank_slice(mesh, a)) for a in (X, y, w)))
        heads.append(LDAParams(
            classes=np.array([0, t]),
            xbar=np.zeros(d, np.float32),
            scalings=np.zeros((d, 1), np.float32),
            coef=coef.cpu().numpy().astype(np.float32),
            intercept=intercept.cpu().numpy().astype(np.float32),
        ))
    return SignClassifier(config=config, heads=heads)
