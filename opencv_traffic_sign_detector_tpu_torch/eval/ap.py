"""PASCAL-style detection scoring: PR curve, VOC AP, 11-point AP (the
port's own copy of ``opencv_traffic_sign_detector_tpu/eval/ap.py``).

Implements the same evaluation protocol as the instructor scoring script so
that results are directly comparable:

* class-agnostic greedy matching of score-sorted detections to ground truth
  at overlap > ovr (default 0.5), each GT matchable once;
* "ignore" regions (class_id == -1): a detection overlapping an ignore GT is
  neither TP nor FP, and overlap is normalised by detection area only;
* exact area-under-envelope AP (VOC) and 11-point interpolated AP.

Parity contract: `Reconocimiento de Objetos/evaluar_resultados.py:52-88`
(overlap), `:199-276` (matching), `:279-299` (AP).  All boxes use the
inclusive +1 pixel area convention.
"""

from __future__ import annotations

import numpy as np

from ..data.gt import GroundTruthBox, boxes_by_file, load_ground_truth, load_results_file


def bbox_overlap(gt: GroundTruthBox, det: GroundTruthBox, ignore: bool) -> float:
    """Overlap of det with gt; if ``ignore``, normalised by det area only."""
    w = min(det.x2, gt.x2) - max(det.x1, gt.x1)
    if w <= 0:
        return 0.0
    h = min(det.y2, gt.y2) - max(det.y1, gt.y1)
    if h <= 0:
        return 0.0
    inter = w * h
    denom = det.area if ignore else det.area + gt.area - inter
    return inter / denom


def precision_recall_curve(
    gt_boxes: list[GroundTruthBox],
    det_boxes: list[GroundTruthBox],
    ovr: float = 0.5,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Greedy score-sorted matching. Returns (tp, fp, thresholds, n_gt).

    A detection whose best-overlap GT is an ignore region (class -1) counts as
    neither TP nor FP.  A second detection on an already-matched GT is FP.
    """
    gt_by_file = boxes_by_file(gt_boxes)
    n_gt = sum(1 for b in gt_boxes if b.class_id != -1)

    # Stable sort by descending score over the filename-grouped concatenation,
    # so equal-score ties resolve in sorted-filename order (this matches the
    # instructor protocol's det_list construction and makes AP deterministic).
    det_groups = boxes_by_file(det_boxes)
    dets = [b for fname in sorted(det_groups) for b in det_groups[fname]]
    dets.sort(key=lambda b: -b.score)
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    thr = np.zeros(len(dets))
    matched: dict[tuple[str, int], bool] = {}

    for i, det in enumerate(dets):
        thr[i] = det.score
        best_ovr, best_j = 0.0, -1
        candidates = gt_by_file.get(det.filename, [])
        for j, gt in enumerate(candidates):
            o = bbox_overlap(gt, det, ignore=(gt.class_id == -1))
            if o >= best_ovr:
                best_ovr, best_j = o, j
        if best_ovr > ovr and best_j >= 0:
            gt = candidates[best_j]
            if gt.class_id == -1:
                continue  # ignore region: neither TP nor FP
            key = (det.filename, best_j)
            if not matched.get(key):
                matched[key] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1

    return tp, fp, thr, n_gt


def average_precision_voc(rec: np.ndarray, prec: np.ndarray) -> float:
    """Exact area under the monotone precision envelope."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def average_precision_11pt(rec: np.ndarray, prec: np.ndarray) -> float:
    """11-point interpolated AP."""
    rec = np.asarray(rec)
    prec = np.asarray(prec)
    ap = 0.0
    for t in np.linspace(0.0, 1.0, 11):
        p = prec[rec >= t]
        ap += (float(np.max(p)) if p.size else 0.0) / 11.0
    return ap


def pr_from_tp_fp(
    tp: np.ndarray, fp: np.ndarray, n_gt: int
) -> tuple[np.ndarray, np.ndarray, float, float]:
    """Cumulate per-detection tp/fp into (recall, precision, AP, AP11)."""
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    rec = ctp / max(n_gt, 1)
    denom = np.maximum(ctp + cfp, 1e-12)
    prec = ctp / denom
    return rec, prec, average_precision_voc(rec, prec), average_precision_11pt(rec, prec)


def score_detection_files(
    detections_path: str, gt_path: str, ovr: float = 0.5
) -> dict:
    """Convenience: AP metrics for a resultado.txt against a gt.txt."""
    gt = load_ground_truth(gt_path)
    det = load_results_file(detections_path)
    tp, fp, _thr, n_gt = precision_recall_curve(gt, det, ovr=ovr)
    rec, prec, ap, ap11 = pr_from_tp_fp(tp, fp, n_gt)
    return {
        "ap": ap,
        "ap_11pt": ap11,
        "n_gt": n_gt,
        "n_det": len(det),
        "recall": rec,
        "precision": prec,
    }
