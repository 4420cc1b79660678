"""Built-in detection statistics (the Práctica-1 console report; the port's
own copy of ``opencv_traffic_sign_detector_tpu/eval/stats.py``).

Per-file, per-super-type greedy matching of detections to ground truth using
the geometric mean of corner-wise sigmoid Euclidean similarities, threshold
0.85.  Accumulates correct / incorrect / non-detected per type and in total,
with precision ("PRECISIÓN"), recall ("TASA DE ACIERTO") and F1
("PUNTUACIÓN").

Behavioral parity notes (reference `Deteción de Objetos/source.py:267-498`):

* a detection is "correct" when its best-matching same-type GT in the same
  frame scores > 0.85; the GT is then marked as seen.  The reference never
  actually emits its "duplicated" outcome (the branch at source.py:447 is
  shadowed by the identical condition at :444), so a second detection
  matching an already-seen GT also counts "correct" — we reproduce that.
* non-detected = GT boxes of that type never marked seen.
* zero-denominator metrics print "NaN" (string), reproduced via math.nan.
"""

from __future__ import annotations

import dataclasses
import math

from ..constants import SIGN_TYPES, STATS_MATCH_TOL
from ..data.gt import GroundTruthBox, load_ground_truth


def sigmoid_distance_similarity(ax, ay, bx, by) -> float:
    """Sigmoid-shaped closeness score in (0, 1]; 1 at zero distance.

    Same curve as the reference's hand-tuned EuclDSimilarity
    (`Deteción de Objetos/source.py:459-462`).
    """
    d = math.hypot(float(ax) - float(bx), float(ay) - float(by))
    if d == 0.0:
        return 1.0
    return 1.0 / (1.0 + math.exp((0.154 * d**1.2 - 31.8) / (0.2 * d)))


def box_match_score(det: tuple, gt: tuple) -> float:
    """Geometric mean of the two corner similarities between two xyxy boxes."""
    s1 = sigmoid_distance_similarity(det[0], det[1], gt[0], gt[1])
    s2 = sigmoid_distance_similarity(det[2], det[3], gt[2], gt[3])
    return math.sqrt(s1 * s2)


@dataclasses.dataclass
class TypeCounts:
    correct: int = 0
    incorrect: int = 0
    non_detected: int = 0
    expected: int = 0

    @property
    def precision(self) -> float:
        tp, fp = self.correct, self.incorrect
        return round(tp / (tp + fp), 2) if (tp > 0 or fp > 0) else math.nan

    @property
    def recall(self) -> float:
        tp, fn = self.correct, self.non_detected
        return round(tp / (tp + fn), 2) if (tp > 0 or fn > 0) else math.nan

    @property
    def f1(self) -> float:
        tp, fp, fn = self.correct, self.incorrect, self.non_detected
        if tp > 0 or fp > 0 or fn > 0:
            return round(2 * tp / (2 * tp + fp + fn), 2)
        return math.nan

    def __iadd__(self, other: "TypeCounts") -> "TypeCounts":
        self.correct += other.correct
        self.incorrect += other.incorrect
        self.non_detected += other.non_detected
        self.expected += other.expected
        return self


@dataclasses.dataclass
class DetectionStats:
    per_file: dict[str, dict[str, TypeCounts]]
    per_type: dict[str, TypeCounts]
    total: TypeCounts


def _match_one_type(dets: list, gts: list) -> TypeCounts:
    """Greedy matching of one frame's detections of one type to its GTs."""
    c = TypeCounts(expected=len(gts))
    if dets and gts:
        seen: set[int] = set()
        for det in dets:
            best, best_j = -math.inf, -1
            for j, gt in enumerate(gts):
                s = box_match_score(det, gt)
                if s > best:
                    best, best_j = s, j
            if best > STATS_MATCH_TOL:
                seen.add(best_j)
                c.correct += 1
            else:
                c.incorrect += 1
        c.non_detected = len(gts) - len(seen)
    elif gts:
        c.non_detected = len(gts)
    elif dets:
        c.incorrect = len(dets)
    return c


def compute_detection_statistics(
    detections: list[GroundTruthBox],
    gt: list[GroundTruthBox] | str,
    frame_names: list[str] | None = None,
    unmapped_as_type6: bool = True,
) -> DetectionStats:
    """Score final detections against ground truth, reference-style.

    ``gt`` may be a parsed box list or a path to gt.txt.  ``frame_names``
    optionally fixes the set/order of frames reported (defaults to all frames
    present in either input).

    ``unmapped_as_type6`` reproduces a reference quirk: its per-type bucketing
    (`Deteción de Objetos/source.py:382-399`) routes any class that is not
    1..5 — including GT rows whose raw GTSRB id has no super-type, i.e. our
    class -1 — into the final ``direccionObligatoria`` bucket, so unmapped GT
    boxes count toward that type's expected/non-detected totals.  Set it
    False for the cleaner protocol that excludes ignore regions.
    """
    if isinstance(gt, str):
        gt = load_ground_truth(gt)
    if unmapped_as_type6:
        gt = [
            dataclasses.replace(g, class_id=6) if g.class_id == -1 else g
            for g in gt
        ]
    else:
        gt = [g for g in gt if g.class_id != -1]

    def stem(n: str) -> str:
        return n.split(".", 1)[0]

    if frame_names is None:
        frame_names = sorted(
            {stem(b.filename) for b in detections} | {stem(b.filename) for b in gt}
        )
    else:
        frame_names = [stem(n) for n in frame_names]

    det_by_frame: dict[str, list[GroundTruthBox]] = {}
    for d in detections:
        det_by_frame.setdefault(stem(d.filename), []).append(d)
    gt_by_frame: dict[str, list[GroundTruthBox]] = {}
    for g in gt:
        gt_by_frame.setdefault(stem(g.filename), []).append(g)

    per_file: dict[str, dict[str, TypeCounts]] = {}
    per_type = {t: TypeCounts() for t in SIGN_TYPES}

    for frame in frame_names:
        frame_counts: dict[str, TypeCounts] = {}
        f_dets = det_by_frame.get(frame, [])
        f_gts = gt_by_frame.get(frame, [])
        for ti, tname in enumerate(SIGN_TYPES, start=1):
            dets_t = [
                (d.x1, d.y1, d.x2, d.y2) for d in f_dets if d.class_id == ti
            ]
            gts_t = [(g.x1, g.y1, g.x2, g.y2) for g in f_gts if g.class_id == ti]
            counts = _match_one_type(dets_t, gts_t)
            frame_counts[tname] = counts
            per_type[tname] += counts
        per_file[frame] = frame_counts

    total = TypeCounts()
    for counts in per_type.values():
        total += counts
    return DetectionStats(per_file=per_file, per_type=per_type, total=total)


def format_stats_report(stats: DetectionStats, per_file: bool = False) -> str:
    """Human-readable report mirroring the reference's three-level printout."""
    lines: list[str] = []

    def fmt(v) -> str:
        return "NaN" if isinstance(v, float) and math.isnan(v) else str(v)

    def block(title: str, c: TypeCounts, indent: str = "") -> None:
        lines.append(f"{indent}{title}")
        lines.append(f"{indent}  correct:      {c.correct}")
        lines.append(f"{indent}  incorrect:    {c.incorrect}")
        lines.append(f"{indent}  non-detected: {c.non_detected}")
        lines.append(f"{indent}  expected:     {c.expected}")
        lines.append(f"{indent}  precision:    {fmt(c.precision)}")
        lines.append(f"{indent}  recall:       {fmt(c.recall)}")
        lines.append(f"{indent}  f1:           {fmt(c.f1)}")

    if per_file:
        lines.append("== per-frame detections ==")
        for frame, counts in stats.per_file.items():
            agg = TypeCounts()
            for c in counts.values():
                agg += c
            block(frame, agg)
    lines.append("== per-type detections ==")
    for tname, c in stats.per_type.items():
        block(tname, c)
    lines.append("== totals ==")
    block("all types", stats.total)
    return "\n".join(lines)
