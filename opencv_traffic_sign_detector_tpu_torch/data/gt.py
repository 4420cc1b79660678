"""GTSDB ground-truth / result file parsing (the port's own copy of
``opencv_traffic_sign_detector_tpu/data/gt.py``).

File format (``;``-separated, one box per line):

    <filename>;<x1>;<y1>;<x2>;<y2>;<rawClass>            (ground truth)
    <filename>;<x1>;<y1>;<x2>;<y2>;<superType>;<score>   (detections)

Ground-truth raw classes are GTSRB ids remapped to super-types 1..6; ids
outside the six groups become -1 ("ignore region" in the PASCAL protocol).
Filenames in gt.txt use ``.ppm`` extensions while the frames on disk are
``.jpg``; we normalise to the stem + ``.jpg``.

Parity contracts: `Reconocimiento de Objetos/evaluar_resultados.py:146-194`
(loader), `Reconocimiento de Objetos/source.py:352-362` (.ppm -> .jpg and
class remap, unmapped classes dropped), `Deteción de Objetos/source.py:267-273`.
"""

from __future__ import annotations

import dataclasses
import os

from ..constants import supertype_of


@dataclasses.dataclass(frozen=True)
class GroundTruthBox:
    """One annotated box: pixel corners are inclusive ints, class may be -1."""

    filename: str
    x1: int
    y1: int
    x2: int
    y2: int
    class_id: int  # super-type 1..6, or -1 = ignore region
    score: float = 1.0

    @property
    def area(self) -> int:
        # +1 convention used throughout the PASCAL-style evaluation.
        return (self.x2 - self.x1 + 1) * (self.y2 - self.y1 + 1)


def _normalize_name(name: str) -> str:
    stem = os.path.basename(name).split(".", 1)[0]
    return stem + ".jpg"


def load_ground_truth(
    path: str,
    *,
    drop_unmapped: bool = False,
    normalize_jpg: bool = True,
) -> list[GroundTruthBox]:
    """Parse a gt.txt file.

    drop_unmapped=True reproduces the recognition trainer's behaviour of
    discarding classes outside the six super-types; otherwise they are kept
    with class_id -1 (the evaluation protocol's ignore regions).
    """
    boxes: list[GroundTruthBox] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            if len(parts) < 6:
                raise ValueError(f"malformed gt line: {line!r}")
            fname = _normalize_name(parts[0]) if normalize_jpg else parts[0]
            st = supertype_of(int(parts[5]))
            if st is None:
                if drop_unmapped:
                    continue
                st = -1
            boxes.append(
                GroundTruthBox(
                    filename=fname,
                    x1=int(parts[1]),
                    y1=int(parts[2]),
                    x2=int(parts[3]),
                    y2=int(parts[4]),
                    class_id=st,
                )
            )
    return boxes


def load_results_file(path: str) -> list[GroundTruthBox]:
    """Parse a resultado.txt-style detections file (7 columns with score)."""
    boxes: list[GroundTruthBox] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            if len(parts) != 7:
                raise ValueError(f"malformed detection line: {line!r}")
            boxes.append(
                GroundTruthBox(
                    filename=parts[0],
                    x1=int(float(parts[1])),
                    y1=int(float(parts[2])),
                    x2=int(float(parts[3])),
                    y2=int(float(parts[4])),
                    class_id=int(parts[5]),
                    score=float(parts[6]),
                )
            )
    return boxes


def boxes_by_file(boxes: list[GroundTruthBox]) -> dict[str, list[GroundTruthBox]]:
    """Group boxes by (extension-stripped) source frame filename."""
    grouped: dict[str, list[GroundTruthBox]] = {}
    for b in boxes:
        grouped.setdefault(b.filename, []).append(b)
    return grouped
