"""resultado.txt serialization — the cross-framework parity artifact (the
port's own copy of ``opencv_traffic_sign_detector_tpu/utils/serialization.py``).

One line per kept detection:

    <filename>;<x1>;<y1>;<x2>;<y2>;<superType>;<score>

This is the exact format consumed by the instructor scoring script's loader
(`Reconocimiento de Objetos/evaluar_resultados.py:146-194`) and produced by
the reference (`Deteción de Objetos/source.py:501-508,740-745`).
"""

from __future__ import annotations

from ..data.gt import GroundTruthBox


def _fmt_score(score: float) -> str:
    # The reference writes Python's repr of a round(x, 2) float ("0.6", "0.98").
    return repr(round(float(score), 2))


def detections_to_lines(detections: list[GroundTruthBox]) -> list[str]:
    return [
        f"{d.filename};{d.x1};{d.y1};{d.x2};{d.y2};{d.class_id};{_fmt_score(d.score)}"
        for d in detections
    ]


def write_results_file(path: str, detections: list[GroundTruthBox]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for line in detections_to_lines(detections):
            f.write(line + "\n")
