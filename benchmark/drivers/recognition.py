"""The recognition family: the program's ``RecognitionPipeline`` on one card,
built as ``main_recognition_torch.py: _run_test`` builds it, and the plain
reference that judges its records.

Entry: ``models/rec_pipeline.py: RecognitionPipeline.dispatch`` (the frames
pinned, copied into the graph's input, the captured ``recognize_batch``
replayed, the packed records copied back), then ``collect``.  There is no
eager stage split: the stages are read from the program's tracer.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..reference import recognition as ref

REPO = Path(__file__).resolve().parents[2]


class Program:
    """The system under test, built from the configuration file."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
        from opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline import (
            RecognitionPipeline,
        )
        from opencv_traffic_sign_detector_tpu_torch.models.recognizer import SignClassifier

        mser = MSERConfig(**{f.name: config[f.name] for f in dataclasses.fields(MSERConfig)})
        clf = SignClassifier.load(str(REPO / config["classifier"]))
        width = {h.coef.shape[-1] for h in clf.heads if h is not None}
        if clf.config.features != "HOG" or width != {ref.HOG_DIM}:
            raise ValueError(f"{config['classifier']}: features {clf.config.features} of "
                             f"width {width}, not HOG's {ref.HOG_DIM}")
        cfg = PipelineConfig(mser=mser, no_sign_tol=config["no_sign_tol"],
                             rec_grows=tuple(config["rec_grows"]), batch_size=traffic["batch"],
                             max_detections=config["max_detections"])
        self.pipe = RecognitionPipeline(cfg=cfg, classifier=clf, device=device)
        self.names = [str(i) for i in range(traffic["batch"])]

    def dispatch(self, batch):
        return self.pipe.dispatch(batch)

    def collect(self, handle) -> list[list[tuple]]:
        by_name = {n: [] for n in self.names}
        for d in self.pipe.collect(handle, self.names):
            by_name[d.filename].append((d.x1, d.y1, d.x2, d.y2, d.class_id, d.score))
        return [by_name[n] for n in self.names]

    def close(self) -> None:
        del self.pipe


class Reference:
    """The plain reference, in the configuration's precision or (``control``)
    with HOG's contraction and the heads' product in TF32."""

    def __init__(self, config: dict, traffic: dict, device: str, control: bool = False):
        self.coefs, self.ints = ref.load_heads(str(REPO / config["classifier"]), device)
        self.params = ref.Params.from_config(config)
        self.device, self.control = device, control

    def records(self, batch) -> list[list[tuple]]:
        frames = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        with torch.no_grad():
            return ref.recognize(frames, self.coefs, self.ints, self.params, tf32=self.control)


def numbers(config: dict, traffic: dict, frames: dict, refs: dict) -> tuple[dict, int]:
    """``frames_differing``: frames whose records' boxes, labels or order are
    not exactly the reference's; ``score_gap``: the largest |score - the
    reference's score| over the records of the other frames.  -> (those
    numbers, the frames, with their repeats, past a limit)."""
    limits = config["limits"]
    differing, gap, failed = 0, 0.0, 0
    for (k, i, got), n in frames.items():
        want = refs[k][i]
        if [r[:5] for r in got] != [r[:5] for r in want]:
            differing += n
            failed += n
            continue
        own = max((abs(a[5] - b[5]) for a, b in zip(got, want)), default=0.0)
        gap = max(gap, own)
        failed += n if own > limits["score_gap"] else 0
    return {"frames_differing": differing, "score_gap": gap}, failed
