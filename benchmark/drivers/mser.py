"""The MSER family: the program's ``DetectionPipeline`` on one card, and the
plain reference that judges its records.

Entry: ``models/detector.py: DetectionPipeline.dispatch`` (the frames
pinned and copied into the graph's input, the captured ``detect_batch``
replayed, the packed records copied back), then ``collect``.  With a stage
timer set the same dispatch runs eagerly, the stages between CUDA events
(``ops/mser.py: stage_scope``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..compare import mser_numbers
from ..reference import mser as ref

REPO = Path(__file__).resolve().parents[2]


def _records(dets, names: list[str]) -> list[list[tuple]]:
    by_name = {n: [] for n in names}
    for d in dets:
        by_name[d.filename].append((d.x1, d.y1, d.x2, d.y2, d.class_id, d.score))
    return [by_name[n] for n in names]


class Program:
    """The system under test, built from the configuration file."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
        from opencv_traffic_sign_detector_tpu_torch.models.detector import DetectionPipeline
        from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import MeanMaskTemplates

        mser = MSERConfig(**{f.name: config[f.name] for f in dataclasses.fields(MSERConfig)})
        cfg = PipelineConfig(mser=mser, batch_size=traffic["batch"],
                             max_detections=config["max_detections"],
                             mask_corr_tol=config["mask_corr_tol"],
                             fine_scores=config["fine_scores"])
        self.pipe = DetectionPipeline(cfg, MeanMaskTemplates.load(str(REPO / config["templates"])),
                                      device=device)
        self.names = [str(i) for i in range(traffic["batch"])]

    def dispatch(self, batch):
        return self.pipe.dispatch(batch)

    def collect(self, handle) -> list[list[tuple]]:
        return _records(self.pipe.collect(handle, self.names), self.names)

    def stage_split(self, pool: list, batches: int, tally) -> dict[str, float]:
        """Eager dispatches under the stage timer, one batch at a time, their
        records into ``tally``: -> {stage: ms a batch}."""
        from ..timing import StageTimer

        self.pipe.timer = StageTimer()
        try:
            self.collect(self.dispatch(pool[0]))  # the eager path's own first use
            timer = self.pipe.timer = StageTimer()
            for i in range(batches):
                tally.add(i % len(pool), self.collect(self.dispatch(pool[i % len(pool)])))
            return timer.per_batch_ms(batches)
        finally:
            self.pipe.timer = None

    def close(self) -> None:
        del self.pipe


class Reference:
    """The plain reference, in the configuration's precision or (``control``)
    with TF32 on for its float32 products."""

    def __init__(self, config: dict, traffic: dict, device: str, control: bool = False):
        with np.load(REPO / config["templates"]) as z:
            self.red = torch.from_numpy(np.asarray(z["red"], np.float32)).to(device)
            self.blue = torch.from_numpy(np.asarray(z["blue"], np.float32)).to(device)
        self.params = ref.Params.from_config(config)
        self.device, self.control = device, control

    def records(self, batch) -> list[list[tuple]]:
        frames = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        with torch.no_grad():
            return ref.detect(frames, self.red, self.blue, self.params, tf32=self.control)


def numbers(config: dict, traffic: dict, frames: dict, refs: dict) -> tuple[dict, int]:
    """The compared numbers and the frames that failed (``compare.py``)."""
    return mser_numbers(frames, refs)
