"""Recognizer A: per-super-type mean color masks + masked-F1 scoring.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/mean_masks.py``.
The templates are the same ``[6, 625]`` red/blue {0,1} arrays in the same
``.npz`` format (keys ``red`` and ``blue``), so templates trained by either
package load in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..constants import (
    DETECT_CROP,
    MASK_CORR_TOL,
    SUPERTYPE_CLASS_DIRS,
)
from ..data.images import load_image_bgr
from ..ops.color import color_mask
from ..ops.resident import const_f32
from ..ops.resize import crop_and_resize

_PIX = DETECT_CROP * DETECT_CROP


@dataclasses.dataclass(frozen=True)
class MeanMaskTemplates:
    """Trained templates: red/blue binary masks per super-type, [6, 625]."""

    red: np.ndarray  # float32 {0,1}
    blue: np.ndarray

    def save(self, path: str) -> None:
        np.savez(path, red=self.red, blue=self.blue)

    @classmethod
    def load(cls, path: str) -> "MeanMaskTemplates":
        z = np.load(path)
        return cls(red=z["red"], blue=z["blue"])


def templates_to_torch(templates, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(red, blue) f32 [6, 625] tensors on ``device`` from templates of
    either package (anything with ``red`` and ``blue`` arrays)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return t(templates.red), t(templates.blue)


def _resize_crops_25(imgs: list[np.ndarray], device) -> torch.Tensor:
    """Resize variable-size BGR crops to 25x25 in one batched call (crops are
    zero-padded into a common buffer; each box selects its real extent)."""
    hp = max(1, *(im.shape[0] for im in imgs))
    wp = max(1, *(im.shape[1] for im in imgs))
    hp = -(-hp // 32) * 32
    wp = -(-wp // 32) * 32
    buf = np.zeros((len(imgs), hp, wp, 3), np.uint8)
    boxes = np.zeros((len(imgs), 1, 4), np.int32)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        buf[i, :h, :w] = im
        boxes[i, 0] = (0, 0, w, h)
    out = crop_and_resize(torch.from_numpy(buf).to(device),
                          torch.from_numpy(boxes).to(device), DETECT_CROP,
                          reciprocal=False)  # the reference trainer divides
    return out[:, 0]


def _blend_fold(crops: np.ndarray) -> np.ndarray:
    """Running 50/50 uint8 blend (first crop taken whole), like the
    reference's addWeighted chain; per-step round-half-even."""
    acc = crops[0].astype(np.float64)
    for c in crops[1:]:
        acc = np.rint(0.5 * acc + 0.5 * c.astype(np.float64))
    return acc.astype(np.uint8)


def train_mean_masks(train_dir: str, device="cuda") -> MeanMaskTemplates:
    """Train the six mean-mask templates from train_jpg/<class>/ crops."""
    reds, blues = [], []
    for class_dirs in SUPERTYPE_CLASS_DIRS:
        raw = []
        for d in class_dirs:
            droot = os.path.join(train_dir, d)
            if not os.path.isdir(droot):
                continue
            for fname in sorted(os.listdir(droot)):
                if fname.lower().endswith((".jpg", ".jpeg", ".ppm", ".png")):
                    raw.append(load_image_bgr(os.path.join(droot, fname)))
        if not raw:
            raise FileNotFoundError(
                f"no training crops under {train_dir} for dirs {class_dirs}")
        mean_crop = _blend_fold(_resize_crops_25(raw, device).cpu().numpy())
        crop = torch.from_numpy(mean_crop)
        reds.append((color_mask(crop, "r").reshape(-1) > 0).to(torch.float32).numpy())
        blues.append((color_mask(crop, "b").reshape(-1) > 0).to(torch.float32).numpy())
    return MeanMaskTemplates(red=np.stack(reds), blue=np.stack(blues))


def _score_color(crop_masks: torch.Tensor, templates: torch.Tensor):
    """crop_masks [..., N, 625] {0,1} x templates [6, 625] -> best scores.

    Returns (score, type in 1..6, raw): ``score`` is the 2-decimal-rounded
    masked F1, ``raw`` the unrounded F1 of the winning type.
    """
    tp = crop_masks @ templates.T
    fn = templates.sum(-1) - tp
    raw = 2.0 * tp / torch.clamp(2.0 * tp + fn, min=1e-9)
    raw = torch.where(tp + fn <= _PIX * 0.01, torch.zeros_like(raw), raw)
    # "/ 100" as the reference's jit computes it: times the f32 reciprocal
    score = torch.round(raw * 100.0) * const_f32(float(np.float32(1.0) / np.float32(100.0)),
                                                 raw.device)
    best = torch.argmax(score, dim=-1, keepdim=True)
    take = lambda x: torch.gather(x, -1, best)[..., 0]  # noqa: E731
    return take(score), best[..., 0].to(torch.int32) + 1, take(raw)


def mask_correlation_classify(crops_bgr: torch.Tensor, red_templates: torch.Tensor,
                              blue_templates: torch.Tensor,
                              tol: float = MASK_CORR_TOL,
                              fine_scores: bool = False):
    """Classify [..., N, 25, 25, 3] uint8 crops against the templates.

    Returns (types int32 [..., N] in 1..6, scores f32 [..., N], accept bool
    [..., N]).  Red wins only when its score is strictly greater.
    """
    lead = crops_bgr.shape[:-3]
    red_m = (color_mask(crops_bgr, "r") > 0).reshape(lead + (-1,)).to(torch.float32)
    blue_m = (color_mask(crops_bgr, "b") > 0).reshape(lead + (-1,)).to(torch.float32)
    score_r, type_r, raw_r = _score_color(red_m, red_templates)
    score_b, type_b, raw_b = _score_color(blue_m, blue_templates)
    use_red = score_r > score_b
    score = torch.where(use_red, score_r, score_b)
    sign_type = torch.where(use_red, type_r, type_b)
    accept = score > tol
    if fine_scores:
        score = torch.where(use_red, raw_r, raw_b)
    return sign_type, score, accept
