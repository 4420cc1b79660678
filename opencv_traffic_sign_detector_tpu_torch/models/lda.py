"""Linear Discriminant Analysis: closed-form fit on the host, inference on
the device.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/lda.py``, which
reimplements sklearn's ``LinearDiscriminantAnalysis(solver="svd")`` -- the
reference's "Bayes" heads and its KNN reducer (`Reconocimiento de
Objetos/source.py:526-577`).  :func:`lda_fit` is the same host numpy
algebra as the reference's, so the same features give the same arrays;
``transform``, ``decision_function`` and ``predict_proba`` run as torch
products on the tensor's device (full f32 on the card:
``models.detector.full_f32_matmuls``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LDAParams:
    """Fitted model; arrays are numpy for easy checkpointing."""

    classes: np.ndarray  # [C] sorted class labels
    xbar: np.ndarray  # [D] overall (prior-weighted) mean
    scalings: np.ndarray  # [D, K] transform matrix (zero-padded rank)
    coef: np.ndarray  # [C, D]
    intercept: np.ndarray  # [C]

    def save(self, path: str) -> None:
        np.savez(path, classes=self.classes, xbar=self.xbar, scalings=self.scalings,
                 coef=self.coef, intercept=self.intercept)

    @classmethod
    def load(cls, path: str) -> "LDAParams":
        z = np.load(path)
        return cls(classes=z["classes"], xbar=z["xbar"], scalings=z["scalings"],
                   coef=z["coef"], intercept=z["intercept"])


def lda_fit(X, y: np.ndarray, tol: float = 1e-4) -> LDAParams:
    """Fit LDA on [N, D] float data with integer labels (host numpy, the
    svd-solver algorithm step for step, as the reference fits it)."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    n, d = X.shape
    c = len(classes)

    onehot = (y[:, None] == classes[None, :]).astype(np.float32)
    counts = onehot.sum(axis=0)  # [C]
    priors = counts / n
    means = (onehot.T @ X) / counts[:, None]  # [C, D]
    xbar = priors @ means  # [D]

    Xc = X - onehot @ means  # center by class mean
    std = Xc.std(axis=0)
    std[std == 0] = 1.0
    # n == c (one sample per class): clamp the denominator so the fit stays
    # finite (sklearn raises here instead)
    fac = 1.0 / max(n - c, 1)
    Xs = np.sqrt(fac) * (Xc / std)
    _, S, Vt = np.linalg.svd(Xs, full_matrices=False)
    rank_mask = (S > tol).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_s = np.where(S > tol, 1.0 / np.maximum(S, 1e-30), 0.0)
    scalings1 = (Vt / std[None, :]).T * (inv_s * rank_mask)[None, :]  # [D, R]

    Xb = (np.sqrt((n * priors) * fac)[:, None] * (means - xbar)) @ scalings1  # [C, R]
    _, S2, Vt2 = np.linalg.svd(Xb, full_matrices=False)
    mask2 = (S2 > tol * S2[0]).astype(np.float32)
    k = min(c - 1, Vt2.shape[0])
    proj = (Vt2 * mask2[:, None]).T[:, :k]  # [R, K]
    scalings = scalings1 @ proj  # [D, K]

    coef_k = (means - xbar) @ scalings  # [C, K]
    intercept = -0.5 * np.sum(coef_k**2, axis=1) + np.log(priors)
    coef = coef_k @ scalings.T  # [C, D]
    intercept = intercept - coef @ xbar

    return LDAParams(
        classes=np.asarray(classes),
        xbar=np.asarray(xbar, np.float32),
        scalings=np.asarray(scalings, np.float32),
        coef=np.asarray(coef, np.float32),
        intercept=np.asarray(intercept, np.float32),
    )


def as_f32(x, device=None) -> torch.Tensor:
    """numpy or tensor -> f32 tensor on ``device`` (the tensor's own, or the
    CPU for numpy, when None)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device if device is not None else t.device, dtype=torch.float32)


def lda_transform(params: LDAParams, X) -> torch.Tensor:
    """[N, D] -> [N, K] discriminant coordinates (sklearn .transform)."""
    x = as_f32(X)
    return (x - as_f32(params.xbar, x.device)) @ as_f32(params.scalings, x.device)


def lda_decision(params: LDAParams, X) -> torch.Tensor:
    """[N, D] -> [N, C] Gaussian log-posterior scores."""
    x = as_f32(X)
    return x @ as_f32(params.coef, x.device).T + as_f32(params.intercept, x.device)


def lda_predict_proba(params: LDAParams, X) -> torch.Tensor:
    """[N, D] -> [N, C] class probabilities (softmax; sigmoid when C == 2)."""
    scores = lda_decision(params, X)
    if len(params.classes) == 2:
        p1 = torch.sigmoid(scores[:, 1] - scores[:, 0])
        return torch.stack([1.0 - p1, p1], dim=-1)
    return torch.softmax(scores, dim=-1)
