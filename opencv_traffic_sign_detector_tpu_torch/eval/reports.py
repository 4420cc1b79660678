"""Classification metrics: confusion matrix + per-class report.

The port's own copy of ``opencv_traffic_sign_detector_tpu/eval/reports.py``
(plain numpy): the labels x labels confusion matrix and the
precision/recall/F1/support report with accuracy, macro and weighted
averages that the reference's validation harness prints
(`Reconocimiento de Objetos/source.py:774-797`).
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(
    y_true: np.ndarray, y_pred: np.ndarray, labels: list | np.ndarray
) -> np.ndarray:
    """[C, C] counts; rows = true label, cols = predicted."""
    labels = list(labels)
    index = {l: i for i, l in enumerate(labels)}
    m = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(np.asarray(y_true).tolist(), np.asarray(y_pred).tolist()):
        if t in index and p in index:
            m[index[t], index[p]] += 1
    return m


def classification_report(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    labels: list | np.ndarray,
    target_names: list[str] | None = None,
) -> str:
    """Text report in the familiar sklearn layout."""
    m = confusion_matrix(y_true, y_pred, labels)
    names = target_names or [str(l) for l in labels]
    tp = np.diag(m).astype(float)
    pred_tot = m.sum(axis=0).astype(float)
    true_tot = m.sum(axis=1).astype(float)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        rec = np.where(true_tot > 0, tp / true_tot, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    support = true_tot.astype(int)
    total = support.sum()
    acc = tp.sum() / max(total, 1)

    width = max(max(len(n) for n in names), 12)
    lines = [f"{'':>{width}}  precision    recall  f1-score   support", ""]
    for i, n in enumerate(names):
        lines.append(
            f"{n:>{width}}  {prec[i]:9.2f} {rec[i]:9.2f} {f1[i]:9.2f} {support[i]:9d}"
        )
    lines.append("")
    lines.append(f"{'accuracy':>{width}}  {'':9} {'':9} {acc:9.2f} {total:9d}")
    macro = (prec.mean(), rec.mean(), f1.mean())
    lines.append(
        f"{'macro avg':>{width}}  {macro[0]:9.2f} {macro[1]:9.2f} {macro[2]:9.2f} {total:9d}"
    )
    wts = support / max(total, 1)
    wavg = ((prec * wts).sum(), (rec * wts).sum(), (f1 * wts).sum())
    lines.append(
        f"{'weighted avg':>{width}}  {wavg[0]:9.2f} {wavg[1]:9.2f} {wavg[2]:9.2f} {total:9d}"
    )
    return "\n".join(lines)


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if len(y_true) else 0.0
