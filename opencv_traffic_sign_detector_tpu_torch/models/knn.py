"""k-nearest-neighbour classification as a distance product + a stable
selection.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/knn.py``
(sklearn's KNeighborsClassifier(4) over LDA-reduced features,
`Reconocimiento de Objetos/source.py:582-596`): squared Euclidean distances
from one Gram product, the k nearest by a stable ascending sort -- the
lower training index first among equal distances, as ``lax.top_k(-d2)``
picks them (``torch.topk`` promises no order among ties) -- and a majority
vote in which the smallest class label wins ties.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lda import as_f32


@dataclasses.dataclass(frozen=True)
class KNNParams:
    train_x: np.ndarray  # [M, K]
    train_y: np.ndarray  # [M] integer labels
    classes: np.ndarray  # [C] sorted unique labels
    k: int = 4

    def save(self, path: str) -> None:
        np.savez(path, train_x=self.train_x, train_y=self.train_y,
                 classes=self.classes, k=self.k)

    @classmethod
    def load(cls, path: str) -> "KNNParams":
        z = np.load(path)
        return cls(train_x=z["train_x"], train_y=z["train_y"],
                   classes=z["classes"], k=int(z["k"]))


def knn_fit(train_x: np.ndarray, train_y: np.ndarray, k: int = 4) -> KNNParams:
    return KNNParams(
        train_x=np.asarray(train_x, np.float32),
        train_y=np.asarray(train_y),
        classes=np.unique(train_y),
        k=k,
    )


def knn_vote(xq: torch.Tensor, xt: torch.Tensor, yt: torch.Tensor,
             classes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, K] queries against [M, K] training points -> (index into
    ``classes`` of the winner [N], its votes [N])."""
    d2 = (torch.sum(xq * xq, dim=1, keepdim=True) - 2.0 * xq @ xt.T
          + torch.sum(xt * xt, dim=1)[None, :])
    nn_idx = torch.sort(d2, dim=1, stable=True).indices[:, :k]  # [N, k]
    votes = torch.sum(yt[nn_idx][..., None] == classes[None, None, :], dim=1)  # [N, C]
    return torch.argmax(votes, dim=-1), torch.amax(votes, dim=-1)  # first max wins


def knn_predict(params: KNNParams, X) -> torch.Tensor:
    """[N, K] -> [N] predicted labels."""
    xq = as_f32(X)
    dev = xq.device
    classes = torch.from_numpy(np.asarray(params.classes)).to(dev)
    best, _ = knn_vote(xq, as_f32(params.train_x, dev),
                       torch.from_numpy(np.asarray(params.train_y)).to(dev), classes,
                       params.k)
    return classes[best]
