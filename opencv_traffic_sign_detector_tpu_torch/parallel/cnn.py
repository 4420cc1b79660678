"""SPMD data-parallel training of the CNN sign detector.

Counterpart of ``opencv_traffic_sign_detector_tpu/parallel/cnn.py``, the
gradient counterpart of ``parallel/train.py``: the frame dataset is split
over the mesh's shards, each shard holding ``N / shards`` frames on its
device and sampling its own crops there; each shard computes its loss and
gradients on its own replica of the network, the gradients and metrics are
averaged over every shard of every rank (:func:`.mesh.pmean`), and one
AdamW update runs on the first replica, whose parameters the others copy
before the next step.  A shard's draws come from ``(seed, step, shard)``
alone, as the reference folds the step and the device index into its key.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.cnn_detector import CNNDetectorConfig
from ..models.cnn_train import (
    TrainConfig,
    crop_targets,
    crops_from_draws,
    centernet_loss,
    learning_rate,
    sample_draws,
    shard_generator,
)
from ..models.detector import full_f32_matmuls
from .mesh import device_scope, pmean, rank_slice, shard_batch

_METRICS = ("loss", "hm", "wh", "off")


def shard_cnn_dataset(data: dict, n_shards: int) -> dict:
    """Split a build_dataset() dict into equal per-device shards.

    Frames are padded (by repeating the first frames) to a multiple of
    ``n_shards``; each shard's positive table is rebuilt with LOCAL frame
    indices and padded to a common length so shapes stay static under SPMD.
    """
    frames, boxes, cls = data["frames"], data["boxes"], data["cls"]
    n = frames.shape[0]
    per = -(-n // n_shards)
    pad = per * n_shards - n
    if pad:
        idx = np.concatenate([np.arange(n), np.arange(pad) % n])
        frames, boxes, cls = frames[idx], boxes[idx], cls[idx]

    shard_pos: list[np.ndarray] = []
    for s in range(n_shards):
        rows = []
        for li in range(per):
            gi = s * per + li
            for b, c in zip(boxes[gi], cls[gi]):
                if c > 0:
                    rows.append((li, (b[0] + b[2]) / 2, (b[1] + b[3]) / 2))
        shard_pos.append(np.asarray(rows, np.float32).reshape(-1, 3))
    p_max = max(1, max(p.shape[0] for p in shard_pos))
    padded = []
    for p in shard_pos:
        if p.shape[0] == 0:
            # a shard with no signs samples its "positive" crops uniformly
            p = np.asarray([[0, frames.shape[2] / 2, frames.shape[1] / 2]],
                           np.float32)
        reps = -(-p_max // p.shape[0])
        padded.append(np.tile(p, (reps, 1))[:p_max])
    return {
        "frames": frames,
        "boxes": boxes,
        "cls": cls,
        "pos": np.stack(padded).reshape(n_shards * p_max, 3),
    }


def put_sharded_cnn_dataset(mesh, data: dict) -> list[dict[str, torch.Tensor]]:
    """:func:`shard_cnn_dataset`'s arrays -> one dict a local shard, each
    array's part on that shard's device."""
    out: list[dict[str, torch.Tensor]] = [{} for _ in mesh.devices]
    for key, value in data.items():
        for shard, part in zip(out, shard_batch(mesh, rank_slice(mesh, value))):
            shard[key] = part
    return out


class SPMDTrainStep:
    """``step(model, opt, data, step) -> metrics``: ``model`` is the first
    replica (a ``SignCenterNet`` on the mesh's first device; archs whose
    reference step applies ``{"params": ...}`` alone, so no BatchNorm
    twin), ``opt`` its optimizer (``models.cnn_train.make_optimizer``),
    ``data`` :func:`put_sharded_cnn_dataset`'s list.  The per-shard batch
    is ``cfg.batch_size`` crops, so the global batch is ``batch_size *
    shards``.  -> {"loss", "hm", "wh", "off"}: 0-d means over every shard,
    on the first device."""

    def __init__(self, mesh, model_cfg: CNNDetectorConfig, cfg: TrainConfig):
        self.mesh, self.model_cfg, self.cfg = mesh, model_cfg, cfg
        self._replicas: dict[int, torch.nn.Module] = {}

    def __call__(self, model, opt, data: list[dict[str, torch.Tensor]], step: int):
        crops = []
        for i, (dev, shard) in enumerate(zip(self.mesh.devices, data)):
            with device_scope(dev):
                gen = shard_generator(self.cfg.seed, step, self.mesh.shard_index(i), dev)
                draws = sample_draws(gen, self.cfg.batch_size, shard["frames"].shape[0],
                                     shard["pos"].shape[0], self.cfg)
                crops.append(crops_from_draws(draws, shard, self.cfg))
        return self.update(model, opt, crops)

    def _replicas_of(self, model) -> list[torch.nn.Module]:
        """``model`` and a copy of its parameters on each other shard."""
        out = [model]
        for i, dev in enumerate(self.mesh.devices[1:], start=1):
            rep = self._replicas.get(i)
            if rep is None:
                rep = self._replicas[i] = copy.deepcopy(model).to(dev)
            else:
                rep.load_state_dict(model.state_dict())
            out.append(rep)
        for rep in out:
            for p in rep.parameters():
                p.requires_grad_(True)
        return out

    def update(self, model, opt, crops: list[tuple[torch.Tensor, ...]]) -> dict:
        """The step on each shard's (images, boxes, cls) crops."""
        full_f32_matmuls()
        flats = []
        for dev, rep, (imgs, boxes, cls) in zip(self.mesh.devices, self._replicas_of(model),
                                                crops):
            with device_scope(dev):
                targets = crop_targets(boxes, cls, self.model_cfg.stride)
                loss, parts = centernet_loss(rep(imgs), targets, self.cfg)
                grads = torch.autograd.grad(loss, list(rep.parameters()))
                metrics = torch.stack([loss] + [parts[k] for k in _METRICS[1:]]).detach()
                flats.append(torch.cat([g.reshape(-1) for g in grads] + [metrics]))
        mean = pmean(self.mesh, flats)
        params = list(model.parameters())
        start = 0
        for p in params:
            p.grad = mean[start:start + p.numel()].view_as(p).clone()
            start += p.numel()
        state = opt.state.get(params[0], {})
        count = int(state["step"]) if "step" in state else 0
        for group in opt.param_groups:
            group["lr"] = learning_rate(count, self.cfg)
        opt.step()
        return dict(zip(_METRICS, mean[start:]))


def make_spmd_cnn_train_step(mesh, model_cfg: CNNDetectorConfig,
                             cfg: TrainConfig) -> SPMDTrainStep:
    """The SPMD step over ``mesh`` (:class:`SPMDTrainStep`)."""
    return SPMDTrainStep(mesh, model_cfg, cfg)
