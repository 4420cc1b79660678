"""SPMD data-parallel training of the CNN sign detector.

Counterpart of ``opencv_traffic_sign_detector_tpu/parallel/cnn.py``, the
gradient counterpart of ``parallel/train.py``: the frame dataset is split
over the mesh's shards, each shard holding ``N / shards`` frames on its
device and sampling its own crops there.  As under the reference's
``shard_map``, every shard keeps a replica of the network and an AdamW state
of its own: each computes its loss and gradients, the gradients and metrics
are averaged over every shard of every rank (:func:`.mesh.psum`), and every
shard applies the same AdamW update to its own replica, so the replicas stay
equal and no parameter crosses devices.  A shard's draws come from ``(seed,
step, shard)`` alone, as the reference folds the step and the device index
into its key.  On a card each shard replays captured CUDA graphs, as the
reference runs one compiled program (:class:`SPMDTrainStep`).
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch

from ..models.cnn_detector import CNNDetectorConfig
from ..models.cnn_train import (
    TrainConfig,
    _seed_state,
    adamw_update,
    capturable_optimizer,
    centernet_loss,
    crop_targets,
    crops_from_draws,
    lr_at,
    lr_table,
    make_optimizer,
    sample_draws,
)
from ..models.detector import full_f32_matmuls
from ..ops.mser import stage_scope
from ..runtime import graphs
from .mesh import device_scope, psum, rank_slice, shard_batch

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


@dataclasses.dataclass
class _Shard:
    """One shard's replica and optimizer state, all on the shard's device:
    its update count, rate table and rate (as ``models/cnn_train.py:
    TrainStep`` keeps them), its AdamW, the generator its crops draw from,
    and ``mean``, a flat f32 buffer of the averaged gradients (each
    parameter's ``.grad`` is a view of it, never ``None``) followed by the
    four averaged metrics."""

    device: torch.device
    replica: torch.nn.Module
    params: list
    count: torch.Tensor
    table: torch.Tensor
    lr: torch.Tensor
    opt: torch.optim.AdamW
    gen: torch.Generator
    mean: torch.Tensor


class SPMDTrainStep:
    """``step(model, data, step) -> metrics``: ``model`` is the first
    replica (a ``SignCenterNet`` on the mesh's first device; archs whose
    reference step applies ``{"params": ...}`` alone, so no BatchNorm twin),
    ``data`` :func:`put_sharded_cnn_dataset`'s list.  The per-shard batch
    is ``cfg.batch_size`` crops, so the global batch is ``batch_size *
    shards``.  -> {"loss", "hm", "wh", "off"}: 0-d means over every shard,
    on the first device, which the next step rewrites.

    At the first call with ``model`` every other shard's device gets a copy
    of it and every shard an AdamW of its own (:class:`_Shard`:
    ``capturable_optimizer`` on a card, ``make_optimizer`` on the CPU); the
    step holds no host state after that.  A step, in the reference's order:
    each shard draws from its generator, seeded with ``(cfg.seed, step,
    shard)``'s state, cuts its crops and writes its gradients and metrics
    into one flat buffer; the buffers are summed in shard order onto the
    first device, all-reduced over the mesh's group where it has one
    (:func:`.mesh.psum`), divided by the global shard count and copied to
    every shard's ``mean``; then every shard runs the same AdamW update.

    On a card (:attr:`GRAPH_DEVICES`) each shard replays two CUDA graphs a
    step, its local part and its update, each with a memory pool of its own
    (``capture``, by default ``runtime/graphs.py: capture_call``; the local
    graph registers the shard's generator).  The mean between them is
    enqueued on the cards' current streams (peer copies, NCCL), so the host
    never waits for a card.  The first call runs each part once eagerly, a
    real step whose metrics it returns, and captures it; later calls with
    the same model and data tensors (by identity; others make new captures)
    replay.  A capture that fails raises ``GraphCaptureError``: there is no
    eager retry.  On the CPU, and with a ``timer`` (``timer(name)`` is a
    context around each shard's stages ``sample+resize``, ``targets``,
    ``forward+backward`` and ``optimizer``, and around ``pmean``), the same
    body runs eagerly."""

    GRAPH_DEVICES = ("cuda",)

    def __init__(self, mesh, model_cfg: CNNDetectorConfig, cfg: TrainConfig, timer=None,
                 capture=None):
        self.mesh, self.model_cfg, self.cfg, self.timer = mesh, model_cfg, cfg, timer
        self.graphed = mesh.devices[0].type in self.GRAPH_DEVICES
        self._capture = capture or graphs.capture_call
        self._model = None
        self._shards: list[_Shard] = []
        self._held = None  # (model and data tensors, local graphs, update graphs)

    def __call__(self, model, data: list[dict[str, torch.Tensor]], step: int) -> dict:
        shards = self._shards_of(model)
        for i, s in enumerate(shards):
            s.gen.manual_seed(_seed_state((self.cfg.seed, step, self.mesh.shard_index(i))))
        if self.timer is not None or not self.graphed:
            return self._body(data)
        key = (model, *(t for shard in data for t in shard.values()))
        if self._held is not None and len(self._held[0]) == len(key) and all(
                a is b for a, b in zip(self._held[0], key)):
            return self._replay()
        return self._capture_step(data, key)

    @property
    def captured(self) -> tuple[list, list] | None:
        """(each shard's local graph, each shard's update graph), as
        ``graphs.Captured``, or ``None`` before the first graphed step."""
        return None if self._held is None else self._held[1:]

    def _replicas_of(self, model) -> list[torch.nn.Module]:
        """``model`` and its replica on each other shard."""
        return [s.replica for s in self._shards_of(model)]

    def _shards_of(self, model) -> list[_Shard]:
        if self._model is model:
            return self._shards
        n = sum(p.numel() for p in model.parameters())
        shards = []
        for i, dev in enumerate(self.mesh.devices):
            replica = model if i == 0 else copy.deepcopy(model).to(dev)
            params = list(replica.parameters())
            mean = torch.zeros(n + len(_METRICS), dtype=torch.float32, device=dev)
            start = 0
            for p in params:
                p.requires_grad_(True)
                p.grad = mean[start:start + p.numel()].view_as(p)
                start += p.numel()
            count = torch.zeros((), dtype=torch.int64, device=dev)
            table = lr_table(self.cfg, dev)
            lr = lr_at(table, count)
            opt = (capturable_optimizer(params, self.cfg, lr) if self.graphed
                   else make_optimizer(params, self.cfg))
            shards.append(_Shard(dev, replica, params, count, table, lr, opt,
                                 torch.Generator(device=dev), mean))
        self._model, self._shards, self._held = model, shards, None
        return shards

    def update(self, model, crops: list[tuple[torch.Tensor, ...]]) -> dict:
        """The step, eagerly, on each shard's (images, boxes, cls) crops."""
        flats = []
        for s, (imgs, boxes, cls) in zip(self._shards_of(model), crops, strict=True):
            with device_scope(s.device):
                flats.append(self._grads(s, imgs, boxes, cls))
        return self._apply(flats)

    def _body(self, data: list[dict[str, torch.Tensor]]) -> dict:
        flats = []
        for s, shard in zip(self._shards, data, strict=True):
            with device_scope(s.device):
                flats.append(self._local(s, shard))
        return self._apply(flats)

    def _local(self, s: _Shard, data: dict[str, torch.Tensor]) -> torch.Tensor:
        """A shard's draws, crops, loss and gradients: -> the flat buffer of
        its gradients and its four metrics."""
        with stage_scope(self.timer, "sample+resize"):
            draws = sample_draws(s.gen, self.cfg.batch_size, data["frames"].shape[0],
                                 data["pos"].shape[0], self.cfg)
            crops = crops_from_draws(draws, data, self.cfg)
        return self._grads(s, *crops)

    def _grads(self, s: _Shard, imgs, boxes, cls) -> torch.Tensor:
        full_f32_matmuls()
        with stage_scope(self.timer, "targets"):
            targets = crop_targets(boxes, cls, self.model_cfg.stride)
        with stage_scope(self.timer, "forward+backward"):
            loss, parts = centernet_loss(s.replica(imgs), targets, self.cfg)
            grads = torch.autograd.grad(loss, s.params)
            metrics = torch.stack([loss] + [parts[k] for k in _METRICS[1:]]).detach()
        return torch.cat([g.reshape(-1) for g in grads] + [metrics])

    def _apply(self, flats: list[torch.Tensor]) -> dict:
        metrics = self._mean(flats)
        for s in self._shards:
            with device_scope(s.device):
                self._update(s)
        return metrics

    def _mean(self, flats: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        """The shards' buffers averaged into every shard's ``mean``: summed in
        shard order onto the first device and over the group where the mesh
        has one, divided there and copied to each other shard."""
        with stage_scope(self.timer, "pmean"):
            first = self._shards[0].mean
            torch.div(psum(self.mesh, flats), self.mesh.shards, out=first)
            for s in self._shards[1:]:
                s.mean.copy_(first)
        return dict(zip(_METRICS, first[-len(_METRICS):]))

    def _update(self, s: _Shard) -> None:
        with stage_scope(self.timer, "optimizer"):
            adamw_update(s.opt, s.lr, s.table, s.count)

    def _capture_step(self, data: list[dict[str, torch.Tensor]], key: tuple) -> dict:
        """The first graphed step: each shard's local part run and captured,
        the mean of the runs' buffers, then each shard's update run and
        captured."""
        flats, local = [], []
        for i, (s, shard) in enumerate(zip(self._shards, data, strict=True)):
            with device_scope(s.device):
                first, entry = self._capture(functools.partial(self._local, s), s.device,
                                             (shard,), f"as shard {i}'s gradients",
                                             generator=s.gen)
            flats.append(first)
            local.append(entry)
        metrics = self._mean(flats)
        updates = []
        for i, s in enumerate(self._shards):
            with device_scope(s.device):
                updates.append(self._capture(functools.partial(self._update, s), s.device, (),
                                             f"as shard {i}'s AdamW update")[1])
        self._held = (key, local, updates)
        return metrics

    def _replay(self) -> dict:
        _, local, updates = self._held
        flats = []
        for s, entry in zip(self._shards, local):
            with device_scope(s.device):
                flats.append(entry.replay())
        metrics = self._mean(flats)
        for s, entry in zip(self._shards, updates):
            with device_scope(s.device):
                entry.replay()
        return metrics


def make_spmd_cnn_train_step(mesh, model_cfg: CNNDetectorConfig,
                             cfg: TrainConfig) -> SPMDTrainStep:
    """The SPMD step over ``mesh`` (:class:`SPMDTrainStep`)."""
    return SPMDTrainStep(mesh, model_cfg, cfg)
