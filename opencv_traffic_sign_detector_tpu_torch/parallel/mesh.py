"""A data mesh for scale-out: the frame batch split along dim 0.

Counterpart of ``opencv_traffic_sign_detector_tpu/parallel/mesh.py``.  The
reference is single-controller SPMD: one ``Mesh`` of local devices, possibly
across processes, and ``psum``/``pmean`` over all of them.  Here a mesh is
two nested levels:

* **local shards**: a tuple of ``torch.device``s of one process (``cuda:0``
  to ``cuda:N-1``, or N shards on ``cpu`` run in turn, as the reference's
  tests run a virtual 8-device CPU mesh).  A batch is split along dim 0,
  a chunk a shard, and every shard's work is enqueued (each under its own
  card as the current device, which the CUDA kernels' launches use) before
  any result is read.  No shard's dispatch waits for its card (its
  constants and the replicated templates or classifier arrays stay on each
  card), and on a card detection and recognition replay one captured CUDA
  graph a card (``runtime/graphs.py``), so one host thread enqueues a shard
  in a copy and a graph launch and keeps every card busy;
* **ranks**: optionally a ``torch.distributed`` process group, one rank a
  process.  :func:`psum` sums the local shards onto the mesh's first
  device, then all-reduces over the group; :func:`pmean` divides by the
  global shard count.  NCCL serves CUDA meshes and gloo CPU meshes, and a
  mesh refuses a group of the other backend.

Detection and recognition have no cross-frame dependence: their sharded
forms run each shard's batch through the unsharded function and need no
collective.  The statistics fits (``parallel/train.py``), the detection
counts (``eval/device_stats.py``) and the CNN gradients
(``parallel/cnn.py``) reduce through :func:`psum`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from ..models.detector import pinned, upload
from ..runtime.graphs import CapturedFn, device_scope

DATA_AXIS = "data"
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: this process's shards, in order; ``group``: the process
    group whose ranks hold the other shards (None: one process)."""

    devices: tuple[torch.device, ...]
    group: object | None = None

    @property
    def size(self) -> int:
        """Shards in this process."""
        return len(self.devices)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def shards(self) -> int:
        """Shards over all ranks: the reference's ``mesh.devices.size``."""
        return self.size * self.world

    def shard_index(self, i: int) -> int:
        """Global index of local shard ``i`` (the reference's ``axis_index``)."""
        return self.rank * self.size + i


def explicit_device(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``: caches keyed by device (K2's plan
    tables) then see one key a card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def data_mesh(n_devices: int | None = None, devices=None, device="cuda",
              group=None) -> Mesh:
    """A 1-D mesh over the batch ("data") axis.

    ``devices`` names the shards; else ``n_devices`` shards of ``device``'s
    type: the first ``n_devices`` visible cards (all of them when None; more
    than are visible raises, where the reference silently takes fewer), or
    ``n_devices`` shards on the CPU (1 when None).  ``group`` defaults to
    the default process group once ``torch.distributed`` is initialised;
    its backend must be the mesh's (NCCL for cards, gloo for the CPU).
    """
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            visible = torch.cuda.device_count()
            n = visible if n_devices is None else n_devices
            if n > visible:
                raise ValueError(f"--n_devices {n} > {visible} visible CUDA device(s)")
            devices = [torch.device("cuda", i) for i in range(n)]
        elif kind == "cpu":
            devices = [torch.device("cpu")] * (1 if n_devices is None else n_devices)
        else:
            raise ValueError(f"unsupported device {device}: expected cpu or cuda")
    devices = tuple(explicit_device(torch.device(d)) for d in devices)
    kinds = {d.type for d in devices}
    if not devices or len(kinds) != 1 or not kinds <= set(_BACKEND):
        raise ValueError(f"a mesh needs one or more devices of one type, cpu or cuda: "
                         f"{[str(d) for d in devices]}")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        backend = str(dist.get_backend(group)).lower()
        want = _BACKEND[devices[0].type]
        if backend != want:
            raise ValueError(f"a {devices[0].type} mesh reduces over {want}, not {backend}")
    return Mesh(devices, group)


def host_shards(mesh: Mesh, array) -> list[torch.Tensor]:
    """This rank's batch (numpy or tensor) split along dim 0, a chunk a
    shard, where it lies: pinned on the host for a mesh of cards, so each
    chunk's copy to its card does not block."""
    t = pinned(array, mesh.devices[0])
    if t.shape[0] % mesh.size:
        raise ValueError(f"batch of {t.shape[0]} does not split over {mesh.size} shards")
    return list(t.chunk(mesh.size))


def shard_batch(mesh: Mesh, array) -> list[torch.Tensor]:
    """This rank's batch (numpy or tensor) split along dim 0, a chunk on
    each shard's device (pinned and non-blocking to a card)."""
    out = []
    for dev, chunk in zip(mesh.devices, host_shards(mesh, array)):
        with device_scope(dev):
            out.append(upload(chunk, dev))
    return out


def rank_slice(mesh: Mesh, array):
    """This rank's contiguous part of a global array whose dim 0 divides by
    ``mesh.shards``: what the reference's sharding of a full host array
    places on this process's devices."""
    per = len(array) // mesh.shards * mesh.size
    return array[mesh.rank * per:(mesh.rank + 1) * per]


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of one tensor a local shard, over every shard of every rank:
    the local shards summed in order onto the mesh's first device, then an
    all-reduce over the mesh's group when it has one."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for {mesh.size} shards")
    dev = mesh.devices[0]
    total = parts[0].to(dev).clone()
    for p in parts[1:]:
        total += p.to(dev)
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    return total


def pmean(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`psum` over the global shard count."""
    return psum(mesh, parts) / mesh.shards


def to_host(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """Per-shard results -> (one host tensor, in shard order, and the events
    that mark each card's copy done; none on the CPU).  Copies to a card's
    pinned host buffer do not block, so every shard stays enqueued."""
    if mesh.devices[0].type != "cuda":
        return torch.cat([p.to("cpu") for p in parts]), []
    out = torch.empty((sum(len(p) for p in parts),) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype, pin_memory=True)
    done, start = [], 0
    for dev, p in zip(mesh.devices, parts):
        with device_scope(dev):
            out[start:start + len(p)].copy_(p, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            done.append(event)
        start += len(p)
    return out, done


def _replicas():
    """-> ``on(dev, tensors)``: ``tensors`` copied to ``dev`` at the first
    call with them, then the same copies while the caller passes the same
    tensors (the templates or classifier arrays a batch reuses)."""
    held: dict = {}

    def on(dev, tensors: tuple) -> tuple:
        given, copies = held.get(dev, ((), ()))
        if len(given) != len(tensors) or any(a is not b for a, b in zip(given, tensors)):
            copies = tuple(t.to(dev) for t in tensors)
            held[dev] = (tensors, copies)
        return copies

    return on


def sharded_detect_fn(mesh: Mesh, detect_batch_fn):
    """Run a per-batch detection fn on each shard.

    detect_batch_fn: (frames [b,H,W,3], red_t, blue_t) -> outputs of [b,...].
    Returned fn: (each shard's frames, from :func:`host_shards` or
    :func:`shard_batch`, red_t, blue_t, ``key``, ``eager``) -> a list of
    each shard's outputs; the templates are copied to each shard's device
    once.  On a card each shard replays one CUDA graph a shard, frame shape
    and ``key`` (the config), captured at its first batch
    (``runtime/graphs.py``), unless ``eager``; its outputs are the graph's,
    valid until the next call: copy them out first (:func:`to_host`).  No
    collective: frames do not depend on each other.  ``run.graphs`` holds
    the captures.
    """
    on, graphs = _replicas(), CapturedFn(detect_batch_fn)

    def run(shards, red, blue, *, key=(), eager=False):
        outs = []
        for i, (dev, frames) in enumerate(zip(mesh.devices, shards)):
            with device_scope(dev):
                # a graph a shard: two shards on one card keep apart outputs
                outs.append(graphs(dev, frames, *on(dev, (red, blue)), key=(i, key),
                                   eager=eager))
        return outs

    run.graphs = graphs
    return run


def sharded_recognize_fn(mesh: Mesh, cfg, features: str, clf_kind: str, knn_k: int = 4):
    """``recognize_batch`` on each shard, the classifier arrays (LDA head
    stacks or the KNN train set) copied to each shard's device once.
    Returned fn: (each shard's frames, clf_arrays) -> a list of each shard's
    (boxes, labels, scores, valid); on a card a replay of one CUDA graph a
    shard and frame shape, whose outputs are valid until the next call, as
    :func:`sharded_detect_fn`'s."""
    from ..models.rec_pipeline import recognize_batch

    on = _replicas()
    graphs = CapturedFn(lambda frames, *arrays: recognize_batch(
        frames, arrays, cfg, features, clf_kind, knn_k))

    def run(shards, clf_arrays):
        outs = []
        for i, (dev, frames) in enumerate(zip(mesh.devices, shards)):
            with device_scope(dev):
                outs.append(graphs(dev, frames, *on(dev, tuple(clf_arrays)), key=i))
        return outs

    run.graphs = graphs
    return run


def unshard(parts: Sequence[tuple]) -> tuple:
    """Per-shard output tuples -> one tuple of batch-ordered tensors on the
    first shard's device."""
    dev = parts[0][0].device
    return tuple(torch.cat([p[k].to(dev) for p in parts]) for k in range(len(parts[0])))
