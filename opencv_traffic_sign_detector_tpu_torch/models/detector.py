"""Práctica-1 detection pipeline, batched over frames on one device.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/detector.py``:

    BGR [B,H,W,3] -> enhance_contrast -> MSER proposals [B,N,4]
                  -> aspect filter + 1.30 grow -> crops [B,N,25,25,3]
                  -> dedup (histogram pass, coords pass)
                  -> mean-mask correlation classify -> compact [B,D] detections

Every stage carries the batch dimension; there is no loop over frames on
the device path.  The host side decodes frames, keeps one batch in flight
and unpacks results into detection records.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig
from ..constants import (
    DEDUP_COORD_TOL,
    DEDUP_HIST_TOL,
    DETECT_CROP,
    DETECT_GROW,
)
from ..data.gt import GroundTruthBox
from ..data.images import list_frame_files
from ..data.prefetch import batched_frames
from ..ops.dedup import dedup_by_coords, dedup_by_histogram
from ..ops.geometry import filter_and_grow_boxes
from ..ops.mser import mser_regions, stage_scope
from ..ops.preprocess import enhance_contrast
from ..ops.resize import crop_and_resize
from ..runtime.trace import TRACER
from .mean_masks import MeanMaskTemplates, mask_correlation_classify, templates_to_torch


def full_f32_matmuls() -> None:
    """Keep f32 matrix products and convolutions (crop resize, histogram
    correlation, the CNN's f32 paths and its exact yuv conv) in full f32 on
    the card, as the reference computes them: no TF32; and let bf16
    products reduce in f32 only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def pinned(frames, device) -> torch.Tensor:
    """Frames (numpy or tensor) as a tensor that ``device`` can copy without
    the host waiting: pinned where ``device`` is a card and the frames lie on
    the host, else as they are."""
    t = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(frames))
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory()
    return t


def upload(frames, device) -> torch.Tensor:
    """Host frames (numpy or tensor) -> ``device``: pinned and non-blocking
    to a card, so the host can go on while the copy runs."""
    device = torch.device(device)
    return pinned(frames, device).to(device, non_blocking=device.type == "cuda")


def compact_first(final: torch.Tensor, d: int, *xs: torch.Tensor):
    """The first ``d`` True slots of each row of ``final`` [B, N], in order,
    as ``jnp.nonzero(size=d, fill_value=n)`` gives them: each of ``xs``
    [B, N, ...] gathered there (zeros past the end) and the valid mask
    [B, d].  -> (*gathered, valid)."""
    b, n = final.shape
    pos = torch.where(final, torch.arange(n, device=final.device), n)
    idx = torch.sort(pos, dim=-1).values
    if d > n:
        idx = torch.cat([idx, idx.new_full((b, d - n), n)], dim=-1)
    idx = idx[:, :d]
    valid = torch.arange(d, device=final.device) < final.sum(-1, keepdim=True)

    def take(x):
        pad = torch.zeros((b, 1) + x.shape[2:], dtype=x.dtype, device=x.device)
        xp = torch.cat([x, pad], dim=1)
        gidx = idx.reshape((b, d) + (1,) * (x.dim() - 2)).expand((b, d) + x.shape[2:])
        return torch.gather(xp, 1, gidx)

    return (*(take(x) for x in xs), valid)


def detect_batch(frames: torch.Tensor, red_templates: torch.Tensor,
                 blue_templates: torch.Tensor, cfg: PipelineConfig, timer=None):
    """[B, H, W, 3] uint8 -> per-frame padded detections.

    Returns (boxes int32 [B, D, 4] xyxy, types int32 [B, D], scores f32
    [B, D], valid bool [B, D]) with D = cfg.max_detections.  ``timer``, when
    given, is called with a stage name and returns a context manager; the
    ``classify.*`` stages lie inside ``classify``.
    """
    full_f32_matmuls()
    with stage_scope(timer, "preprocess"):
        gray = enhance_contrast(frames)
    props, pvalid = mser_regions(gray, cfg.mser, timer)
    with stage_scope(timer, "classify"):
        with stage_scope(timer, "classify.crops"):
            boxes, keep = filter_and_grow_boxes(props, pvalid, DETECT_GROW)
            crops = crop_and_resize(frames, boxes, DETECT_CROP)
        with stage_scope(timer, "classify.dedup"):
            crops, boxes, keep = dedup_by_histogram(crops, boxes, keep, DEDUP_HIST_TOL)
            crops, boxes, keep = dedup_by_coords(crops, boxes, keep, DEDUP_COORD_TOL)
        with stage_scope(timer, "classify.scores"):
            types, scores, accept = mask_correlation_classify(
                crops, red_templates, blue_templates, cfg.mask_corr_tol,
                fine_scores=cfg.fine_scores)
            out = compact_first(keep & accept, cfg.max_detections, boxes, types, scores)
    return out


def detect_frame(bgr: torch.Tensor, red_templates: torch.Tensor,
                 blue_templates: torch.Tensor, cfg: PipelineConfig):
    """One [H, W, 3] uint8 frame -> (boxes [D, 4] xyxy, types [D], scores
    [D], valid [D]): :func:`detect_batch` of a batch of one."""
    return tuple(x[0] for x in detect_batch(bgr[None], red_templates, blue_templates, cfg))


def _pack(boxes, types, scores, valid) -> torch.Tensor:
    """All four outputs as one [B, D, 7] f32 tensor: one device->host copy."""
    return torch.cat([boxes.to(torch.float32), types[..., None].to(torch.float32),
                      scores[..., None], valid[..., None].to(torch.float32)], dim=-1)


def unpack(packed: np.ndarray, names: list[str]) -> list[GroundTruthBox]:
    """A host copy of :func:`_pack`'s [B, D, 7] -> each frame's valid slots
    as records, frame ``b`` named ``names[b]``."""
    boxes = packed[..., :4].astype(np.int64)
    types = packed[..., 4].astype(np.int64)
    scores = packed[..., 5]
    valid = packed[..., 6] > 0.5
    dets: list[GroundTruthBox] = []
    for b in range(len(names)):
        for i in np.nonzero(valid[b])[0]:
            x1, y1, x2, y2 = (int(v) for v in boxes[b, i])
            dets.append(GroundTruthBox(filename=names[b], x1=x1, y1=y1, x2=x2, y2=y2,
                                       class_id=int(types[b, i]), score=float(scores[b, i])))
    return dets


class DetectionPipeline:
    """Host-facing detector: owns the templates on the device and runs
    batches through :func:`detect_batch`, one batch in flight.

    With ``mesh`` (:func:`..parallel.mesh.data_mesh`), each batch is split
    over the mesh's shards, every shard enqueued before any is read; the
    records come back in frame order, as without a mesh.  The batch size
    must divide by the mesh's size.

    On a card each shard's batch replays one CUDA graph of
    :func:`detect_batch` a card and frame shape, captured at the first batch
    (``runtime/graphs.py``), as the reference runs its jitted
    ``detect_batch``.  ``timer``, a stage timer (called with a stage name, it
    returns a context manager, as CUDA events around each stage), makes the
    dispatch run eagerly instead: events between the stages cannot be read
    from inside a graph.  The kernels and outputs are the same either way.
    """

    def __init__(self, cfg: PipelineConfig, templates: MeanMaskTemplates,
                 device="cuda", timer=None, mesh=None):
        from ..parallel.mesh import Mesh, explicit_device, sharded_detect_fn

        if mesh is None:
            mesh = Mesh((explicit_device(torch.device(device)),))
        elif cfg.batch_size % mesh.size:
            raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the "
                             f"mesh size {mesh.size}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.timer = timer
        self.red, self.blue = templates_to_torch(templates, self.device)
        self._detect = sharded_detect_fn(mesh, self._detect_packed)

    def _detect_packed(self, frames, red, blue) -> torch.Tensor:
        return _pack(*detect_batch(frames, red, blue, self.cfg, self.timer))

    def dispatch(self, frames: np.ndarray):
        """Enqueue one [B, H, W, 3] uint8 batch; returns a pending handle
        (the packed result's host tensor, the events that mark its arrival,
        and the tracer's batch, ``runtime/trace.py``, or None with it off).

        On a card each shard's frames are pinned and copied without blocking
        into its graph's input, its packed result is copied back into pinned
        memory without blocking, and an event a shard marks its arrival, so
        the caller can decode and upload the next batch meanwhile
        (:meth:`run_directory`).
        """
        from ..parallel.mesh import host_shards, to_host

        with TRACER.dispatch() as batch:
            with TRACER.span("pin"):
                shards = host_shards(self.mesh, frames)
            packed = self._detect(shards, self.red, self.blue, key=self.cfg,
                                  eager=self.timer is not None)
            with TRACER.span("to_host"):
                out, done = to_host(self.mesh, packed)
        return out, done, batch

    def collect(self, pending, names: list[str]) -> list[GroundTruthBox]:
        """Wait for a dispatched batch and unpad it into detection records."""
        out, done, batch = pending
        with TRACER.collect(batch):
            with TRACER.span("wait"):
                for event in done:
                    event.synchronize()
            TRACER.resolve(batch)
            with TRACER.span("unpack"):
                return unpack(out.numpy(), names)

    def detect_frames(self, frames: np.ndarray, names: list[str]) -> list[GroundTruthBox]:
        """Run a [B, H, W, 3] uint8 batch; unpad into detection records."""
        return self.collect(self.dispatch(frames), names)

    def run_directory(self, directory: str, progress: bool = False) -> list[GroundTruthBox]:
        """Detect over every frame in a dataset directory.

        The next batch is decoded on a background thread (``batched_frames``)
        and one dispatched batch stays in flight while the previous one is
        unpacked on the host.
        """
        files = list_frame_files(directory)
        bsz = self.cfg.batch_size
        detections: list[GroundTruthBox] = []
        done = 0
        pending = None
        for frames, names in batched_frames(directory, files, bsz):
            handle = self.dispatch(frames)
            if pending is not None:
                detections.extend(d for d in self.collect(*pending) if d.filename != "__pad__")
                done = min(done + bsz, len(files))
                if progress:
                    print(f"  processed {done}/{len(files)} frames")
            pending = (handle, names)
        if pending is not None:
            detections.extend(d for d in self.collect(*pending) if d.filename != "__pad__")
            if progress:
                print(f"  processed {len(files)}/{len(files)} frames")
        return detections
