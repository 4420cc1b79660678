"""Batched recognition inference: proposals -> HOG -> LDA heads / KNN on
the device.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/rec_pipeline.py``
(the test-set run the reference ships commented out, `Reconocimiento de
Objetos/main.py:64`): per frame, proposals of the REC variant (grow 1.15,
32x32 crops) from the MSER sweep or from the CNN detector's low-threshold
boxes are described and pushed through the six binary LDA heads (one
[6, 2, D] product) with the reference's arbitration, or through the LDA
reduction and the k-NN vote.  Every stage carries the batch dimension;
products run in full f32 (``models.detector.full_f32_matmuls``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import PipelineConfig
from ..constants import RECOG_CROP, RECOG_GROW
from ..data.gt import GroundTruthBox
from ..data.images import list_frame_files
from ..data.prefetch import batched_frames
from ..ops.color import bgr_to_gray
from ..ops.hog import gray_descriptors, hog_descriptors
from ..ops.mser import stage_scope
from ..ops.resident import const_f32
from ..ops.resize import crop_and_resize
from ..runtime.graphs import CapturedFn
from ..runtime.trace import TRACER
from .cnn_detector import net_tensors
from .detector import _pack, compact_first, full_f32_matmuls, pinned, unpack
from .knn import knn_vote
from .recognizer import SignClassifier, arbitrate_lda_heads, crop_proposals, mser_proposals


def _stack_heads(clf: SignClassifier) -> tuple[np.ndarray, np.ndarray]:
    """Six binary LDA heads -> (coefs [6, 2, D], intercepts [6, 2])."""
    coefs = np.stack([h.coef for h in clf.heads]).astype(np.float32)
    ints = np.stack([h.intercept for h in clf.heads]).astype(np.float32)
    return coefs, ints


def classify_crops_knn(feats, xbar, scalings, train_x, train_y, classes, k: int):
    """KNN path: LDA-reduce then k-NN majority vote.  [N, D] features ->
    (labels [N], confidence [N] = the winner's share of the k votes)."""
    reduced = (feats - xbar) @ scalings
    best, votes = knn_vote(reduced, train_x, train_y, classes, k)
    # the reference divides under jit: a product with the f32 reciprocal
    conf = votes.to(torch.float32) * const_f32(1.0 / k, feats.device)
    return classes[best].to(torch.int32), conf


def classify_crops_lda(feats, head_coefs, head_ints, tol: float, sign_margin: float = 0.0):
    """[N, D] features -> (labels [N] 0..6, confidence [N]): all six heads
    in one product, each head's probability the binary-LDA sigmoid of its
    class-score contrast, then the reference's arbitration."""
    scores = torch.einsum("nd,hcd->hnc", feats, head_coefs) + head_ints[:, None, :]
    p1 = torch.sigmoid(scores[..., 1] - scores[..., 0])  # [6, N]
    probs = torch.stack([1.0 - p1, p1], dim=-1)  # [6, N, 2]
    labels = arbitrate_lda_heads(probs, tol, sign_margin)
    conf = torch.amax(torch.maximum(probs[..., 0], probs[..., 1]), dim=0)
    sign_conf = torch.amax(torch.where(p1 >= const_f32(0.5 - sign_margin, p1.device), p1, 0.0),
                           dim=0)
    return labels, torch.where(labels > 0, sign_conf, conf)


def _classify(boxes, gray_crops, keep, clf_arrays, cfg: PipelineConfig, features: str,
              clf_kind: str, knn_k: int):
    """[B, N] proposals with their gray crops -> the first
    ``cfg.max_detections`` sign slots a frame: (boxes, labels, scores,
    valid).  Traced, all of it is the stage ``classify.scores``: the
    descriptors ``rec.hog``, the classifier with the compaction
    ``rec.heads``."""
    b, n = keep.shape
    with stage_scope(None, "classify.scores"):
        with stage_scope(None, "rec.hog"):
            flat = gray_crops.reshape(b * n, RECOG_CROP, RECOG_CROP)
            feats = hog_descriptors(flat) if features == "HOG" else gray_descriptors(flat)
        with stage_scope(None, "rec.heads"):
            if clf_kind == "LDABAYES":
                labels, conf = classify_crops_lda(feats, *clf_arrays, cfg.no_sign_tol,
                                                  cfg.sign_margin)
            else:
                labels, conf = classify_crops_knn(feats, *clf_arrays, knn_k)
            labels, conf = labels.reshape(b, n), conf.reshape(b, n)
            return compact_first(keep & (labels > 0), cfg.max_detections, boxes, labels, conf)


def recognize_batch(frames: torch.Tensor, clf_arrays, cfg: PipelineConfig, features: str,
                    clf_kind: str, knn_k: int = 4):
    """[B, H, W, 3] uint8 -> (boxes [B, D, 4] xyxy, labels [B, D],
    scores [B, D], valid [B, D]) from MSER proposals.  Traced, the crops,
    their dedup and the classifier are the stage ``classify``, as in
    ``detect_batch``."""
    full_f32_matmuls()
    props, pvalid = mser_proposals(frames, cfg.mser)
    with stage_scope(None, "classify"):
        boxes, gray_crops, keep = crop_proposals(frames, props, pvalid,
                                                 cfg.rec_grows or (RECOG_GROW,))
        return _classify(boxes, gray_crops, keep, clf_arrays, cfg, features, clf_kind, knn_k)


def recognize_frame(bgr: torch.Tensor, clf_arrays, cfg: PipelineConfig, features: str,
                    clf_kind: str = "LDABAYES", knn_k: int = 4):
    """One [H, W, 3] uint8 frame -> (boxes [D, 4] xyxy, labels [D], scores
    [D], valid [D]): :func:`recognize_batch` of a batch of one."""
    return tuple(x[0] for x in recognize_batch(bgr[None], clf_arrays, cfg, features,
                                               clf_kind, knn_k))


def grow_boxes_xyxy(boxes: torch.Tensor, valid: torch.Tensor, grow: float, frame_hw):
    """Float xyxy boxes -> grown (about the centre), clipped int32 xyxy, and
    the keep mask of boxes at least 2 px on each side: the REC-variant
    geometry (grow 1.15, `Reconocimiento de Objetos/source.py:54`) applied
    to detector-space boxes; half-open ints for ``crop_and_resize``."""
    h, w = (int(v) for v in frame_hw)
    b = boxes.to(torch.float32)
    x1, y1, x2, y2 = b.unbind(-1)
    half, g = const_f32(0.5, b.device), const_f32(grow, b.device)
    cx, cy = (x1 + x2) * half, (y1 + y2) * half
    bw, bh = (x2 - x1) * g, (y2 - y1) * g
    nx1 = torch.clamp(cx - bw * half, 0.0, w - 2.0)
    ny1 = torch.clamp(cy - bh * half, 0.0, h - 2.0)
    nx2 = torch.minimum(torch.maximum(cx + bw * half, nx1 + 1.0), const_f32(float(w), b.device))
    ny2 = torch.minimum(torch.maximum(cy + bh * half, ny1 + 1.0), const_f32(float(h), b.device))
    out = torch.stack([nx1, ny1, nx2, ny2], dim=-1).to(torch.int32)
    keep = valid & ((x2 - x1) >= 2) & ((y2 - y1) >= 2)
    return out, keep


def recognize_batch_cnn(frames: torch.Tensor, cnn, clf_arrays, cfg: PipelineConfig,
                        features: str, clf_kind: str, knn_k: int = 4):
    """CNN proposals -> grown 32x32 crops -> descriptors -> classifier, with
    the outputs of :func:`recognize_batch`.  The detector's route runs
    eagerly (``CNNDetector.detect``), so that a capture of this whole
    function holds it, as the reference's one jit holds the forward."""
    full_f32_matmuls()
    pboxes, _, _, pvalid = cnn.detect(frames)
    grow = (cfg.rec_grows or (RECOG_GROW,))[0]
    boxes, keep = grow_boxes_xyxy(pboxes, pvalid, grow, frames.shape[1:3])
    gray_crops = bgr_to_gray(crop_and_resize(frames, boxes, RECOG_CROP))
    return _classify(boxes, gray_crops, keep, clf_arrays, cfg, features, clf_kind, knn_k)


@dataclasses.dataclass
class RecognitionPipeline:
    """Host-facing recognizer over directories of frames.

    ``cnn`` (a ``CNNDetector``) switches the proposal source from the MSER
    sweep to the detector's low-threshold boxes and puts the pipeline on the
    detector's device; the classifier stack is the same.  On the card a
    batch is copied from pinned memory without blocking and its packed
    result copied back the same way, so the next batch is decoded meanwhile
    (two batches in flight: the copy back is enqueued before the next
    batch's replay can overwrite the graph's output, ``runtime/graphs.py``).
    """

    cfg: PipelineConfig
    classifier: SignClassifier
    cnn: object | None = None
    device: str = "cuda"

    def __post_init__(self):
        self._device = self.cnn.device if self.cnn is not None else torch.device(self.device)
        self._recognize = CapturedFn(self._recognize_packed)
        self._recognize_cnn = CapturedFn(self._recognize_cnn_packed)
        dev = self._device
        if self.classifier.config.classifier == "LDABAYES":
            self._kind = "LDABAYES"
            self._arrays = tuple(torch.from_numpy(a).to(dev)
                                 for a in _stack_heads(self.classifier))
        else:
            self._kind = "KNN"
            red, knn = self.classifier.reducer, self.classifier.knn
            self._arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                red.xbar.astype(np.float32), red.scalings.astype(np.float32),
                knn.train_x.astype(np.float32), knn.train_y.astype(np.int64),
                knn.classes.astype(np.int64)))

    def _spec(self) -> tuple:
        return (self.cfg, self.classifier.config.features, self._kind,
                self.classifier.config.knn_neighbors)

    def _recognize_packed(self, x, *arrays):
        return _pack(*recognize_batch(x, arrays, *self._spec()))

    def _recognize_cnn_packed(self, x, *consts):
        # consts: the classifier arrays, then the detector's net tensors
        arrays = consts[:len(self._arrays)]
        return _pack(*recognize_batch_cnn(x, self.cnn, arrays, *self._spec()))

    @torch.inference_mode()
    def dispatch(self, frames):
        """Enqueue one [B, H, W, 3] uint8 batch; returns a pending handle.

        On a card the batch replays one CUDA graph a card and frame shape,
        captured at the first batch (``runtime/graphs.py``), as the reference
        jits each: of :func:`recognize_batch` with MSER proposals, or of the
        whole :func:`recognize_batch_cnn` (the detector's forward and decode,
        the crops, the features and the classifier) with CNN proposals, keyed
        also by the detector's route (its net, threshold and ``upscale``)
        and holding its net's tensors as constants.

        The handle is (the packed result, the event that marks its arrival
        or None off a card, the tracer's batch or None with it off).  Traced
        (``runtime/trace.py``), the dispatch opens a batch with the spans of
        ``DetectionPipeline.dispatch``: ``pin``, the call's ``replay``,
        ``capture`` or ``eager``, and ``to_host``."""
        with TRACER.dispatch() as batch:
            with TRACER.span("pin"):
                x = pinned(frames, self._device)
            if self.cnn is not None:
                packed = self._recognize_cnn(
                    self._device, x, *self._arrays, *net_tensors(self.cnn.net),
                    key=(self._spec(), self.cnn.route(x)))
            else:
                packed = self._recognize(self._device, x, *self._arrays, key=self._spec())
            with TRACER.span("to_host"):
                if self._device.type != "cuda":
                    return packed, None, batch
                out = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                out.copy_(packed, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        return out, done, batch

    def collect(self, pending, names: list[str]) -> list[GroundTruthBox]:
        """Wait for a dispatched batch and unpad it into records (the spans
        ``collect`` ⊃ ``wait``, ``unpack`` of its traced batch)."""
        out, done, batch = pending
        with TRACER.collect(batch):
            with TRACER.span("wait"):
                if done is not None:
                    done.synchronize()
            TRACER.resolve(batch)
            with TRACER.span("unpack"):
                return unpack(out.numpy(), names)

    def recognize_frames(self, frames, names: list[str]) -> list[GroundTruthBox]:
        return self.collect(self.dispatch(frames), names)

    def run_directory(self, directory: str, progress: bool = False) -> list[GroundTruthBox]:
        """Recognize every frame of a directory: the next batch is decoded on
        a background thread and one dispatched batch stays in flight."""
        files = list_frame_files(directory)
        bsz = self.cfg.batch_size
        detections: list[GroundTruthBox] = []
        done = 0
        pending = None

        def drain(p):
            nonlocal done
            detections.extend(d for d in self.collect(*p) if d.filename != "__pad__")
            done = min(done + bsz, len(files))
            if progress:
                print(f"  processed {done}/{len(files)} frames")

        for frames, names in batched_frames(directory, files, bsz):
            handle = self.dispatch(frames)
            if pending is not None:
                drain(pending)
            pending = (handle, names)
        if pending is not None:
            drain(pending)
        return detections
