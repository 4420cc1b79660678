"""Práctica-2 recognition: training-data construction, classifiers, harness.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/recognizer.py``
(reference `Reconocimiento de Objetos/source.py:350-482,485-641,646-809`):

* positives: GT boxes cropped from the gray train frames, resized 32x32;
* negatives (class 0): proposals of the REC detector variant (grow 1.15,
  32x32 crops) whose max IoU against their frame's GT is <= 0.5, from the
  MSER sweep batched on the device or from the CNN detector; proposals are
  cached in an .npz whose layout and tag both packages share, so a cache
  written by either is read by the other;
* features: HOG (324-d) or GRAY (1024-d) descriptors on the device;
* LDABAYES (six binary LDA heads, the reference's arbitration) or KNN (a
  7-class LDA reduction, then 4-NN majority vote);
* the validation harness: per-class shuffle, 90/10 split, fit, predict,
  confusion matrix + classification report.

With a data mesh (``run_validation(mesh=...)``) the LDABAYES heads are fit
from statistics summed over the mesh's shards
(``parallel/train.py: fit_classifier_distributed``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re

import numpy as np
import torch

from ..config import ClassifierConfig, MSERConfig
from ..constants import (
    DEDUP_COORD_TOL,
    DEDUP_HIST_TOL,
    NEGATIVE_IOU_MAX,
    RECOG_CROP,
    RECOG_GROW,
    SIGN_NAMES,
)
from ..data.gt import load_ground_truth
from ..data.images import list_frame_files, load_image_bgr
from ..data.prefetch import batched_frames
from ..eval.reports import classification_report, confusion_matrix
from ..ops.color import bgr_to_gray
from ..ops.dedup import dedup_by_coords, dedup_by_histogram
from ..ops.geometry import filter_and_grow_boxes, iou_matrix
from ..ops.hog import gray_descriptors, hog_descriptors
from ..ops.mser import mser_regions, stage_scope
from ..ops.preprocess import enhance_contrast
from ..ops.resident import const_f32
from ..ops.resize import crop_and_resize
from .detector import full_f32_matmuls, upload
from .knn import KNNParams, knn_fit, knn_predict
from .lda import LDAParams, lda_fit, lda_predict_proba, lda_transform

PROPOSAL_CACHE_VERSION = 1


# ---------------------------------------------------------------------------
# Proposal extraction (the REC-variant detector) + cache artifact
# ---------------------------------------------------------------------------

def propose_batch(frames: torch.Tensor, cfg: MSERConfig,
                  grows: tuple[float, ...] = (RECOG_GROW,)):
    """[B, H, W, 3] uint8 -> (boxes [B, N, 4] xyxy, gray crops [B, N, 32, 32],
    valid [B, N]): MSER proposals grown by each factor of ``grows`` (their
    union), cropped, deduplicated: :func:`crop_proposals` of
    :func:`mser_proposals`."""
    return crop_proposals(frames, *mser_proposals(frames, cfg), grows)


def mser_proposals(frames: torch.Tensor, cfg: MSERConfig):
    """[B, H, W, 3] uint8 -> the MSER regions of the contrast-enhanced gray
    frames, (boxes [B, N, 4], valid [B, N]).  Inside a traced call
    (``runtime/trace.py``) the stages ``preprocess`` and ``mser_regions``'
    own are stamped."""
    with stage_scope(None, "preprocess"):
        gray = enhance_contrast(frames)
    return mser_regions(gray, cfg)


def crop_proposals(frames: torch.Tensor, props: torch.Tensor, pvalid: torch.Tensor,
                   grows: tuple[float, ...]):
    """The regions ``props`` [B, N, 4] grown by each factor of ``grows``,
    cropped from ``frames``, deduplicated -> (boxes, gray crops [B, N', 32,
    32], valid).  The reference jits this, so the crops' sample step
    multiplies by the reciprocal of the crop size.  Traced, the stages are
    the main path's: ``classify.crops``, ``classify.dedup``, and
    ``classify.scores`` ⊃ ``rec.hog`` (the crops' gray, the descriptors'
    first step)."""
    with stage_scope(None, "classify.crops"):
        per_grow = [filter_and_grow_boxes(props, pvalid, g) for g in grows]
        boxes = torch.cat([b for b, _ in per_grow], dim=1)
        keep = torch.cat([k for _, k in per_grow], dim=1)
        crops = crop_and_resize(frames, boxes, RECOG_CROP)
    with stage_scope(None, "classify.dedup"):
        crops, boxes, keep = dedup_by_histogram(crops, boxes, keep, DEDUP_HIST_TOL)
        crops, boxes, keep = dedup_by_coords(crops, boxes, keep, DEDUP_COORD_TOL)
    with stage_scope(None, "classify.scores"), stage_scope(None, "rec.hog"):
        gray_crops = bgr_to_gray(crops)
    return boxes, gray_crops, keep


def _load_cache(cache_path: str | None, tag: str, files: list[str]):
    """{fname: (boxes, crops)} from a cache whose tag matches, else None."""
    if not (cache_path and os.path.exists(cache_path)):
        return None
    z = np.load(cache_path, allow_pickle=False)
    if str(z.get("tag")) != tag:
        return None
    return {f: (z[f"boxes_{f.replace('.', '_')}"], z[f"crops_{f.replace('.', '_')}"])
            for f in files}


def _save_cache(cache_path: str | None, tag: str, out: dict) -> None:
    if not cache_path:
        return
    payload = {"tag": np.asarray(tag)}
    for f, (b, c) in out.items():
        key = f.replace(".", "_")
        payload[f"boxes_{key}"] = b
        payload[f"crops_{key}"] = c
    np.savez_compressed(cache_path, **payload)


def _mine(train_dir: str, files: list[str], batch_size: int, device, fn, label: str):
    """Run ``fn(device frames) -> (boxes, crops, keep)`` over ``files`` with
    decode-ahead; -> {fname: (boxes [n,4] int32, crops [n,32,32] uint8)}."""
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    with torch.inference_mode():
        for start, (frames, names) in zip(range(0, len(files), batch_size),
                                          batched_frames(train_dir, files, batch_size)):
            if start and start % (batch_size * 10) == 0:
                print(f"  {label}: {start}/{len(files)} frames", flush=True)
            boxes, crops, keep = (t.cpu().numpy() for t in fn(upload(frames, device)))
            for i, f in enumerate(names):
                if f != "__pad__":
                    out[f] = (boxes[i][keep[i]], crops[i][keep[i]])
    return out


def extract_train_proposals(
    train_dir: str,
    cfg: MSERConfig,
    cache_path: str | None = None,
    batch_size: int = 8,
    limit: int | None = None,
    grows: tuple[float, ...] = (RECOG_GROW,),
    device="cuda",
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """MSER proposals for every train frame: {fname: (boxes, gray_crops)},
    memoized to ``cache_path`` (.npz) under the reference's tag."""
    files = list_frame_files(train_dir)
    if limit is not None:
        files = files[:limit]
    grow_tag = ",".join(f"{g:g}" for g in grows)
    tag = (f"v{PROPOSAL_CACHE_VERSION}:{cfg.to_string()}:"
           f"ds{cfg.downscale}:g{grow_tag}:{len(files)}")
    cached = _load_cache(cache_path, tag, files)
    if cached is not None:
        return cached
    out = _mine(train_dir, files, batch_size, device,
                lambda x: propose_batch(x, cfg, grows), "proposals")
    _save_cache(cache_path, tag, out)
    return out


def extract_train_proposals_cnn(
    train_dir: str,
    cnn_detector,
    cache_path: str | None = None,
    batch_size: int = 8,
    limit: int | None = None,
    grow: float = RECOG_GROW,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """CNN low-threshold proposals for every train frame, with the contract
    of :func:`extract_train_proposals`: boxes grown by ``grow`` and their
    32x32 gray crops, on the detector's device."""
    from .rec_pipeline import grow_boxes_xyxy

    files = list_frame_files(train_dir)
    if limit is not None:
        files = files[:limit]
    det = cnn_detector
    tag = (f"cnn-v1:{params_digest(det)}:thr{det.cfg.score_threshold:g}:"
           f"k{det.cfg.max_detections}:g{grow:g}:{len(files)}")
    cached = _load_cache(cache_path, tag, files)
    if cached is not None:
        return cached

    def crops_for(frames):
        pboxes, _, _, pvalid = det.dispatch(frames)
        gb, keep = grow_boxes_xyxy(pboxes, pvalid, grow, frames.shape[1:3])
        return gb, bgr_to_gray(crop_and_resize(frames, gb, RECOG_CROP)), keep

    out = _mine(train_dir, files, batch_size, det.device, crops_for, "cnn proposals")
    _save_cache(cache_path, tag, out)
    return out


def params_digest(det) -> str:
    """Short content digest of a CNN detector's float parameters (cache
    keying): the reference's ``tree_leaves`` order (sorted keys at every
    level of the flax tree), each leaf's bytes in the flax layout.  The
    int8 detector has no float parameters, as in the reference."""
    from .cnn_detector import flat_params

    h = hashlib.sha256()
    net = getattr(det, "net", None)
    if isinstance(net, torch.nn.Module):
        flat = flat_params(net)
        for key in sorted(flat, key=lambda k: tuple(re.findall(r"\['([^']*)'\]", k))):
            h.update(np.asarray(flat[key]).tobytes())
    return h.hexdigest()[:12]


# ---------------------------------------------------------------------------
# Training-set assembly
# ---------------------------------------------------------------------------

def build_training_data(
    train_dir: str,
    gt_path: str | None = None,
    mser_cfg: MSERConfig | None = None,
    cache_path: str | None = None,
    limit: int | None = None,
    seed: int = 0,
    proposal_positives: bool = False,
    grows: tuple[float, ...] = (RECOG_GROW,),
    proposals: dict[str, tuple[np.ndarray, np.ndarray]] | None = None,
    device="cuda",
) -> dict[int, np.ndarray]:
    """Class-keyed crops {0..6: [M, 32, 32] uint8 gray}, per-class shuffled.

    Class 0 = mined negatives, classes 1..6 = GT positives.  ``proposals``
    overrides the MSER proposal source with a prebuilt {fname: (boxes,
    crops)} dict.  ``proposal_positives=True`` also labels proposals with
    IoU > 0.5 against a GT box as positives of that box's class (the
    reference drops them)."""
    gt_path = gt_path or os.path.join(train_dir, "gt.txt")
    mser_cfg = mser_cfg or MSERConfig()
    gt = load_ground_truth(gt_path, drop_unmapped=True)
    files = set(list_frame_files(train_dir) if limit is None
                else list_frame_files(train_dir)[:limit])
    gt = [g for g in gt if g.filename in files]

    by_frame: dict[str, list] = {}
    for g in gt:
        by_frame.setdefault(g.filename, []).append(g)

    data: dict[int, list[np.ndarray]] = {c: [] for c in range(7)}

    # positives: gray full-frame crops resized 32x32, the gray conversion on
    # the host (cv2's fixed-point formula) and one padded device call for
    # all crops.  The reference maps this call without jit, so the sample
    # step divides by the crop size.
    raw_crops: list[np.ndarray] = []
    crop_classes: list[int] = []
    for fname in sorted(by_frame):
        bgr = load_image_bgr(os.path.join(train_dir, fname)).astype(np.int32)
        gray = ((bgr[..., 2] * 9798 + bgr[..., 1] * 19235 + bgr[..., 0] * 3735
                 + (1 << 14)) >> 15).astype(np.uint8)
        hh, ww = gray.shape
        for g in by_frame[fname]:
            y1, y2 = max(g.y1, 0), min(max(g.y2, g.y1 + 1), hh)
            x1, x2 = max(g.x1, 0), min(max(g.x2, g.x1 + 1), ww)
            raw_crops.append(gray[y1:y2, x1:x2])
            crop_classes.append(g.class_id)
    if raw_crops:
        hp = -(-max(c.shape[0] for c in raw_crops) // 32) * 32
        wp = -(-max(c.shape[1] for c in raw_crops) // 32) * 32
        buf = np.zeros((len(raw_crops), hp, wp), np.uint8)
        boxes = np.zeros((len(raw_crops), 1, 4), np.int32)
        for i, c in enumerate(raw_crops):
            buf[i, : c.shape[0], : c.shape[1]] = c
            boxes[i, 0] = (0, 0, c.shape[1], c.shape[0])
        with torch.inference_mode():
            resized = crop_and_resize(upload(buf, device), upload(boxes, device), RECOG_CROP,
                                      reciprocal=False)[:, 0].cpu().numpy()
        for cls, crop in zip(crop_classes, resized):
            data[cls].append(crop)

    # negatives: proposals with max IoU <= 0.5 against same-frame GT
    if proposals is None:
        proposals = extract_train_proposals(train_dir, mser_cfg, cache_path=cache_path,
                                            limit=limit, grows=grows, device=device)
    for fname, (boxes, crops) in proposals.items():
        if len(boxes) == 0:
            continue
        gts = by_frame.get(fname, [])
        if gts:
            gt_boxes = np.array([[g.x1, g.y1, g.x2, g.y2] for g in gts], np.int32)
            ious = iou_matrix(torch.from_numpy(np.asarray(boxes)),
                              torch.from_numpy(gt_boxes)).numpy()
            best = ious.max(axis=1)
            neg_mask = best <= NEGATIVE_IOU_MAX
            if proposal_positives:
                pos_mask = best > NEGATIVE_IOU_MAX
                pos_cls = np.array([gts[j].class_id for j in ious.argmax(axis=1)])
                for c, cls in zip(crops[pos_mask], pos_cls[pos_mask]):
                    data[int(cls)].append(c)
        else:
            neg_mask = np.ones(len(boxes), bool)
        for c in crops[neg_mask]:
            data[0].append(c)

    rng = np.random.default_rng(seed)
    out: dict[int, np.ndarray] = {}
    for c in range(7):
        arr = (np.stack(data[c]) if data[c]
               else np.zeros((0, RECOG_CROP, RECOG_CROP), np.uint8))
        rng.shuffle(arr, axis=0)
        out[c] = arr
    return out


def split_validation(
    data: dict[int, np.ndarray], pct: float
) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray]]:
    """Per-class ordered split: first (1-pct) train, last pct validation."""
    train, val = {}, {}
    for c, arr in data.items():
        n_val = int(np.ceil(len(arr) * pct)) if len(arr) else 0
        cut = len(arr) - n_val
        train[c], val[c] = arr[:cut], arr[cut:]
    return train, val


def compute_features(crops: np.ndarray, features: str, device="cuda") -> np.ndarray:
    """[M, 32, 32] uint8 -> [M, D] float32 (HOG 324-d or GRAY 1024-d).

    The batch is zero-padded to the next power of two (min 64), as the
    reference pads it, so the card sees few distinct shapes."""
    if len(crops) == 0:
        d = 324 if features == "HOG" else RECOG_CROP * RECOG_CROP
        return np.zeros((0, d), np.float32)
    fn = hog_descriptors if features == "HOG" else gray_descriptors
    m = len(crops)
    cap = max(64, 1 << (m - 1).bit_length())
    if cap != m:
        crops = np.concatenate([crops, np.zeros((cap - m,) + crops.shape[1:], crops.dtype)])
    full_f32_matmuls()
    with torch.inference_mode():
        return fn(upload(crops, device)).cpu().numpy()[:m]


def compute_features_dict(data: dict[int, np.ndarray], features: str,
                          device="cuda") -> dict[int, np.ndarray]:
    """Per-class descriptor dict via one device call over every class."""
    sizes = {c: len(v) for c, v in data.items()}
    if sum(sizes.values()) == 0:
        return {c: compute_features(v, features, device) for c, v in data.items()}
    all_crops = np.concatenate([data[c] for c in sorted(data) if sizes[c]])
    feats = compute_features(all_crops, features, device)
    out: dict[int, np.ndarray] = {}
    off = 0
    for c in sorted(data):
        out[c] = feats[off : off + sizes[c]]
        off += sizes[c]
    return out


# ---------------------------------------------------------------------------
# Classifiers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SignClassifier:
    """Trained recognition model: six binary LDA heads or LDA+KNN.  Its
    directory layout is the reference's, so either package reads a model
    the other saved."""

    config: ClassifierConfig
    heads: list[LDAParams] | None = None  # LDABAYES: one per super-type
    reducer: LDAParams | None = None  # KNN path
    knn: KNNParams | None = None
    # the proposal distribution the training data was mined with
    # (informational; inference should keep its proposal config matched)
    proposal_spec: str | None = None

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.txt"), "w") as f:
            f.write(self.config.to_string())
        if self.proposal_spec:
            with open(os.path.join(path, "proposal.txt"), "w") as f:
                f.write(self.proposal_spec)
        if self.heads:
            present = []
            for i, h in enumerate(self.heads):
                if h is not None:
                    h.save(os.path.join(path, f"head_{i + 1}.npz"))
                    present.append(str(i + 1))
            # manifest of the heads meant to be present: load() raises on a
            # listed file that is missing
            with open(os.path.join(path, "heads.txt"), "w") as f:
                f.write(",".join(present))
        if self.reducer:
            self.reducer.save(os.path.join(path, "reducer.npz"))
        if self.knn:
            self.knn.save(os.path.join(path, "knn.npz"))

    @classmethod
    def load(cls, path: str) -> "SignClassifier":
        with open(os.path.join(path, "config.txt")) as f:
            config = ClassifierConfig.from_string(f.read().strip())
        heads = reducer = knn = None
        if config.classifier == "LDABAYES":
            manifest_path = os.path.join(path, "heads.txt")
            expected = None
            if os.path.exists(manifest_path):
                with open(manifest_path) as f:
                    txt = f.read().strip()
                expected = {int(s) for s in txt.split(",")} if txt else set()
            heads = []
            for i in range(6):
                hp = os.path.join(path, f"head_{i + 1}.npz")
                exists = os.path.exists(hp)
                if expected is not None and (i + 1) in expected and not exists:
                    raise FileNotFoundError(
                        f"classifier artifact at {path} is corrupt: manifest "
                        f"heads.txt lists head {i + 1} but {hp} is missing")
                heads.append(LDAParams.load(hp) if exists else None)
        else:
            reducer = LDAParams.load(os.path.join(path, "reducer.npz"))
            knn = KNNParams.load(os.path.join(path, "knn.npz"))
        spec_path = os.path.join(path, "proposal.txt")
        proposal_spec = None
        if os.path.exists(spec_path):
            with open(spec_path) as f:
                proposal_spec = f.read().strip()
        return cls(config=config, heads=heads, reducer=reducer, knn=knn,
                   proposal_spec=proposal_spec)


def fit_classifier(features_by_class: dict[int, np.ndarray],
                   config: ClassifierConfig) -> SignClassifier:
    """Train the recognition model on class-keyed descriptor arrays (host)."""
    if config.classifier == "LDABAYES":
        heads = []
        negatives = features_by_class[0]
        for t in range(1, 7):
            pos = features_by_class[t]
            if len(pos) == 0:
                # no positives for this super-type: a None head predicts
                # background with probability 1
                heads.append(None)
                continue
            X = np.concatenate([negatives, pos])
            y = np.concatenate([np.zeros(len(negatives)), np.full(len(pos), t)])
            heads.append(lda_fit(X, y))
        return SignClassifier(config=config, heads=heads)

    X = np.concatenate([features_by_class[c] for c in range(7)])
    y = np.concatenate([np.full(len(features_by_class[c]), c) for c in range(7)])
    reducer = lda_fit(X, y)
    reduced = lda_transform(reducer, X).numpy()
    knn = knn_fit(reduced, y, k=config.knn_neighbors)
    return SignClassifier(config=config, reducer=reducer, knn=knn)


def arbitrate_lda_heads(probs: torch.Tensor, tol: float,
                        sign_margin: float = 0.0) -> torch.Tensor:
    """The reference's extractBestPredictions rule, vectorized
    (`Reconocimiento de Objetos/source.py:627-641`).

    probs: [6, N, 2] per-head (background, sign) probabilities.  A head
    asserts its sign when p_sign >= p_background (``sign_margin`` > 0:
    p_sign >= 0.5 - margin) with confidence above ``tol``; no asserting
    head -> class 0, else the most confident sign head (the first on ties).
    Every threshold is rounded to f32 first, as the reference's weak
    scalars are.
    """
    no_sign_p, sign_p = probs[..., 0], probs[..., 1]
    if sign_margin > 0.0:
        head_says_sign = sign_p >= const_f32(0.5 - sign_margin, probs.device)
        head_conf = torch.where(head_says_sign, sign_p, no_sign_p)
        asserted = head_says_sign & (head_conf > const_f32(tol - sign_margin, probs.device))
    else:
        head_says_sign = sign_p >= no_sign_p  # ties -> sign
        head_conf = torch.maximum(no_sign_p, sign_p)
        asserted = head_says_sign & (head_conf > const_f32(tol, probs.device))
    any_sign = torch.any(asserted, dim=0)
    score = torch.where(head_says_sign, head_conf, const_f32(float("-inf"), probs.device))
    best_head = torch.argmax(score, dim=0)
    return torch.where(any_sign, best_head + 1, 0).to(torch.int32)


def predict_classifier(clf: SignClassifier, X: np.ndarray, no_sign_tol: float = 0.5,
                       device="cuda") -> np.ndarray:
    """[N, D] descriptors -> [N] predicted classes 0..6."""
    if len(X) == 0:
        return np.zeros((0,), np.int32)
    full_f32_matmuls()
    with torch.inference_mode():
        x = upload(np.asarray(X, np.float32), device)
        if clf.config.classifier == "LDABAYES":
            always_bg = torch.tensor([1.0, 0.0], device=x.device).expand(len(X), 2)
            probs = torch.stack([lda_predict_proba(h, x) if h is not None else always_bg
                                 for h in clf.heads])  # [6, N, 2]
            return arbitrate_lda_heads(probs, no_sign_tol).cpu().numpy()
        reduced = lda_transform(clf.reducer, x)
        return knn_predict(clf.knn, reduced).cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Validation harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ValidationResult:
    confusion: np.ndarray
    report: str
    accuracy: float
    y_true: np.ndarray
    y_pred: np.ndarray
    classifier: SignClassifier


def run_validation(
    train_dir: str,
    mser_cfg: MSERConfig | None = None,
    clf_cfg: ClassifierConfig | None = None,
    validation_pct: float = 0.1,
    no_sign_tol: float = 0.5,
    cache_path: str | None = None,
    limit: int | None = None,
    seed: int = 0,
    verbose: bool = False,
    mesh=None,
    proposal_positives: bool = False,
    grows: tuple[float, ...] = (RECOG_GROW,),
    proposals: dict[str, tuple[np.ndarray, np.ndarray]] | None = None,
    device="cuda",
) -> ValidationResult:
    """Train on (1-pct) of the per-class data, validate on the held-out pct.
    With ``mesh`` (``parallel.mesh.data_mesh``), LDABAYES heads are fit from
    statistics summed over the mesh's shards."""
    mser_cfg = mser_cfg or MSERConfig()
    clf_cfg = clf_cfg or ClassifierConfig()

    if verbose:
        print("building training data (positives + mined negatives)...")
    data = build_training_data(
        train_dir, mser_cfg=mser_cfg, cache_path=cache_path, limit=limit, seed=seed,
        proposal_positives=proposal_positives, grows=grows, proposals=proposals,
        device=device)
    train, val = split_validation(data, validation_pct)

    if verbose:
        print(f"class sizes: { {c: len(v) for c, v in data.items()} }")
        print(f"computing {clf_cfg.features} descriptors...")
    train_feats = compute_features_dict(train, clf_cfg.features, device)
    val_feats = compute_features_dict(val, clf_cfg.features, device)

    if verbose:
        print(f"fitting {clf_cfg.classifier} ..."
              + (f" (SPMD over {mesh.shards} devices)" if mesh else ""))
    if mesh is not None:
        from ..parallel.train import fit_classifier_distributed

        clf = fit_classifier_distributed(train_feats, clf_cfg, mesh)
    else:
        clf = fit_classifier(train_feats, clf_cfg)

    Xv = np.concatenate([val_feats[c] for c in range(7)])
    yv = np.concatenate([np.full(len(val_feats[c]), c) for c in range(7)])
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(len(yv))
    Xv, yv = Xv[perm], yv[perm]

    clf.proposal_spec = (
        f"{mser_cfg.to_string()};max_regions={mser_cfg.max_regions};"
        f"downscale={mser_cfg.downscale};"
        f"grows={','.join(f'{g:g}' for g in grows)}"
    )
    y_pred = predict_classifier(clf, Xv, no_sign_tol, device)
    labels = list(range(7))
    cm = confusion_matrix(yv, y_pred, labels)
    rep = classification_report(yv, y_pred, labels, target_names=list(SIGN_NAMES))
    acc = float((yv == y_pred).mean()) if len(yv) else 0.0
    return ValidationResult(confusion=cm, report=rep, accuracy=acc, y_true=yv, y_pred=y_pred,
                            classifier=clf)
