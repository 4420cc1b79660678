"""Plain PyTorch reference of práctica 2's recognition forward pass at the
CLI's defaults (``main_recognition_torch.py --detector MSER_7_200_2000_1
--classifier HOG_LDA_BAYES --run_test``).

BGR frames [B, H, W, 3] uint8 -> per frame its records (x1, y1, x2, y2,
label, score): gray, CLAHE, blur and gamma; the level-by-level MSER sweep at
full resolution with pixel-count stability; the exact top-k over every
level's map; the seed-flood refine; the 1.15 grow; 32x32 crops on OpenCV's
INTER_LINEAR grid; the histogram and coordinate dedups; the crops' gray;
HOG (Dalal & Triggs, CVPR 2005, in cv2.HOGDescriptor's 32x32 layout); six
binary LDA heads, the course code's arbitration and the compaction.

It imports nothing of the program.  The stages that the detection path
shares (gray, CLAHE, blur, gamma, the polarity stack, the refine flood, the
grow, the crops and both dedups) are the MSER reference's own plain
functions (``benchmark/reference/mser.py``); the sweep, the top-k, HOG and
the heads are written out here.  Every op is a plain tensor op, on the CPU
or on a card.  Both TF32 flags are False.  ``tf32=True`` is the benchmark's
control, one precision below the configuration's float32 with TF32 off: the
operands of HOG's cell contraction and of the heads' product are rounded to
TF32 as a tensor core takes them (10 bits of mantissa) and summed in f32,
whatever kernel the product runs on (a matrix-vector product or a small one
never runs in TF32 on the card, flags or not).

Departures from the course code (`Reconocimiento de Objetos/source.py`), as
the port makes them and so as this reference must:

* MSER is the level sweep, not OpenCV's component tree: a threshold every
  ``delta`` levels, components found by ``ccl_iters`` masked 4-neighbour
  min passes (wrapping) then a pointer jump, twice a level, so a component
  wider than the passes reach may split; stability is the relative change
  of each component's pixel count over ``delta`` levels, read at the
  component's anchor pixel (its darkest, then first, pixel); the
  ``max_regions`` most stable regions a frame, most stable first.
* The heads' probabilities are each head's two-class LDA posterior as the
  sigmoid of its score contrast; a record's score is the largest sign
  probability at or above 0.5 over the heads.
* At most ``max_detections`` records a frame, in proposal order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import mser as det

RECOG_CROP = 32
# HOG: 32x32 window, 16x16 blocks at a stride of 8, 8x8 cells, 9 signed bins
HOG_BLOCK, HOG_STRIDE, HOG_CELL, HOG_BINS = 16, 8, 8, 9
HOG_BLOCKS = (RECOG_CROP - HOG_BLOCK) // HOG_STRIDE + 1   # 3 a side
HOG_DIM = HOG_BLOCKS * HOG_BLOCKS * 4 * HOG_BINS           # 324


@dataclasses.dataclass(frozen=True)
class Params:
    """The settings of a recognition configuration."""

    delta: int
    min_area: int
    max_area: int
    max_variation: float
    min_diversity: float
    level_step: int
    ccl_iters: int
    ccl_jumps: int
    max_regions: int
    refine_scan_passes: int
    rec_grows: tuple
    no_sign_tol: float
    max_detections: int

    @classmethod
    def from_config(cls, c: dict) -> "Params":
        if c["downscale"] != 1 or c["refine_scan_passes"] <= 0:
            raise ValueError("the reference implements the full-resolution level sweep with "
                             "the seed-flood refine only")
        fields = {f.name: c[f.name] for f in dataclasses.fields(cls)}
        fields["rec_grows"] = tuple(c["rec_grows"])
        return cls(**fields)


def levels(p: Params) -> tuple[int, int, int]:
    """(level step, delta in steps, the number of levels swept)."""
    s = p.level_step if p.level_step > 0 else p.delta
    d = max(1, round(p.delta / s))
    return s, d, len(range(0, 256 + (d + 1) * s + 1, s))


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32's 10 bits of mantissa, the nearest, ties
    away from zero (an operand of a product with TF32 on)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def load_heads(directory: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The six heads of a saved LDABAYES classifier: (coefs [6, 2, D],
    intercepts [6, 2]) f32, read from its ``head_<i>.npz`` files."""
    coefs, ints = [], []
    for i in range(1, 7):
        with np.load(f"{directory}/head_{i}.npz") as z:
            coefs.append(np.asarray(z["coef"], np.float32))
            ints.append(np.asarray(z["intercept"], np.float32))
    return (torch.from_numpy(np.stack(coefs)).to(device),
            torch.from_numpy(np.stack(ints)).to(device))


# ---------------------------------------------------------------- sweep


def _propagate(keys, mask, big, passes: int, jumps: int):
    """Two rounds of ``passes`` masked 4-neighbour min passes (wrapping),
    each followed by ``jumps`` pointer jumps (a key takes the key of the
    pixel its low bits name, where that is smaller)."""
    b, p, h, w = keys.shape
    hw = h * w
    k = torch.where(mask, keys, big)
    rounds = 2 if jumps else 1
    for _ in range(rounds):
        for _ in range(passes if jumps else 2 * passes):
            k = torch.where(mask, torch.minimum(k, det.nb4(k, torch.minimum)), big)
        for _ in range(jumps):
            flat = k.reshape(b * p, hw)
            other = torch.gather(flat, 1, (flat % hw).long())
            k = torch.where(flat < big, torch.minimum(flat, other), big).reshape(b, p, h, w)
    return k


def sweep_topk(im2: torch.Tensor, p: Params):
    """The level sweep over padded polarity stacks [B, 2, H, W] uint8 and the
    ``max_regions`` most stable candidates of each frame over every level,
    the lower flat index (level, polarity, pixel) first among equals.
    -> (seeds_yx [B, N, 2], level_vals [B, N], pol_idx [B, N], valid [B, N])."""
    b, pol, h, w = im2.shape
    hw, per_level = h * w, pol * h * w
    dev = im2.device
    s, d, n_levels = levels(p)
    big = 256 * hw
    im = im2.to(torch.int32)
    pix = torch.arange(hw, dtype=torch.int32, device=dev).reshape(h, w)
    keys0 = im * hw + pix
    plane = torch.arange(b * pol, device=dev).reshape(b, pol, 1, 1) * hw
    f32 = torch.float32
    max_var = torch.tensor(p.max_variation, dtype=f32, device=dev)
    min_div = torch.tensor(p.min_diversity, dtype=f32, device=dev)
    keys = torch.full_like(keys0, big)
    area = [torch.zeros(im.shape, dtype=torch.int32, device=dev) for _ in range(d + 1)]
    var = [torch.full(im.shape, math.inf, dtype=f32, device=dev)] * 2
    last = torch.zeros(im.shape, dtype=f32, device=dev)
    found = []   # (frame, byte, flat index) of every candidate
    for t in range(n_levels):
        mask = im <= t * s
        keys = _propagate(torch.where(mask, torch.minimum(keys, keys0), big), mask, big,
                          p.ccl_iters, p.ccl_jumps)
        # each component's pixel count, at its anchor pixel
        anchor = (plane + keys % hw)[mask]
        counts = torch.bincount(anchor.long(), minlength=b * pol * hw)
        a_t = counts.reshape(im.shape).clamp(max=65535).to(torch.int32)
        a_prev = area[1].to(f32)   # the count delta levels before
        v_t = torch.where((a_prev > 0) & (a_t > 0),
                          (a_t.to(f32) - a_prev) / torch.clamp(a_prev, min=1.0), math.inf)
        # the candidates of level t - d - 1: stable against both neighbours
        a_c, v_c = area[0], var[1]
        a_cf = a_c.to(f32)
        cand = ((a_c >= p.min_area) & (a_c <= p.max_area) & (v_c < max_var)
                & (v_c <= var[0]) & (v_c <= v_t)
                & ((last <= 0) | (a_cf - last >= min_div * torch.clamp(a_cf, min=1.0))))
        last = torch.where(cand, a_cf, last)
        byte = torch.clamp(254.0 - torch.floor(v_c * 253.0), 1.0, 254.0).to(torch.uint8)
        fi, pi, yi, xi = torch.nonzero(cand, as_tuple=True)
        found.append((fi, byte[fi, pi, yi, xi].long(), t * per_level + pi * hw + yi * w + xi))
        area = area[1:] + [a_t]
        var = [var[1], v_t]
    frame = torch.cat([f for f, _, _ in found])
    value = torch.cat([v for _, v, _ in found])
    flat = torch.cat([x for _, _, x in found])
    n = p.max_regions
    seeds = torch.zeros((b, n, 2), dtype=torch.long, device=dev)
    level_vals = torch.zeros((b, n), dtype=torch.long, device=dev)
    pol_idx = torch.zeros((b, n), dtype=torch.long, device=dev)
    valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for i in range(b):
        v, x = value[frame == i], flat[frame == i]
        order = torch.sort(x, stable=True).indices
        order = order[torch.sort(v[order], descending=True, stable=True).indices][:n]
        k = len(order)
        t_idx, rem = x[order] // per_level, x[order] % per_level
        q = rem % hw
        seeds[i, :k, 0], seeds[i, :k, 1] = q // w, q % w
        pol_idx[i, :k] = rem // hw
        level_vals[i, :k] = torch.clamp(t_idx * s - (d + 1) * s, min=0)
        valid[i, :k] = True
    return seeds, level_vals, pol_idx, valid


def mser_regions(gray: torch.Tensor, p: Params):
    """[B, H, W] uint8 -> (boxes_xywh int32 [B, N, 4], valid [B, N]): the
    sweep's candidates, each refined by its seed's flood in a 128-px window
    (the valid ones only: the others' boxes are 0)."""
    im2 = det.pad_pol(gray)
    seeds, level_vals, polarity, valid = sweep_topk(im2, p)
    b, _, h, w = im2.shape
    win_h, win_w = min(det._WIN, h), min(det._WIN, w)
    big = win_h * win_w + 1
    planes = im2.reshape(b * 2, h, w)
    plane = (torch.arange(b, device=gray.device)[:, None] * 2 + polarity)[valid]
    y, x = seeds[valid].unbind(-1)
    y0 = torch.clamp(y - win_h // 2, 0, max(h - win_h, 0))
    x0 = torch.clamp(x - win_w // 2, 0, max(w - win_w, 0))
    cand = torch.stack([plane, y0, x0, y - y0, x - x0, level_vals[valid]], dim=-1)
    out = det.flood_bbox(planes, cand.to(torch.int32), win_h, win_w, p.refine_scan_passes, big)
    ymin, ymax, xmin, xmax, _ = out.long().unbind(-1)
    boxes = torch.zeros(valid.shape + (4,), dtype=torch.int32, device=gray.device)
    boxes[valid] = torch.stack([x0 + xmin - 1, y0 + ymin - 1, xmax - xmin + 1,
                                ymax - ymin + 1], dim=-1).to(torch.int32)
    return boxes, valid


# ---------------------------------------------------------------- HOG


def _cell_weights() -> np.ndarray:
    """[256, 4]: the weight of block pixel (i, j), row-major, to each cell
    (cx, cy) of the block, x-major: the block's Gaussian (sigma 4, centred
    at (8, 8)) times the bilinear share of the pixel's centre among the
    cells' centres."""
    sigma = (HOG_BLOCK + HOG_BLOCK) / 8.0
    out = np.zeros((HOG_BLOCK, HOG_BLOCK, 2, 2), np.float64)   # i, j, cx, cy
    for i in range(HOG_BLOCK):
        for j in range(HOG_BLOCK):
            g = math.exp(-((i - HOG_BLOCK / 2) ** 2 + (j - HOG_BLOCK / 2) ** 2)
                         / (2 * sigma * sigma))
            fy, fx = (i + 0.5) / HOG_CELL - 0.5, (j + 0.5) / HOG_CELL - 0.5
            for cy in range(2):
                for cx in range(2):
                    wy = max(0.0, 1.0 - abs(fy - cy))
                    wx = max(0.0, 1.0 - abs(fx - cx))
                    out[i, j, cx, cy] = g * wy * wx
    return out.reshape(HOG_BLOCK * HOG_BLOCK, 4).astype(np.float32)


def hog(gray: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[N, 32, 32] uint8 -> [N, 324] f32: central-difference gradients
    (reflect-101 borders), signed orientation voted bilinearly between the
    two nearest of 9 bins, each block's votes contracted with its cells'
    weights (``tf32``: their operands in TF32), blocks and cells x-major,
    L2-Hys (clip 0.2) per block with OpenCV's epsilons."""
    op = to_tf32 if tf32 else (lambda x: x)
    n = gray.shape[0]
    dev = gray.device
    idx = det.reflect101_index(RECOG_CROP, 1, 1, dev)
    f = gray.to(torch.float32)[:, idx][:, :, idx]   # [N, 34, 34]
    dx = f[:, 1:-1, 2:] - f[:, 1:-1, :-2]
    dy = f[:, 2:, 1:-1] - f[:, :-2, 1:-1]
    mag = torch.sqrt(dx * dx + dy * dy)
    pos = (torch.atan2(dy, dx) * torch.tensor(HOG_BINS / (2 * math.pi), device=dev)
           - torch.tensor(0.5, device=dev))
    lo = torch.floor(pos)
    frac = pos - lo
    lo_bin = torch.remainder(lo.to(torch.int64), HOG_BINS)
    votes = torch.zeros((n, RECOG_CROP, RECOG_CROP, HOG_BINS), dtype=torch.float32, device=dev)
    votes.scatter_add_(3, lo_bin[..., None], (mag * (1.0 - frac))[..., None])
    votes.scatter_add_(3, ((lo_bin + 1) % HOG_BINS)[..., None], (mag * frac)[..., None])
    weights = op(torch.from_numpy(_cell_weights()).to(dev))
    votes = op(votes)
    blocks = []
    for bx in range(HOG_BLOCKS):
        for by in range(HOG_BLOCKS):
            y0, x0 = by * HOG_STRIDE, bx * HOG_STRIDE
            v = votes[:, y0:y0 + HOG_BLOCK, x0:x0 + HOG_BLOCK].reshape(n, -1, HOG_BINS)
            blocks.append(torch.matmul(weights.T, v).reshape(n, 4 * HOG_BINS))
    h = torch.stack(blocks, dim=1)   # [N, 9 blocks, 36]
    h = h / (torch.sqrt((h * h).sum(-1, keepdim=True)) + torch.tensor(36 * 0.1, device=dev))
    h = torch.clamp(h, max=0.2)
    h = h / (torch.sqrt((h * h).sum(-1, keepdim=True)) + torch.tensor(1e-3, device=dev))
    return h.reshape(n, HOG_DIM)


def heads(feats: torch.Tensor, coefs: torch.Tensor, ints: torch.Tensor, tol: float,
          tf32: bool = False):
    """[N, D] descriptors -> (labels [N] 0..6, scores [N]).  Each head's sign
    probability is the sigmoid of its two class scores' contrast (``tf32``:
    the product's operands in TF32); a head asserts its sign where that is
    at least the background's and its larger probability is above ``tol``;
    the label is 0 where none asserts, else the asserting head of the
    largest probability (the first among equals)."""
    if tf32:
        feats, coefs = to_tf32(feats), to_tf32(coefs)
    p_sign = torch.stack([torch.sigmoid((feats @ coefs[k, 1] + ints[k, 1])
                                        - (feats @ coefs[k, 0] + ints[k, 0]))
                          for k in range(coefs.shape[0])])   # [6, N]
    p_bg = 1.0 - p_sign
    tol32 = torch.tensor(tol, dtype=torch.float32, device=feats.device)
    says = p_sign >= p_bg
    conf = torch.maximum(p_sign, p_bg)
    asserted = says & (conf > tol32)
    best = torch.argmax(torch.where(says, conf, -math.inf), dim=0)
    labels = torch.where(asserted.any(0), best + 1, 0)
    scores = torch.where(p_sign >= 0.5, p_sign, 0.0).amax(0)
    return labels, scores


# ---------------------------------------------------------------- forward


def recognize(frames: torch.Tensor, coefs: torch.Tensor, ints: torch.Tensor, p: Params,
              tf32: bool = False, hog_fn=hog) -> list[list[tuple]]:
    """BGR uint8 [B, H, W, 3] -> per frame its records (x1, y1, x2, y2,
    label, score), at most ``max_detections``, in proposal order.
    ``hog_fn(gray, tf32)`` computes the descriptors (the tests' precision
    probe)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        props, pvalid = mser_regions(det.enhance_contrast(frames), p)
        grown = [det.filter_and_grow(props, pvalid, g) for g in p.rec_grows]
        boxes = torch.cat([b for b, _ in grown], dim=1)
        keep = torch.cat([k for _, k in grown], dim=1)
        crops = det.crop_and_resize(frames, boxes, RECOG_CROP)
        crops, boxes, keep = det._dedup(det._hist_correlation(crops), crops, boxes, keep,
                                        det.DEDUP_HIST_TOL)
        crops, boxes, keep = det._dedup(det._coord_similarity(boxes), crops, boxes, keep,
                                        det.DEDUP_COORD_TOL)
        b, n = keep.shape
        gray = det.bgr_to_gray(crops).reshape(b * n, RECOG_CROP, RECOG_CROP)
        labels, scores = heads(hog_fn(gray, tf32), coefs, ints, p.no_sign_tol, tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    final = (keep & (labels.reshape(b, n) > 0)).cpu()
    boxes, labels, scores = boxes.cpu(), labels.reshape(b, n).cpu(), scores.reshape(b, n).cpu()
    out = []
    for i in range(b):
        idx = torch.nonzero(final[i]).flatten()[:p.max_detections].tolist()
        out.append([(*(int(v) for v in boxes[i, j].tolist()), int(labels[i, j]),
                     float(scores[i, j])) for j in idx])
    return out
