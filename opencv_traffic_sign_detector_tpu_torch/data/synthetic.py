"""Synthetic road-scene frames and sign crops, made from a seed with numpy.

Frames carry a smooth gradient, sensor-like noise and sign-like shapes of
20-70 px: red rings, red triangles and blue discs, in BGR uint8.  The
detection path's quality cannot be judged on them, but they give the MSER
sweep stable regions at sign scale, so every stage does real work.  The
writers (JPEG via PIL) build a test directory, a GTSDB-style directory of
labelled frames with its ``gt.txt`` and a ``train_jpg``-style directory with
one crop folder per super-type.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import SUPERTYPE_CLASS_DIRS

RED = (30, 30, 200)
BLUE = (190, 80, 20)
WHITE = (235, 235, 235)


def _grid(h: int, w: int, cy: float, cx: float):
    yy, xx = np.mgrid[0:h, 0:w]
    return yy - cy, xx - cx


def _draw(img: np.ndarray, shape: str, cy: float, cx: float, size: int) -> None:
    """Paint one sign of side ``size`` centred at (cy, cx), in place."""
    h, w = img.shape[:2]
    dy, dx = _grid(h, w, cy, cx)
    r = size / 2.0
    dist = np.hypot(dy, dx)
    if shape == "ring":  # prohibition: red ring on white
        img[dist <= r] = RED
        img[dist <= 0.72 * r] = WHITE
    elif shape == "disc":  # mandatory: blue disc with a white arrow bar
        img[dist <= r] = BLUE
        img[(np.abs(dy) <= 0.12 * r) & (np.abs(dx) <= 0.55 * r)] = WHITE
    elif shape in ("triangle", "yield"):  # danger / yield: red outline
        up = shape == "triangle"
        t = (dy + r) / (2 * r) if up else (r - dy) / (2 * r)
        outer = (np.abs(dy) <= r) & (np.abs(dx) <= t * r)
        img[outer] = RED
        ti = (t - 0.28) / 0.72
        img[outer & (ti > 0) & (np.abs(dx) <= ti * 0.72 * r)
            & (np.abs(dy) <= 0.7 * r)] = WHITE
    elif shape == "stop":  # red octagon with a white band
        oct_ = (np.abs(dy) <= r) & (np.abs(dx) <= r) & (np.abs(dx) + np.abs(dy) <= 1.4 * r)
        img[oct_] = RED
        img[oct_ & (np.abs(dy) <= 0.15 * r) & (np.abs(dx) <= 0.7 * r)] = WHITE
    elif shape == "no_entry":  # red disc with a white bar
        img[dist <= r] = RED
        img[(np.abs(dy) <= 0.18 * r) & (np.abs(dx) <= 0.7 * r)] = WHITE
    else:
        raise ValueError(f"unknown shape {shape!r}")


# shape drawn for each super-type (constants.SIGN_TYPES order)
SUPERTYPE_SHAPES = ("ring", "triangle", "stop", "no_entry", "yield", "disc")


def _background(rng, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """One [h, w, 3] uint8 frame of gradient, waves and sensor noise."""
    h, w = yy.shape
    base = np.empty((h, w, 3), np.float32)
    gy, gx = rng.uniform(-60, 60, 2)
    for c in range(3):
        base[..., c] = (rng.uniform(80, 150) + gy * yy / h + gx * xx / w
                        + 25 * np.sin(xx / rng.uniform(60, 200) + rng.uniform(0, 6)))
    base += rng.normal(0, 6, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def make_frames(n: int, h: int = 800, w: int = 1360, seed: int = 0,
                signs_per_frame: int = 6) -> np.ndarray:
    """[n, h, w, 3] uint8 BGR frames with red rings, triangles, blue discs."""
    return make_frames_with_boxes(n, h, w, seed, signs_per_frame)[0]


def make_frames_with_boxes(n: int, h: int = 800, w: int = 1360, seed: int = 0,
                           signs_per_frame: int = 6):
    """:func:`make_frames`' frames and, per frame, where its signs were
    drawn, as :func:`make_labelled_frames` gives them: a list of (x1, y1,
    x2, y2, super-type), rings type 1, triangles 2, discs 6 (signs may
    overlap here)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)
    boxes = []
    for i in range(n):
        img = _background(rng, yy, xx)
        found = []
        for _ in range(signs_per_frame):
            size = int(rng.integers(20, min(71, min(h, w) // 2)))
            cy = rng.uniform(size, h - size)
            cx = rng.uniform(size, w - size)
            y0, x0 = int(cy) - size, int(cx) - size
            patch = img[y0:y0 + 2 * size + 1, x0:x0 + 2 * size + 1]
            shape = ("ring", "triangle", "disc")[rng.integers(0, 3)]
            _draw(patch, shape, cy - y0, cx - x0, size)
            r = size / 2.0
            found.append((int(np.floor(cx - r)), int(np.floor(cy - r)), int(np.ceil(cx + r)),
                          int(np.ceil(cy + r)), SUPERTYPE_SHAPES.index(shape) + 1))
        frames[i] = img
        boxes.append(found)
    return frames, boxes


def make_labelled_frames(n: int, h: int = 800, w: int = 1360, seed: int = 0,
                         signs_per_frame: int = 6):
    """Frames with signs of all six super-types at known places, for a
    GTSDB-style train or test directory.  Signs of 24-60 px sit in the cells
    of a jittered grid, so they never overlap.  -> (frames [n, h, w, 3]
    uint8, boxes: per frame a list of (x1, y1, x2, y2, super-type))."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cols = max(1, int(np.ceil(np.sqrt(signs_per_frame * w / h))))
    rows = -(-signs_per_frame // cols)
    ch, cw = h // rows, w // cols
    frames = np.empty((n, h, w, 3), np.uint8)
    boxes = []
    for i in range(n):
        img = _background(rng, yy, xx)
        found = []
        for k, cell in enumerate(rng.permutation(rows * cols)[:signs_per_frame]):
            st = (i * signs_per_frame + k) % 6 + 1
            size = int(rng.integers(24, max(25, min(61, min(ch, cw) - 8))))
            r = size / 2.0
            oy, ox = (cell // cols) * ch, (cell % cols) * cw
            cy = oy + rng.uniform(r + 2, max(r + 3, ch - r - 2))
            cx = ox + rng.uniform(r + 2, max(r + 3, cw - r - 2))
            y0, x0 = max(int(cy) - size, 0), max(int(cx) - size, 0)
            patch = img[y0:y0 + 2 * size + 1, x0:x0 + 2 * size + 1]
            _draw(patch, SUPERTYPE_SHAPES[st - 1], cy - y0, cx - x0, size)
            found.append((int(np.floor(cx - r)), int(np.floor(cy - r)),
                          int(np.ceil(cx + r)), int(np.ceil(cy + r)), st))
        frames[i] = img
        boxes.append(found)
    return frames, boxes


def bgr_to_yuv420(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[n, h, w, 3] BGR uint8 -> JFIF 4:2:0 planes (y [n, h, w], cb/cr
    [n, ceil(h/2), ceil(w/2)]): BT.601 full-range YCbCr, chroma averaged
    over 2x2 blocks (edge-replicated for odd sizes), as a JPEG encoder
    would hand them to the decoder."""
    f = frames.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    h, w = frames.shape[1:3]

    def pool(c):
        c = np.pad(c, ((0, 0), (0, h % 2), (0, w % 2)), mode="edge")
        return c.reshape(len(c), c.shape[1] // 2, 2, c.shape[2] // 2, 2).mean(axis=(2, 4))

    def u8(c):
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    return u8(y), u8(pool(cb)), u8(pool(cr))


def make_sign_crop(supertype: int, size: int = 40, seed: int = 0) -> np.ndarray:
    """One [size+8, size+8, 3] BGR crop of super-type 1..6 on a grey margin."""
    rng = np.random.default_rng(seed)
    side = size + 8
    img = np.clip(rng.normal(120, 8, (side, side, 3)), 0, 255).astype(np.uint8)
    _draw(img, SUPERTYPE_SHAPES[supertype - 1], side / 2.0, side / 2.0, size)
    return img


def _save_jpeg(path: str, bgr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(path, quality=95)


def write_frames(root: str, frames: np.ndarray) -> list[str]:
    """Write BGR frames as ``00000.jpg``... into ``root``; -> their names."""
    os.makedirs(root, exist_ok=True)
    names = []
    for i, frame in enumerate(frames):
        name = f"{i:05d}.jpg"
        _save_jpeg(os.path.join(root, name), frame)
        names.append(name)
    return names


def write_test_dir(root: str, n: int, h: int, w: int, seed: int = 0) -> list[str]:
    """Write ``n`` synthetic frames as ``00000.jpg``... into ``root``."""
    return write_frames(root, make_frames(n, h, w, seed))


def write_gt_dir(root: str, n: int, h: int, w: int, seed: int = 0,
                 signs_per_frame: int = 6) -> list[str]:
    """Write ``n`` labelled frames (:func:`make_labelled_frames`) as
    ``00000.jpg``... with a GTSDB ``gt.txt`` (``name.ppm;x1;y1;x2;y2;class``,
    the first raw class id of each super-type) into ``root``."""
    frames, boxes = make_labelled_frames(n, h, w, seed, signs_per_frame)
    names = write_frames(root, frames)
    lines = [f"{i:05d}.ppm;{x1};{y1};{x2};{y2};{int(SUPERTYPE_CLASS_DIRS[st - 1][0])}"
             for i, found in enumerate(boxes) for x1, y1, x2, y2, st in found]
    with open(os.path.join(root, "gt.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return names


def write_train_dir(root: str, seed: int = 0, per_type: int = 2) -> str:
    """Write a ``train_jpg``-style tree: crops under the first class folder
    of each super-type, enough for mean-mask training."""
    for st, dirs in enumerate(SUPERTYPE_CLASS_DIRS, start=1):
        d = os.path.join(root, dirs[0])
        os.makedirs(d, exist_ok=True)
        for k in range(per_type):
            crop = make_sign_crop(st, size=32 + 8 * k, seed=seed * 100 + st * 10 + k)
            _save_jpeg(os.path.join(d, f"{k:05d}.jpg"), crop)
    return root
