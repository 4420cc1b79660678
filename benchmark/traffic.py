"""The one traffic generator: a pool of frame batches drawn from a seed.

A traffic file (``traffic/<name>.json``) gives the frame size, the batch,
the number of distinct batches in the pool, the signs drawn a frame and
their sizes, and the input format (``bgr``).  The pool is held as pageable
numpy arrays; the program pins what it copies.

The frames are a frozen copy of the port's ``data/synthetic.py:
make_frames_with_boxes`` (a gradient, waves, sensor noise, and red rings,
red triangles and blue discs of 20-70 px), with one change: each frame draws from a stream of its own, ``(seed, frame index)``,
its noise in float32, so the frames of a pool are made on a few threads.
The same seed gives the same pool; the picture is the same as the port's
generator gives, not the same pixels.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

RED = (30, 30, 200)
BLUE = (190, 80, 20)
WHITE = (235, 235, 235)
SHAPES = ("ring", "triangle", "disc")
THREADS = 4


def _draw(img: np.ndarray, shape: str, cy: float, cx: float, size: int) -> None:
    h, w = img.shape[:2]
    dy, dx = np.mgrid[0:h, 0:w]
    dy, dx = dy - cy, dx - cx
    r = size / 2.0
    dist = np.hypot(dy, dx)
    if shape == "ring":
        img[dist <= r] = RED
        img[dist <= 0.72 * r] = WHITE
    elif shape == "disc":
        img[dist <= r] = BLUE
        img[(np.abs(dy) <= 0.12 * r) & (np.abs(dx) <= 0.55 * r)] = WHITE
    else:  # triangle: red outline, white inside
        t = (dy + r) / (2 * r)
        outer = (np.abs(dy) <= r) & (np.abs(dx) <= t * r)
        img[outer] = RED
        ti = (t - 0.28) / 0.72
        img[outer & (ti > 0) & (np.abs(dx) <= ti * 0.72 * r) & (np.abs(dy) <= 0.7 * r)] = WHITE


def make_frame(seed: int, index: int, h: int, w: int, signs: int,
               sign_px: tuple[int, int]) -> np.ndarray:
    """One BGR uint8 frame [h, w, 3] of stream (seed, index)."""
    rng = np.random.default_rng([seed, index])
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    base = np.empty((h, w, 3), np.float32)
    gy, gx = rng.uniform(-60, 60, 2)
    for c in range(3):
        base[..., c] = (rng.uniform(80, 150) + gy * yy / h + gx * xx / w
                        + 25 * np.sin(xx / rng.uniform(60, 200) + rng.uniform(0, 6)))
    base += rng.standard_normal((h, w, 3), dtype=np.float32) * np.float32(6)
    img = np.clip(base, 0, 255).astype(np.uint8)
    lo, hi = sign_px
    for _ in range(signs):
        size = int(rng.integers(lo, min(hi + 1, min(h, w) // 2)))
        cy = rng.uniform(size, h - size)
        cx = rng.uniform(size, w - size)
        y0, x0 = int(cy) - size, int(cx) - size
        patch = img[y0:y0 + 2 * size + 1, x0:x0 + 2 * size + 1]
        shape = SHAPES[rng.integers(0, 3)]
        _draw(patch, shape, cy - y0, cx - x0, size)
    return img


def make_pool(traffic: dict, seed: int) -> list:
    """The cell's pool: ``pool_batches`` batches of ``batch`` frames, each a
    BGR array [B, H, W, 3]."""
    b, n = traffic["batch"], traffic["pool_batches"]
    h, w = traffic["height"], traffic["width"]
    fmt = traffic["frames"]
    if fmt != "bgr":
        raise ValueError(f"unknown frame format {fmt!r}")
    frames = np.empty((b * n, h, w, 3), np.uint8)

    def one(i):
        frames[i] = make_frame(seed, i, h, w, traffic["signs_per_frame"],
                               tuple(traffic["sign_px"]))

    with ThreadPoolExecutor(THREADS) as ex:
        list(ex.map(one, range(b * n)))
    return [frames[k * b:(k + 1) * b] for k in range(n)]
