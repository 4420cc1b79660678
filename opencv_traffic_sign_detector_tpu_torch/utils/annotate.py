"""Host-side frame annotation (red 1-px rectangles, like the reference's
resultado_imgs output, `Deteción de Objetos/source.py:589-594`; the port's
own copy of ``opencv_traffic_sign_detector_tpu/utils/annotate.py``).

Pure numpy; no OpenCV dependency in the framework itself.
"""

from __future__ import annotations

import numpy as np


def draw_boxes_bgr(
    image: np.ndarray,
    boxes: list[tuple[int, int, int, int]],
    color: tuple[int, int, int] = (0, 0, 255),
    thickness: int = 1,
) -> np.ndarray:
    """Draw axis-aligned rectangles on a BGR uint8 image (returns a copy)."""
    out = image.copy()
    h, w = out.shape[:2]
    col = np.asarray(color, dtype=out.dtype)
    for (x1, y1, x2, y2) in boxes:
        x1c, x2c = max(int(x1), 0), min(int(x2), w - 1)
        y1c, y2c = max(int(y1), 0), min(int(y2), h - 1)
        if x1c > x2c or y1c > y2c:
            continue
        for t in range(thickness):
            if y1c + t < h:
                out[min(y1c + t, h - 1), x1c : x2c + 1] = col
            if y2c - t >= 0:
                out[max(y2c - t, 0), x1c : x2c + 1] = col
            if x1c + t < w:
                out[y1c : y2c + 1, min(x1c + t, w - 1)] = col
            if x2c - t >= 0:
                out[y1c : y2c + 1, max(x2c - t, 0)] = col
    return out


def save_image_bgr(path: str, image: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(image[..., ::-1]).save(path)
