"""Batched dynamic crop + bilinear resize (the cv2.resize replacement).

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/resize.py``, batched
over frames: OpenCV INTER_LINEAR geometry (src = (dst + 0.5) * scale - 0.5,
clamped to the image-clamped crop window), round-half-even output.  Two
formulations in the reference's order: per-box 192x192 windows with
bilinear hat-weight matrix products (boxes from the detection path are at
most ~167 px), and four corner gathers per output pixel for frames smaller
than the window or ``exact=True``.  The window products sum in another
order than the reference, so outputs may differ by 1 count where the
sample sits at an exact .5 boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from .resident import const_f32, resident

_CROP_WIN = 192


def _source_coords(boxes_xyxy: torch.Tensor, h: int, w: int, out_size: int,
                   reciprocal: bool):
    """Per-box INTER_LINEAR source coordinates [B, N, S] (y, x)."""
    b = boxes_xyxy.to(torch.float32)
    x1 = torch.clamp(b[..., 0], 0.0, w - 1)
    y1 = torch.clamp(b[..., 1], 0.0, h - 1)
    x2 = torch.clamp(b[..., 2], 0.0, w)
    y2 = torch.clamp(b[..., 3], 0.0, h)
    cw = torch.clamp(x2 - x1, min=1.0)
    ch = torch.clamp(y2 - y1, min=1.0)

    s = torch.arange(out_size, dtype=torch.float32, device=b.device) + 0.5
    if reciprocal:
        inv = const_f32(float(np.float32(1.0) / np.float32(out_size)), b.device)
        step_x, step_y = cw[..., None] * inv, ch[..., None] * inv
    else:
        step_x, step_y = cw[..., None] / out_size, ch[..., None] / out_size
    sx = x1[..., None] + s * step_x - 0.5
    sy = y1[..., None] + s * step_y - 0.5
    sx = torch.minimum(torch.maximum(sx, x1[..., None]), x1[..., None] + cw[..., None] - 1.0)
    sy = torch.minimum(torch.maximum(sy, y1[..., None]), y1[..., None] + ch[..., None] - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    return sy, sx, y1, x1


def _crop_resize_gather(image: torch.Tensor, boxes_xyxy: torch.Tensor,
                        out_size: int, reciprocal: bool) -> torch.Tensor:
    """Four bilinear corner gathers per output pixel."""
    bsz, h, w, c = image.shape
    sy, sx, _, _ = _source_coords(boxes_xyxy, h, w, out_size, reciprocal)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    flat = image.reshape(bsz, h * w, c).to(torch.float32)

    def sample(yi, xi):
        idx = (yi[..., :, None] * w + xi[..., None, :]).reshape(bsz, -1)
        got = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return got.reshape(yi.shape[:2] + (out_size, out_size, c))

    p00, p01 = sample(y0i, x0i), sample(y0i, x1i)
    p10, p11 = sample(y1i, x0i), sample(y1i, x1i)
    fx2 = fx[..., None, :, None]
    fy2 = fy[..., :, None, None]
    top = p00 * (1 - fx2) + p01 * fx2
    bot = p10 * (1 - fx2) + p11 * fx2
    return torch.round(top * (1 - fy2) + bot * fy2)


def _crop_resize_window(image: torch.Tensor, boxes_xyxy: torch.Tensor,
                        out_size: int, reciprocal: bool) -> torch.Tensor:
    """Per-box window slice + bilinear hat-weight matrix products."""
    bsz, h, w, c = image.shape
    n = boxes_xyxy.shape[1]
    win = _CROP_WIN
    sy, sx, y1, x1 = _source_coords(boxes_xyxy, h, w, out_size, reciprocal)
    wy0 = torch.clamp(y1.to(torch.int32), 0, h - win).long()
    wx0 = torch.clamp(x1.to(torch.int32), 0, w - win).long()
    rel_y = torch.clamp(sy - wy0[..., None].to(torch.float32), 0.0, win - 1.0)
    rel_x = torch.clamp(sx - wx0[..., None].to(torch.float32), 0.0, win - 1.0)

    ar = torch.arange(win, device=image.device)
    frame = torch.arange(bsz, device=image.device)[:, None, None, None]
    rows = (wy0[..., None] + ar)[..., :, None]
    cols = (wx0[..., None] + ar)[..., None, :]
    wins = image[frame, rows, cols].to(torch.float32)  # [B, N, win, win, C]

    grid = ar.to(torch.float32)
    ry = torch.clamp(1.0 - torch.abs(rel_y[..., None] - grid), min=0.0)
    rx = torch.clamp(1.0 - torch.abs(rel_x[..., None] - grid), min=0.0)
    m = bsz * n
    tmp = torch.bmm(ry.reshape(m, out_size, win), wins.reshape(m, win, win * c))
    tmp = tmp.reshape(m, out_size, win, c)
    out = torch.matmul(rx.reshape(m, 1, out_size, win), tmp)  # [M, S, S, C]
    return torch.round(out).reshape(bsz, n, out_size, out_size, c)


def crop_and_resize(image: torch.Tensor, boxes_xyxy: torch.Tensor,
                    out_size: int, exact: bool = False,
                    reciprocal: bool = True) -> torch.Tensor:
    """Crop + bilinear-resize each box of each frame.

    image: [B, H, W] or [B, H, W, C] uint8; boxes_xyxy: [B, N, 4] int
    (x1, y1, x2, y2), half-open like numpy slices.  Returns uint8
    [B, N, out_size, out_size(, C)].  Boxes wider or taller than 192 px are
    edge-clamped on the window path; ``exact=True`` takes the gather path.

    ``reciprocal`` fixes how the sample step ``box side / out_size`` is
    rounded: the reference's detection path is compiled with jit, which
    multiplies by the f32 reciprocal of ``out_size`` (True); its template
    trainer runs eagerly and divides (False).  Either way the sample grid
    equals the reference's bit for bit.
    """
    squeeze = image.dim() == 3
    if squeeze:
        image = image[..., None]
    h, w = image.shape[1], image.shape[2]
    if not exact and h >= _CROP_WIN and w >= _CROP_WIN:
        out = _crop_resize_window(image, boxes_xyxy, out_size, reciprocal)
    else:
        out = _crop_resize_gather(image, boxes_xyxy, out_size, reciprocal)
    out = out.clamp(0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out


def _whole_box(w: int, h: int) -> np.ndarray:
    return np.array([0, 0, w, h], np.int32)


def resize_batch(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resize a stack [N, H, W(, C)] uint8 to [N, out_size, out_size(, C)]:
    :func:`crop_and_resize` of each whole image."""
    n, h, w = images.shape[:3]
    boxes = resident(_whole_box, w, h, device=images.device)
    return crop_and_resize(images, boxes.expand(n, 1, 4), out_size, reciprocal=False)[:, 0]
