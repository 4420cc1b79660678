"""Batched dynamic crop + bilinear resize (the cv2.resize replacement).

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/resize.py``, batched
over frames: OpenCV INTER_LINEAR geometry (src = (dst + 0.5) * scale - 0.5,
clamped to the image-clamped crop window), round-half-even output.  Two
formulations in the reference's order: per-box 192x192 windows with
bilinear hat-weight matrix products (boxes from the detection path are at
most ~167 px), and four corner gathers per output pixel for frames smaller
than the window or ``exact=True``.  The window products sum in another
order than the reference, so outputs may differ by 1 count where the
sample sits at an exact .5 boundary.  On the card the window path is one
kernel (``csrc/crop_resize.cu``) that reads only each sample's non-zero
taps and equals the products bit for bit; on the CPU it is the products.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import build as rt
from .resident import const_f32, resident

_CROP_WIN = 192
# The kernel's limits (csrc/crop_resize.cu): channels and the largest out_size
CROP_CHANNELS = (1, 3)
CROP_MAX_OUT = 64


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


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp to 0..255 and narrow to uint8."""
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def _crop_resize_gather(image: torch.Tensor, boxes_xyxy: torch.Tensor,
                        out_size: int, reciprocal: bool) -> torch.Tensor:
    """Four bilinear corner gathers per output pixel, as uint8 crops."""
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
    return _to_u8(top * (1 - fy2) + bot * fy2)


def _window_coords(boxes_xyxy: torch.Tensor, h: int, w: int, out_size: int,
                   reciprocal: bool):
    """Each box's window origin (wy0, wx0) [B, N] int64 and its samples'
    coordinates in the window (rel_y, rel_x) [B, N, S] f32, clamped to it."""
    win = _CROP_WIN
    sy, sx, y1, x1 = _source_coords(boxes_xyxy, h, w, out_size, reciprocal)
    wy0 = torch.clamp(y1.to(torch.int32), 0, h - win).long()
    wx0 = torch.clamp(x1.to(torch.int32), 0, w - win).long()
    rel_y = torch.clamp(sy - wy0[..., None].to(torch.float32), 0.0, win - 1.0)
    rel_x = torch.clamp(sx - wx0[..., None].to(torch.float32), 0.0, win - 1.0)
    return wy0, wx0, rel_y, rel_x


def _hat_weights(rel: torch.Tensor) -> torch.Tensor:
    """Bilinear hat weights of each sample over the window's rows (or
    columns): [..., S] -> [..., S, 192]."""
    grid = torch.arange(_CROP_WIN, device=rel.device).to(torch.float32)
    return torch.clamp(1.0 - torch.abs(rel[..., None] - grid), min=0.0)


def crop_resize_window_plain(image: torch.Tensor, boxes_xyxy: torch.Tensor, out_size: int,
                             reciprocal: bool = True) -> torch.Tensor:
    """The window path in plain PyTorch: per-box window slice and bilinear
    hat-weight matrix products, as uint8 crops."""
    bsz, h, w, c = image.shape
    n = boxes_xyxy.shape[1]
    win = _CROP_WIN
    wy0, wx0, rel_y, rel_x = _window_coords(boxes_xyxy, h, w, out_size, reciprocal)

    ar = torch.arange(win, device=image.device)
    frame = torch.arange(bsz, device=image.device)[:, None, None, None]
    rows = (wy0[..., None] + ar)[..., :, None]
    cols = (wx0[..., None] + ar)[..., None, :]
    wins = image[frame, rows, cols].to(torch.float32)  # [B, N, win, win, C]

    ry, rx = _hat_weights(rel_y), _hat_weights(rel_x)
    m = bsz * n
    tmp = torch.bmm(ry.reshape(m, out_size, win), wins.reshape(m, win, win * c))
    tmp = tmp.reshape(m, out_size, win, c)
    out = torch.matmul(rx.reshape(m, 1, out_size, win), tmp)  # [M, S, S, C]
    return _to_u8(out).reshape(bsz, n, out_size, out_size, c)


def _launch_crop(image: torch.Tensor, coords, out: torch.Tensor) -> None:
    """One launch of the kernel on the current stream: image [B, H, W, C]
    uint8, ``coords`` :func:`_window_coords`' four tensors, contiguous,
    into ``out`` [B, N, S, S, C] uint8."""
    bsz, h, w, c = image.shape
    n, s = out.shape[1], out.shape[2]
    rc = rt.library().tsd_crop_resize(
        image.data_ptr(), *(t.data_ptr() for t in coords), out.data_ptr(), bsz, n, h, w, c, s,
        rt.stream_ptr(image.device))
    rt.check(rc, "crop_resize")


def crop_resize_window(image: torch.Tensor, boxes_xyxy: torch.Tensor, out_size: int,
                       reciprocal: bool = True) -> torch.Tensor:
    """The window path: image [B, H, W, C] uint8 (H, W >= 192), boxes
    [B, N, 4] -> [B, N, S, S, C] uint8.

    CPU tensors take :func:`crop_resize_window_plain`.  CUDA tensors take
    the kernel (``csrc/crop_resize.cu``), which reads each sample's at most
    two rows by two columns of non-zero weight and sums them in the order
    cuBLAS's kernels for the two products do, so it equals them bit for
    bit; the sample coordinates are :func:`_window_coords`'.  The kernel takes C = 1 or 3,
    ``out_size`` up to 64 and a contiguous image.
    """
    if rt.uses_plain(image, boxes_xyxy):
        return crop_resize_window_plain(image, boxes_xyxy, out_size, reciprocal)
    rt.check_tensor(image, "image", torch.uint8, 4)
    bsz, h, w, c = image.shape
    n = boxes_xyxy.shape[1]
    if c not in CROP_CHANNELS:
        raise ValueError(f"the kernel takes {CROP_CHANNELS} channels, got {c}")
    if not 1 <= out_size <= CROP_MAX_OUT:
        raise ValueError(f"the kernel takes out_size 1 to {CROP_MAX_OUT}, got {out_size}")
    if min(h, w) < _CROP_WIN:
        raise ValueError(f"frame {h}x{w} holds no {_CROP_WIN}-px window")
    coords = [t.contiguous() for t in _window_coords(boxes_xyxy, h, w, out_size, reciprocal)]
    out = torch.empty((bsz, n, out_size, out_size, c), dtype=torch.uint8, device=image.device)
    _launch_crop(image, coords, out)
    rt.count_launch("crop_resize")
    return out


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

    On a card the window path is :func:`crop_resize_window`'s kernel, which
    takes a contiguous uint8 image of 1 or 3 channels and ``out_size`` up
    to 64 and raises for anything else; the gather path and the CPU take
    any channel count and size.
    """
    squeeze = image.dim() == 3
    if squeeze:
        image = image[..., None]
    h, w = image.shape[1], image.shape[2]
    if not exact and h >= _CROP_WIN and w >= _CROP_WIN:
        out = crop_resize_window(image, boxes_xyxy, out_size, reciprocal)
    else:
        out = _crop_resize_gather(image, boxes_xyxy, out_size, reciprocal)
    return out[..., 0] if squeeze else out


def _whole_box(w: int, h: int) -> np.ndarray:
    return np.array([0, 0, w, h], np.int32)


def resize_batch(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resize a stack [N, H, W(, C)] uint8 to [N, out_size, out_size(, C)]:
    :func:`crop_and_resize` of each whole image."""
    n, h, w = images.shape[:3]
    boxes = resident(_whole_box, w, h, device=images.device)
    return crop_and_resize(images, boxes.expand(n, 1, 4), out_size, reciprocal=False)[:, 0]
