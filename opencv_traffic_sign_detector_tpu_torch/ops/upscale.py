"""Whole-frame bilinear resize of uint8 frames: phase-sliced 2-tap passes for
rational upscales, a dense antialiased pass otherwise.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/upscale.py``.  With
``g = gcd(in, out)`` the source phase pattern of an upscaled axis repeats
every ``T = out/g`` output pixels over ``A = in/g`` input pixels, so a pass
is one [T, A] band product against a reshape of the input plus two rank-1
terms for the taps that fall on the next block.  Sample centres are
``(i + 0.5) * in/out - 0.5`` with replicate edges, as in
``jax.image.resize(..., "bilinear")``.

Axes that shrink, and ratios with more than ``_MAX_PHASES`` phases, take
the dense pass, which builds ``jax.image.resize``'s bilinear weights by
its formula: a triangle kernel widened by the factor when downscaling
(antialiasing), renormalised per output sample, in float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .resident import resident

# Above this many phases per axis the dense pass is taken (as in the reference).
_MAX_PHASES = 192


def _phase_plan(in_size: int, out_size: int):
    """``(A, g, T, taps)`` with ``taps[p] = (j, w0, w1)``, ``j`` indexing the
    1-replicate-padded axis, or None when T exceeds ``_MAX_PHASES``."""
    g = math.gcd(in_size, out_size)
    T = out_size // g
    A = in_size // g
    if T > _MAX_PHASES:
        return None
    taps = []
    for p in range(T):
        x = (p + 0.5) * in_size / out_size - 0.5
        i0 = math.floor(x)
        f = x - i0
        taps.append((i0 + 1, 1.0 - f, f))
    return A, g, T, taps


def _band_matrix(A: int, T: int, taps) -> np.ndarray:
    """[T, A+2] bilinear band: W[p, j] over padded in-block offsets."""
    W = np.zeros((T, A + 2), np.float32)
    for p, (j, w0, w1) in enumerate(taps):
        W[p, j] += np.float32(w0)
        W[p, j + 1] += np.float32(w1)
    return W


def _band(in_size: int, out_size: int) -> np.ndarray:
    """The band matrix of an axis that has a phase plan."""
    A, _, T, taps = _phase_plan(in_size, out_size)
    return _band_matrix(A, T, taps)


def _upscale_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """One separable bilinear pass of [B, H, W, C] along ``axis`` (1 or 2)
    as a blocked band product; float32 out."""
    in_size = x.shape[axis]
    plan = _phase_plan(in_size, out_size)
    if plan is None:
        raise ValueError(
            f"no phase plan for axis {axis}: {in_size} -> {out_size} "
            f"(phase count exceeds _MAX_PHASES={_MAX_PHASES}); use the "
            "dense resize path")
    A, g, T, _ = plan
    W = resident(_band, in_size, out_size, device=x.device)
    x = x.to(torch.float32)
    xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, in_size - 1, 1)], dim=axis)
    main = xp.narrow(axis, 0, in_size)
    # the taps that fall on the next block: padded offsets A and A+1 of each
    nxt0 = xp.narrow(axis, A, A * (g - 1) + 1)[(slice(None),) * axis + (slice(None, None, A),)]
    nxt1 = xp.narrow(axis, A + 1, A * (g - 1) + 1)[(slice(None),) * axis + (slice(None, None, A),)]
    Wm, w_n0, w_n1 = W[:, :A], W[:, A], W[:, A + 1]
    if axis == 1:
        b, _, w, c = x.shape
        out = torch.einsum("pa,bgawc->bgpwc", Wm, main.reshape(b, g, A, w, c))
        out = out + w_n0[None, None, :, None, None] * nxt0[:, :, None]
        out = out + w_n1[None, None, :, None, None] * nxt1[:, :, None]
        return out.reshape(b, out_size, w, c)
    b, h, _, c = x.shape
    out = torch.einsum("pa,bhgac->bhgpc", Wm, main.reshape(b, h, g, A, c))
    out = out + w_n0[None, None, None, :, None] * nxt0[:, :, :, None]
    out = out + w_n1[None, None, None, :, None] * nxt1[:, :, :, None]
    return out.reshape(b, h, out_size, c)


def scale_translate_weights(in_size: int, out_size: int, inv_scale: torch.Tensor,
                            shift: torch.Tensor, reciprocal: bool = False) -> torch.Tensor:
    """[B, in, out] f32 linear-resampling weights of ``B`` axes, as
    ``jax.image.scale_and_translate`` computes them (``compute_weight_mat``:
    triangle kernel, antialias on, renormalised per output sample, zero
    where the sample lies outside ``[-0.5, in - 0.5]``).

    ``inv_scale`` [B] is ``1 / scale`` and ``shift`` [B] is ``translation *
    inv_scale``: output pixel ``o`` samples input ``(o + 0.5) * inv_scale -
    shift - 0.5``.  The kernel is widened by ``max(inv_scale, 1)``; with
    ``reciprocal`` the distances are multiplied by its f32 reciprocal, as
    jit does when the scale is a constant, else divided by it."""
    f32, dev = torch.float32, inv_scale.device
    kernel_scale = torch.clamp(inv_scale, min=1.0)[:, None, None]
    sample_f = ((torch.arange(out_size, dtype=f32, device=dev) + 0.5)[None, :]
                * inv_scale[:, None] - shift[:, None] - 0.5)                  # [B, out]
    x = (sample_f[:, None, :] - torch.arange(in_size, dtype=f32, device=dev)[None, :, None]).abs()
    x = x * (1 / kernel_scale) if reciprocal else x / kernel_scale
    weights = torch.clamp(1 - x, min=0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


@functools.lru_cache(maxsize=None)
def _dense_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] f32 bilinear weights as ``jax.image.resize`` computes them:
    the scale is a Python float there, so ``1 / scale`` is taken in f64, and
    jit turns the division by the constant kernel scale into a product with
    its f32 reciprocal.  Computed on ``device`` once (its inputs copy there:
    ``ops/resident.py``)."""
    inv_scale = torch.tensor([1.0 / (out_size / in_size)], dtype=torch.float32, device=device)
    return scale_translate_weights(in_size, out_size, inv_scale, torch.zeros_like(inv_scale),
                                   reciprocal=True)[0]


def _dense_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Single-axis dense bilinear resize, float32 out.  The moved axis is
    made contiguous and the product taken as one 2-D matmul: on an H100,
    ``matmul`` of the strided 4-D view took a batched path (116 ms for both
    axes of 32 1360x800 frames at 0.9x) where the 2-D product of the first
    axis takes 3.4 ms."""
    w = _dense_weights(x.shape[axis], out_size, x.device)
    xm = x.to(torch.float32).movedim(axis, -1)
    out = (xm.reshape(-1, xm.shape[-1]) @ w).reshape(*xm.shape[:-1], out_size)
    return out.movedim(-1, axis)


def resize_bilinear_u8(frames_u8: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[B, H, W, C] uint8 -> (th, tw) as ``jax.image.resize(frames.astype(
    f32), (B, th, tw, C), "bilinear")`` under jit, rounded half to even,
    clipped and cast back: each resized axis is one f32 product with the
    dense weights (:func:`scale_translate_weights`, ``reciprocal=True``),
    whatever the ratio, the width first (the order closest to XLA's on the
    CPU).  The quality passes at 1920x1088 use it."""
    x = frames_u8
    for axis, size in ((2, tw), (1, th)):
        if size != x.shape[axis]:
            x = _dense_axis(x, axis, size)
    return torch.clamp(torch.round(x.to(torch.float32)), 0, 255).to(torch.uint8)


def upscale_bilinear_u8(frames_u8: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] uint8 frames to (th, tw): float32
    interpolation, round half to even, clip, uint8.  Each axis is gated on
    its own: phase-sliced when it grows with a phase plan, dense otherwise."""
    _, h, w, _ = frames_u8.shape
    x = frames_u8
    if th != h:
        if th < h or _phase_plan(h, th) is None:
            x = _dense_axis(x, 1, th)
        else:
            x = _upscale_axis(x, 1, th)
    if tw != w:
        if tw < w or _phase_plan(w, tw) is None:
            x = _dense_axis(x, 2, tw)
        else:
            x = _upscale_axis(x, 2, tw)
    return torch.clamp(torch.round(x.to(torch.float32)), 0, 255).to(torch.uint8)
