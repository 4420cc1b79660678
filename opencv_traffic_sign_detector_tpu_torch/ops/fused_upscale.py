"""Upscaled inference without an upscaled frame: bilinear upscale, 8x8
patchify and the v3 stem folded into two convolutions on native pixels.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/fused_upscale.py``.
Every stage between the native uint8 frame and the first stem activation is
linear, so the chain is one linear map, evaluated as:

* **width**: a [1, 3] conv over the grid of n-column blocks (each block
  needs one column of each neighbour), output channels ordered (t, kx, c)
  so that the result reshapes to [B, h, w_out/8, 24] stem patch columns;
* **height + stem**: one conv of stride n with an (n+2)-row kernel holding
  the height taps times the stem kernel;
* **replicate edges** as small correction terms pushed through the same
  height stage (the convs zero-pad).

The height conv pads (1, h_pad+1-h) rows: where that is asymmetric the
pad is applied with ``F.pad`` and the conv runs with ``padding=0``.
Tensors are NHWC at the public functions; inside, the NCHW views of NHWC
tensors are channels-last, so the permutes copy nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from .resident import resident, scalar
from .upscale import _MAX_PHASES

_PATCH = 8


@dataclass(frozen=True)
class FusedUpscalePlan:
    """Static geometry of one fused upscale+stem configuration: ``t/a`` the
    reduced rational scale on both axes, ``h_pad/w_pad`` the
    replicate-padded native dims, ``h_out/w_out`` the virtual upscaled dims,
    ``sb`` stem rows per height superblock, ``n`` native rows per
    superblock."""

    h: int
    w: int
    t: int
    a: int
    h_pad: int
    w_pad: int
    h_out: int
    w_out: int
    sb: int
    n: int

    @property
    def scale(self) -> float:
        return self.t / self.a

    def rescale_factors(self) -> tuple[float, float]:
        """(sx, sy) mapping upscaled-grid boxes back to native pixels."""
        return self.t / self.a, self.t / self.a


def find_plan(h: int, w: int, scale: float, *, a_max: int = 24,
              sb_max: int = 4, pad_max: int = 40,
              tol: float = 0.02) -> FusedUpscalePlan | None:
    """Best fusable rational approximation of ``scale`` for an (h, w) frame,
    or None (callers take the two-stage path).  Scans denominators
    a <= a_max for t/a within ``tol`` with superblock sb = lcm(8, t)/8 <=
    ``sb_max`` and alignment padding <= ``pad_max`` per axis."""
    if scale <= 1.0:
        return None
    best: FusedUpscalePlan | None = None
    best_key = None
    seen: set[tuple[int, int]] = set()
    for a_try in range(1, a_max + 1):
        t_try = round(scale * a_try)
        if t_try <= a_try:
            continue
        frac = Fraction(t_try, a_try)
        t, a = frac.numerator, frac.denominator
        if (t, a) in seen or t > _MAX_PHASES:
            continue
        seen.add((t, a))
        err = abs(t / a - scale)
        if err > tol:
            continue
        sb = math.lcm(8, t) // 8
        if sb > sb_max:
            continue
        n = sb * 8 * a // t
        # height: h_out a multiple of lcm(sb*8, 16); width: of 16
        l_h = math.lcm(sb * 8, 16)
        m_h = a * l_h // math.gcd(t, l_h)
        m_w = a * 16 // math.gcd(t, 16)
        h_pad = -(-h // m_h) * m_h
        w_pad = -(-w // m_w) * m_w
        if h_pad - h > pad_max or w_pad - w > pad_max:
            continue
        plan = FusedUpscalePlan(h=h, w=w, t=t, a=a, h_pad=h_pad, w_pad=w_pad,
                                h_out=h_pad * t // a, w_out=w_pad * t // a,
                                sb=sb, n=n)
        key = (err, (h_pad - h) + (w_pad - w), sb)
        if best_key is None or key < best_key:
            best, best_key = plan, key
    return best


def _superblock_taps(t: int, a: int, sb: int, n: int) -> np.ndarray:
    """[sb, 8, n+2] f32: weight of padded native offset u for patch phase
    (t', p), the bilinear 2-tap pattern (half-pixel centres, replicate
    edges) over one superblock; u = 0 is the previous superblock's last
    element, u = n, n+1 the next one's first two."""
    phases = sb * 8
    tap = np.zeros((phases, n + 2), np.float64)
    for phi in range(phases):
        blk, p = divmod(phi, t)
        x = (p + 0.5) * a / t - 0.5
        i0 = math.floor(x)
        f = x - i0
        u = a * blk + i0 + 1
        tap[phi, u] += 1.0 - f
        tap[phi, u + 1] += f
    return tap.reshape(sb, 8, n + 2).astype(np.float32)


def _width_conv_weights(plan: FusedUpscalePlan) -> np.ndarray:
    """[1, 3, 3n, sb*24] HWIO kernel of the width pass as a 3-tap conv over
    the n-column block grid: input channels (col-in-block, c); tap 0 is the
    previous block (its last column), 1 the block itself, 2 the next block
    (its first column); output channels (t, kx, c)."""
    n, sb = plan.n, plan.sb
    taps = _superblock_taps(plan.t, plan.a, sb, n)
    w = np.zeros((3, n, 3, sb, _PATCH, 3), np.float64)  # [dg, col, c, t, k, c']
    for t in range(sb):
        for k in range(_PATCH):
            for c in range(3):
                w[0, n - 1, c, t, k, c] = taps[t, k, 0]
                for u in range(1, n + 1):
                    w[1, u - 1, c, t, k, c] = taps[t, k, u]
                w[2, 0, c, t, k, c] = taps[t, k, n + 1]
    return w.reshape(1, 3, 3 * n, sb * _PATCH * 3).astype(np.float32)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def fused_upscale_stem(frames_u8: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor, plan: FusedUpscalePlan,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Native uint8 frames [B, h, w, 3] -> v3 stem relu activations
    [B, h_out/8, w_out/8, F] in ``dtype`` at the upscaled resolution.

    ``kernel`` [8, 8, 3, F] (HWIO, k = ky*24 + kx*3 + c) and ``bias`` [F] are
    the stem's own parameters.  Rounding points follow the reference: the
    width conv, the normalisation, the height conv and each correction add
    round to ``dtype``; the corrections' products are taken in f32."""
    b, h, w, _ = frames_u8.shape
    f = kernel.shape[-1]
    n, sb = plan.n, plan.sb
    dev = frames_u8.device
    f32 = torch.float32
    x = frames_u8
    if plan.w_pad > w:  # width alignment pad only
        x = torch.cat([x, x[:, :, -1:].expand(b, h, plan.w_pad - w, 3)], dim=2)

    # ---- width: a 3-tap conv over the block grid, padding (0, 0), (1, 1)
    g_w = plan.w_pad // n
    xr = x.reshape(b, h, g_w, 3 * n).to(dtype)
    kw = resident(_width_conv_weights, plan, device=dev).permute(3, 2, 0, 1).to(dtype)
    y = _nhwc(F.conv2d(_nchw(xr), kw, padding=(0, 1)))       # [b, h, g_w, sb*24]
    y = (y * resident(scalar, 1.0 / 255.0, dtype, device=dev)
         - resident(scalar, 0.5, dtype, device=dev))
    wq = plan.w_out // _PATCH
    y = y.reshape(b, h, wq, 3 * _PATCH)

    # replicate-column corrections of the two edge blocks, normalised
    # without the -0.5 (the affine constant lives in the main term only)
    taps = resident(_superblock_taps, plan.t, plan.a, sb, n, device=dev)
    eyec = torch.eye(3, dtype=f32, device=dev)
    wl = torch.einsum("tk,cd->ctkd", taps[:, :, 0], eyec).reshape(3, sb * 3 * _PATCH)
    wr = torch.einsum("tk,cd->ctkd", taps[:, :, n + 1], eyec).reshape(3, sb * 3 * _PATCH)
    scale = resident(scalar, float(np.float32(1.0 / 255.0)), f32, device=dev)
    cl = torch.einsum("bhc,cm->bhm", xr[:, :, 0, :3].to(f32),
                      wl * scale).reshape(b, h, sb, 3 * _PATCH).to(dtype)
    cr = torch.einsum("bhc,cm->bhm", xr[:, :, -1, 3 * n - 3:].to(f32),
                      wr * scale).reshape(b, h, sb, 3 * _PATCH).to(dtype)

    # ---- height + stem: one stride-n conv against the composite weights
    k0 = kernel.reshape(_PATCH, 3 * _PATCH, f).to(f32)
    kh = torch.einsum("sku,kqf->uqsf", taps, k0)             # [n+2, 24, sb, f]
    kh_conv = kh.reshape(n + 2, 1, 3 * _PATCH, sb * f).permute(3, 2, 0, 1).to(dtype)
    g_h = plan.h_pad // n

    def hstage(t: torch.Tensor) -> torch.Tensor:
        """Height conv, padding (1, h_pad+1-h) rows, plus the replicate-row
        corrections (linear in ``t``)."""
        bottom = plan.h_pad + 1 - h
        if bottom == 1:  # symmetric: the conv pads, nothing is copied
            o = F.conv2d(_nchw(t), kh_conv, stride=(n, 1), padding=(1, 0))
        else:
            o = F.conv2d(F.pad(_nchw(t), (0, 0, 1, bottom)), kh_conv, stride=(n, 1))
        o = _nhwc(o).contiguous()                            # [b, g_h, jw, sb*f]
        # top: window 0's u=0 tap is native row -1 == row 0 (replicate)
        top = torch.einsum("bjq,qm->bjm", t[:, 0].to(f32),
                           kh[0].reshape(3 * _PATCH, sb * f))
        o[:, 0] = o[:, 0] + top.to(dtype)
        # bottom: rows past the frame read the replicate of row h-1
        for i in range(g_h - 1, -1, -1):
            missing = [u for u in range(n + 2) if n * i + u - 1 >= h]
            if not missing:
                break
            kh_i = kh[missing[0]:].sum(dim=0).reshape(3 * _PATCH, sb * f)
            corr = torch.einsum("bjq,qm->bjm", t[:, h - 1].to(f32), kh_i)
            o[:, i] = o[:, i] + corr.to(dtype)
        return o

    out = hstage(y)
    out[:, :, :sb] = out[:, :, :sb] + hstage(cl)
    out[:, :, -sb:] = out[:, :, -sb:] + hstage(cr)
    out = out.reshape(b, g_h, wq, sb, f).transpose(2, 3).reshape(b, g_h * sb, wq, f)
    return torch.relu(out + bias.to(dtype))
