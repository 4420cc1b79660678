"""Post-training int8 serving path of the v3 detector.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/cnn_quant.py``.
Weights are per-output-channel symmetric int8, activations per-tensor
uint7 kept as int8 in [0, 127]:

* stem: ``acc = (x - 128) @ Wq`` on int8 patches, then
  ``relu(acc * mult + bias)`` (the ``x/255 - 0.5`` affine is folded into
  ``mult`` and ``bias``) and a requant by ``a0_inv``;
* trunk conv i: ``acc = conv_s8(h, Wq_i)``, ``relu(acc * mult_i + b_i)``,
  requant by ``a_i_inv``;
* heads: int8 convs dequantized to f32 (or, with ``float_heads``, bf16
  convs on the dequantized trunk output).

PyTorch has no int8 convolution on CUDA, so a conv is an int8 im2col of
its 9 shifted views in (ky, kx, cin) order, the row order of the HWIO
kernel flattened to [9*cin, cout], times that matrix.  On the card the
product is ``torch._int_mm`` (int8 x int8 -> int32); on the CPU an int32
matmul.  Both are exact: |acc| <= 1152 * 127 * 127 < 2^31.  The three
heads run as one product with N = 6+2+2 padded to 16.

Calibration (:func:`quantize_v3`) runs the float chain in f32 on a few
frames for the activation scales (``percentile(|act|, q) / 127``, q = 100
by default) and quantizes the weights in host numpy, as the reference
does, so the int8 weights are the reference's.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_upscale import FusedUpscalePlan, fused_upscale_stem
from ..runtime.build import uses_plain
from .cnn_detector import (
    _PATCH,
    _STEM_K,
    CNNDetector,
    CNNDetectorConfig,
    conv_same,
    flat_params,
    patchify,
    same_pads,
)
from .detector import full_f32_matmuls

_TRUNK = (1, 2, 3)          # Conv_1..Conv_3 (stride 2, 1, 1)
_TRUNK_STRIDES = {1: 2, 2: 1, 3: 1}
_HEADS = {4: "hm", 5: "size", 6: "off"}


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact.

    On the card ``torch._int_mm``, which takes M > 16 and K, N multiples of
    8: smaller or ragged operands are zero-padded and the result cut back.
    On the CPU an int32 matmul."""
    if uses_plain(a, b):
        return a.to(torch.int32) @ b.to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def im2col3x3(h: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, Ho, Wo, 9*C] of the "SAME" 3x3 windows,
    columns in (ky, kx, c) order."""
    b, hh, ww, c = h.shape
    top, bottom = same_pads(hh, 3, stride)
    left, right = same_pads(ww, 3, stride)
    hp = F.pad(h, (0, 0, left, right, top, bottom))
    ho, wo = -(-hh // stride), -(-ww // stride)
    views = [hp[:, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
             for ky in range(3) for kx in range(3)]
    return torch.cat(views, dim=-1)


def conv_int8(h: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """"SAME" 3x3 conv of int8 NHWC activations with an int8 HWIO kernel ->
    int32 accumulators [B, Ho, Wo, N]."""
    cols = im2col3x3(h, stride)
    b, ho, wo, kk = cols.shape
    acc = int8_matmul(cols.reshape(-1, kk), kernel.reshape(kk, -1))
    return acc.reshape(b, ho, wo, -1)


def requant(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
            a_inv: torch.Tensor) -> torch.Tensor:
    """The f32 epilogue: ``relu(acc * mult + bias)`` requantized by
    ``a_inv`` to int8 in [0, 127] (round half to even, as ``jnp.round``)."""
    y = torch.clamp(acc.to(torch.float32) * mult + bias, min=0.0)
    return torch.clamp(torch.round(y * a_inv), 0, 127).to(torch.int8)


def stem_int8_acc(q: dict, x: torch.Tensor) -> torch.Tensor:
    """uint8 frames or patches8 -> int32 stem accumulators ``(x-128) @ Wq``."""
    if x.shape[-1] != _STEM_K:
        x = patchify(x)
    xs = (x.to(torch.int16) - 128).to(torch.int8)
    lead = xs.shape[:-1]
    return int8_matmul(xs.reshape(-1, _STEM_K), q["q0_kernel"]).reshape(*lead, -1)


def v3_int8_forward(q: dict, frames_u8: torch.Tensor) -> dict[str, torch.Tensor]:
    """Quantized v3 forward: uint8 frames/patches -> f32 head maps."""
    h = requant(stem_int8_acc(q, frames_u8), q["q0_mult"], q["q0_bias"], q["a0_inv"])
    return v3_int8_trunk_heads(q, h)


def v3_int8_trunk_heads(q: dict, h: torch.Tensor) -> dict[str, torch.Tensor]:
    """Conv_1..Conv_6 of the int8 chain from requantized stem activations
    ``h`` (int8 in [0, 127])."""
    for i in _TRUNK:
        acc = conv_int8(h, q[f"q{i}_kernel"], _TRUNK_STRIDES[i])
        h = requant(acc, q[f"q{i}_mult"], q[f"q{i}_bias"], q[f"a{i}_inv"])
    if "f4_kernel" in q:
        # float heads: the int8 trunk output dequantized in bf16, bf16 convs
        bf16 = torch.bfloat16
        hf = h.to(bf16) * q["a3_scale"].to(bf16)
        return {name: conv_same(hf, q[f"f{i}_kernel"].permute(3, 2, 0, 1).to(bf16)).float()
                + q[f"f{i}_bias"] for i, name in _HEADS.items()}
    kernel = torch.cat([q[f"q{i}_kernel"] for i in _HEADS], dim=-1)   # [3, 3, 128, 10]
    acc = conv_int8(h, kernel).to(torch.float32)
    outs, start = {}, 0
    for i, name in _HEADS.items():
        n = q[f"q{i}_mult"].shape[0]
        outs[name] = acc[..., start:start + n] * q[f"q{i}_mult"] + q[f"q{i}_bias"]
        start += n
    return outs


def _stem_float_from_quant(q: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The float stem (kernel [8, 8, 3, F], bias [F]) recovered from the
    artifact's own int8 stem tensors, within its quantization error."""
    k0 = q["q0_kernel"].to(torch.float32) * (q["q0_mult"] * 255.0)
    b0 = q["q0_bias"] - k0.sum(dim=0) * float(np.float32(128.0 / 255.0 - 0.5))
    return k0.reshape(_PATCH, _PATCH, 3, -1), b0


def fused_stem_int8(q: dict, frames_u8: torch.Tensor, plan: FusedUpscalePlan) -> torch.Tensor:
    """Folded upscale+patchify+stem in bf16 (the stem input is interpolated,
    so the int8 stem product does not apply), requantized to int8."""
    k0, b0 = _stem_float_from_quant(q)
    y0 = fused_upscale_stem(frames_u8, k0, b0, plan, torch.bfloat16)
    return torch.clamp(torch.round(y0.to(torch.float32) * q["a0_inv"]), 0, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# Calibration and quantization (one-shot; weights in host numpy)
# ---------------------------------------------------------------------------


def _channel_scales(kernel: np.ndarray) -> np.ndarray:
    """Per-output-channel symmetric scales (last axis = out channels)."""
    flat = np.abs(kernel.reshape(-1, kernel.shape[-1]))
    return np.maximum(flat.max(axis=0), 1e-12).astype(np.float32) / 127.0


def _quant_weight(kernel: np.ndarray, scales: np.ndarray) -> np.ndarray:
    q = np.round(kernel / scales)
    return np.clip(q, -127, 127).astype(np.int8)


def _v3_arrays(params) -> dict[tuple[int, str], np.ndarray]:
    """(conv index, "kernel" | "bias") -> f32 array (kernels HWIO) of a v3
    ``SignCenterNet`` or of its flat keystr dict."""
    flat = params if isinstance(params, Mapping) else flat_params(params)
    return {(i, name): np.asarray(flat[f"['Conv_{i}']['{name}']"], np.float32)
            for i in range(7) for name in ("kernel", "bias")}


def v3_float_activations(params, frames_u8) -> list[torch.Tensor]:
    """Post-relu activations [y0, y1, y2, y3] of the float v3 chain in f32,
    on the frames' device (numpy frames: the CPU), with full f32 products.

    ``params``: a v3 ``SignCenterNet`` or its flat keystr dict.  ``frames_u8``
    uint8 [B, H, W, 3] or patches8 [B, H/8, W/8, 192]."""
    arrays = _v3_arrays(params)
    x = frames_u8 if isinstance(frames_u8, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(frames_u8))
    dev = x.device

    def t(i, name):
        return torch.from_numpy(arrays[(i, name)]).to(dev)

    full_f32_matmuls()
    with torch.no_grad():
        if x.shape[-1] != _STEM_K:
            x = patchify(x)
        xf = x.to(torch.float32) / 255.0 - 0.5
        y = torch.relu(torch.matmul(xf, t(0, "kernel").reshape(_STEM_K, -1)) + t(0, "bias"))
        acts = [y]
        for i in _TRUNK:
            y = torch.relu(conv_same(y, t(i, "kernel").permute(3, 2, 0, 1), _TRUNK_STRIDES[i])
                           + t(i, "bias"))
            acts.append(y)
    return acts


def quantize_v3(params, calib_frames, percentile: float = 100.0,
                float_heads: bool = False) -> dict[str, np.ndarray]:
    """Float v3 parameters (a ``SignCenterNet`` or its flat keystr dict) ->
    the int8 serving arrays that :func:`save_quant_params` writes.

    ``calib_frames`` uint8 [N, H, W, 3], numpy or a tensor (a handful of
    real frames, H and W multiples of 16); the float chain runs on the
    model's device, else the frames'.  Returns ``q{i}_kernel`` int8 (stem
    [192, F], convs HWIO), ``q{i}_mult`` and ``q{i}_bias`` f32 [F] (the
    epilogue's per-channel multiplier and bias, the stem's input affine
    folded in), ``a{i}_inv`` f32 (requant multipliers, stem and trunk); with
    ``float_heads`` the heads keep ``f{i}_kernel``/``f{i}_bias`` and
    ``a3_scale`` dequantizes the trunk output."""
    arrays = _v3_arrays(params)
    if isinstance(params, nn.Module):
        calib_frames = (calib_frames if isinstance(calib_frames, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(calib_frames))
                        ).to(next(params.parameters()).device)
    a_scale = []
    for y in v3_float_activations(params, calib_frames):
        hi = float(np.percentile(y.cpu().numpy(), percentile))
        a_scale.append(max(hi, 1e-6) / 127.0)

    out: dict[str, np.ndarray] = {}
    # stem: the (x/255 - 0.5) input affine of uint8 frames re-centred to
    # int8 by xs = x - 128, folded into the epilogue
    k0 = arrays[(0, "kernel")].reshape(_STEM_K, -1)
    sw0 = _channel_scales(k0)
    out["q0_kernel"] = _quant_weight(k0, sw0)
    out["q0_mult"] = sw0 / 255.0
    out["q0_bias"] = arrays[(0, "bias")] + (128.0 / 255.0 - 0.5) * k0.sum(axis=0)
    out["a0_inv"] = np.float32(1.0 / a_scale[0])
    for i in _TRUNK:
        k = arrays[(i, "kernel")]
        sw = _channel_scales(k)
        out[f"q{i}_kernel"] = _quant_weight(k, sw)
        out[f"q{i}_mult"] = (a_scale[i - 1] * sw).astype(np.float32)
        out[f"q{i}_bias"] = arrays[(i, "bias")]
        out[f"a{i}_inv"] = np.float32(1.0 / a_scale[i])
    for i in _HEADS:
        k, b = arrays[(i, "kernel")], arrays[(i, "bias")]
        if float_heads:
            # the trunk output stays int8, dequantized inline per head conv
            out[f"f{i}_kernel"] = k
            out[f"f{i}_bias"] = b
            continue
        sw = _channel_scales(k)
        out[f"q{i}_kernel"] = _quant_weight(k, sw)
        out[f"q{i}_mult"] = (a_scale[3] * sw).astype(np.float32)
        out[f"q{i}_bias"] = b
    if float_heads:
        out["a3_scale"] = np.float32(a_scale[3])
    return out


class QuantV3Net:
    """The int8 v3 chain with ``SignCenterNet``'s calling convention, so the
    float detector's routes run it unchanged."""

    def __init__(self, q: dict):
        self.q = q
        self.device = q["q0_kernel"].device

    def __call__(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        return v3_int8_forward(self.q, x)

    def fused_upscaled(self, frames_u8, plan):
        return v3_int8_trunk_heads(self.q, fused_stem_int8(self.q, frames_u8, plan))


# ---------------------------------------------------------------------------
# Persistence + detector class
# ---------------------------------------------------------------------------


def save_quant_params(path: str, q: dict, arch: str = "v3",
                      score_threshold: float | None = None,
                      source_sha256: str | None = None) -> None:
    arrays = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
              for k, v in q.items()}
    arrays["__arch__"] = np.asarray(arch)
    arrays["__quant__"] = np.asarray("int8")
    if score_threshold is not None:
        arrays["__threshold__"] = np.asarray(score_threshold, np.float32)
    if source_sha256 is not None:
        arrays["__source_sha256__"] = np.asarray(source_sha256)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_quant_params(path: str, device="cuda") -> tuple[dict, dict]:
    """-> (q arrays as tensors on ``device``, meta dict with arch /
    score_threshold)."""
    meta: dict = {}
    q: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__arch__":
                meta["arch"] = str(data[key])
            elif key == "__threshold__":
                meta["score_threshold"] = float(data[key])
            elif not key.startswith("__"):
                q[key] = torch.from_numpy(np.array(data[key])).to(device)
    return q, meta


def saved_quant(path: str) -> str | None:
    """Quantization tag of a checkpoint ("int8") or None for float ones."""
    with np.load(path) as data:
        if "__quant__" in data.files:
            return str(data["__quant__"])
    return None


class QuantCNNDetector(CNNDetector):
    """Int8 drop-in for ``CNNDetector``: the same routes and contract."""

    def __init__(self, q: dict, cfg: CNNDetectorConfig | None = None, upscale: float = 1.0):
        cfg = cfg or CNNDetectorConfig(arch="v3")
        if cfg.arch != "v3":
            raise ValueError(f"the int8 path implements the v3 arch, not {cfg.arch!r}")
        super().__init__(QuantV3Net(q), cfg, upscale)
        self.q = q

    @classmethod
    def load(cls, path: str, cfg: CNNDetectorConfig | None = None, device="cuda"):
        q, meta = load_quant_params(path, device)
        return cls(q, cfg or CNNDetectorConfig(**meta))

    def save(self, path: str) -> None:
        save_quant_params(path, self.q, arch=self.cfg.arch,
                          score_threshold=self.cfg.score_threshold)


def load_detector(path: str, cfg: CNNDetectorConfig | None = None, upscale: float = 1.0,
                  device="cuda") -> CNNDetector:
    """Load a float or an int8 checkpoint by its own ``__quant__`` tag."""
    cls = QuantCNNDetector if saved_quant(path) == "int8" else CNNDetector
    det = cls.load(path, cfg, device)
    det.upscale = float(upscale)
    return det
