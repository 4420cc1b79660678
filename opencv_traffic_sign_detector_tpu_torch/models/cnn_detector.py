"""Convolutional center-point sign detector (the ``--detector CNN`` family).

Counterpart of ``opencv_traffic_sign_detector_tpu/models/cnn_detector.py``:
an anchor-free detector whose heads give, per grid cell, six class logits
(``hm``), a box size (``size``) and a sub-cell centre offset (``off``);
peaks of the 3x3 max-pool equality test are the detections.  Every arch of
the reference is here (``v3``, the shipped one, and ``slim``, ``base``,
``v2wide``, ``v2s16``, ``v2s16wide``); a checkpoint names its own arch.

The reference runs flax modules in NHWC; so do the public functions here.
Convs run on the NCHW views of NHWC tensors, which are channels-last, so
the permutes copy nothing.  What the reference's numbers depend on, and
this module keeps:

* flax's "SAME" padding: a stride-2 3x3 conv on an even size pads (0, 1),
  not (1, 1) as ``padding=1`` would;
* the bf16 rounding points: a conv rounds its result to bf16 and then adds
  the bias in bf16; the stem rounds after ``* 1/255``, after ``- 0.5`` and
  after its product, with bf16 constants;
* flax ``GroupNorm``: statistics in f32 as ``E[x^2] - E[x]^2`` clipped at
  0, epsilon 1e-6;
* decode's flat order is channel-minor (NHWC) and its top-k breaks ties
  toward the lower flat index (a stable sort, as ``lax.top_k``).

Parameters load from, and save to, the reference's npz checkpoints: keys
are ``jax.tree_util.keystr`` paths (``['Conv_1']['kernel']``), kernels HWIO,
converted to OIHW on load.
"""

from __future__ import annotations

import os
from collections.abc import Iterator, Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.gt import GroundTruthBox
from ..data.images import list_frame_files
from ..data.prefetch import batched_frames
from ..ops.fused_upscale import FusedUpscalePlan, find_plan, fused_upscale_stem
from ..ops.resident import resident, scalar
from ..ops.upscale import upscale_bilinear_u8
from ..ops.yuv import patchify_yuv_planes, yuv420_patches_to_bgr_patches8, yuv420_to_bgr
from ..runtime.graphs import CapturedFn
from .detector import full_f32_matmuls, pinned

STRIDE = 8
NUM_CLASSES = 6
_ARCH_STRIDE = {"v2s16": 16, "v2s16wide": 16, "v3": 16}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_PATCH = 8
_STEM_K = _PATCH * _PATCH * 3   # 192
HM_BIAS_INIT = -4.59            # the hm head's initial bias: a prior of ~0.01


@dataclass(frozen=True)
class CNNDetectorConfig:
    """Architecture + decode hyper-parameters (the reference's fields and
    defaults; loaders take ``arch`` and ``score_threshold`` from the
    checkpoint's own tags)."""

    stem_features: int = 64
    mid_features: int = 96
    deep_features: int = 128
    head_features: int = 96
    arch: str = "slim"
    max_detections: int = 32
    score_threshold: float = 0.50
    dtype: str = "bfloat16"

    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def stride(self) -> int:
        """Output grid stride of the decode heads for this architecture."""
        return _ARCH_STRIDE.get(self.arch, STRIDE)


def _const(value: float, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A scalar rounded to ``dtype`` first, as ``jnp.asarray(value, dtype)``
    (a Python float would enter a bf16 product unrounded), on ``like``'s
    device once (``ops/resident.py``)."""
    return resident(scalar, value, dtype, device=like.device)


def patchify(x: torch.Tensor, p: int = _PATCH) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H/p, W/p, p*p*3] with k = ky*p*3 + kx*3 + c (the
    flattened HWIO stem kernel order)."""
    b, h, w, c = x.shape
    return (x.reshape(b, h // p, p, w // p, p * c).permute(0, 1, 3, 2, 4)
            .reshape(b, h // p, w // p, p * p * c))


def _space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return (x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // r, w // r, r * r * c))


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` * OIHW ``weight`` with "SAME" padding, in the inputs' dtype."""
    k = weight.shape[-1]
    (top, bottom), (left, right) = (same_pads(x.shape[1], k, stride),
                                    same_pads(x.shape[2], k, stride))
    xc = x.permute(0, 3, 1, 2)
    if top == bottom and left == right:
        y = F.conv2d(xc, weight, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), weight, stride=stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Layers with the reference's flax parameter layout
# ---------------------------------------------------------------------------


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: variance scaling 1.0 over ``fan_in``,
    a normal truncated at two of its deviations, rescaled so that the
    truncated draw has variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


class _FlaxLeaf(nn.Module):
    """A layer whose parameters load from and save to the flax layout:
    ``_flax_names`` in the ``params`` collection, ``_flax_stats`` in
    ``batch_stats``."""

    _flax_stats: tuple[str, ...] = ()

    def flax_shapes(self) -> dict[str, tuple[int, ...]]:
        return {name: tuple(self.to_flax(name).shape)
                for name in self._flax_names + self._flax_stats}

    def to_flax(self, name: str) -> np.ndarray:
        return getattr(self, name).detach().cpu().numpy()

    def load_flax(self, name: str, arr: np.ndarray) -> None:
        with torch.no_grad():
            getattr(self, name).copy_(torch.from_numpy(np.array(arr, np.float32)))

    def init_flax(self, gen: torch.Generator) -> None:
        """flax's default initial values (scales 1, biases 0)."""
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()


class Conv(_FlaxLeaf):
    """flax ``nn.Conv`` ("SAME") in ``dtype``: the conv's result is rounded
    to ``dtype``, then the bias is added in ``dtype``.  ``bias_init`` is the
    bias's initial value (the ``hm`` head's prior, -4.59)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16,
                 bias_init: float = 0.0):
        super().__init__()
        self.stride, self.dtype, self.bias_init = stride, dtype, bias_init
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False) if bias else None
        self._flax_names = ("kernel", "bias") if bias else ("kernel",)

    def init_flax(self, gen):
        _lecun_normal_(self.weight, self.weight[0].numel(), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.fill_(self.bias_init)

    def to_flax(self, name):
        if name == "kernel":
            return self.weight.detach().permute(2, 3, 1, 0).cpu().numpy()
        return super().to_flax(name)

    def load_flax(self, name, arr):
        if name == "kernel":
            arr = np.ascontiguousarray(np.asarray(arr).transpose(3, 2, 0, 1))
            name = "weight"
        super().load_flax(name, arr)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = conv_same(x.to(dt), self.weight.to(dt), self.stride)
        return y if self.bias is None else y + self.bias.to(dt)


class GroupNorm(_FlaxLeaf):
    """flax ``nn.GroupNorm(num_groups=8, dtype=float32)`` on NHWC input:
    f32 statistics ``var = max(E[x^2] - E[x]^2, 0)``, epsilon 1e-6."""

    def __init__(self, features: int, groups: int = 8, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self._flax_names = ("bias", "scale")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        xg = x.to(torch.float32).reshape(b, h, w, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 2, 4), keepdim=True) - mean * mean, min=0)
        mul = torch.rsqrt(var + self.eps) * self.scale.reshape(self.groups, -1)
        return ((xg - mean) * mul + self.bias.reshape(self.groups, -1)).reshape(b, h, w, c)


class ConvBlock(nn.Module):
    """The reference's ``_ConvBlock``: conv (no bias) -> GroupNorm -> relu;
    f32 out."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, stride=stride, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(cout)

    def forward(self, x):
        return torch.relu(self.GroupNorm_0(self.Conv_0(x)))


class PatchifyStem(_FlaxLeaf):
    """The v3 8x8-stride-8 stem as patchify + one K=192 product.

    Takes frames uint8 [B, H, W, 3] (patchified here) or patches uint8
    [B, H/8, W/8, 192] (the ``patches8`` layout).  The kernel is kept as
    the [192, F] matrix of the flax [8, 8, 3, F] kernel."""

    def __init__(self, features: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(_STEM_K, features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self._flax_names = ("bias", "kernel")

    def kernel_hwio(self) -> torch.Tensor:
        return self.kernel.reshape(_PATCH, _PATCH, 3, -1)

    def to_flax(self, name):
        if name == "kernel":
            return self.kernel_hwio().detach().cpu().numpy()
        return super().to_flax(name)

    def load_flax(self, name, arr):
        if name == "kernel":
            arr = np.asarray(arr).reshape(_STEM_K, -1)
        super().load_flax(name, arr)

    def init_flax(self, gen):
        _lecun_normal_(self.kernel, _STEM_K, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if x.shape[-1] != _STEM_K:
            x = patchify(x)
        x = x.to(dt) * _const(1 / 255.0, x, dt) - _const(0.5, x, dt)
        out = torch.matmul(x, self.kernel.to(dt))
        return torch.relu(out + self.bias.to(dt))


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def _add_v3_trunk_heads(m: nn.Module, dt: torch.dtype) -> None:
    m.Conv_1 = Conv(64, 128, stride=2, dtype=dt)
    m.Conv_2 = Conv(128, 128, dtype=dt)
    m.Conv_3 = Conv(128, 128, dtype=dt)
    m.Conv_4 = Conv(128, NUM_CLASSES, dtype=dt, bias_init=HM_BIAS_INIT)
    m.Conv_5 = Conv(128, 2, dtype=dt)
    m.Conv_6 = Conv(128, 2, dtype=dt)


def _v3_trunk_heads(m: nn.Module, stem: torch.Tensor) -> dict[str, torch.Tensor]:
    x = torch.relu(m.Conv_1(stem))
    x = torch.relu(m.Conv_2(x))
    fin = torch.relu(m.Conv_3(x))
    return {"hm": m.Conv_4(fin).float(), "size": m.Conv_5(fin).float(),
            "off": m.Conv_6(fin).float()}


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x of NHWC (``jax.image.resize(..., "nearest")``)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class SignCenterNet(nn.Module):
    """Anchor-free center detector over the six GTSDB super-types.

    Input uint8 BGR frames [B, H, W, 3] (H, W multiples of 16), or for v3
    ``patches8`` [B, H/8, W/8, 192].  Output dict of f32 NHWC maps on the
    ``cfg.stride`` grid: ``hm`` [.., 6] logits, ``size`` [.., 2] (w, h) in
    grid units, ``off`` [.., 2] sub-cell offsets.  Children carry the flax
    module names, so the checkpoint keys map onto them one to one."""

    def __init__(self, cfg: CNNDetectorConfig | None = None):
        super().__init__()
        self.cfg = cfg = cfg or CNNDetectorConfig()
        dt = cfg.compute_dtype()
        blocks: list[tuple[int, int, int]]     # (cin, cout, stride) per _ConvBlock
        if cfg.arch == "v3":
            self.Conv_0 = PatchifyStem(64, dt)
            _add_v3_trunk_heads(self, dt)
            return
        if cfg.arch in ("v2s16", "v2s16wide"):
            w = 256 if cfg.arch == "v2s16wide" else 192
            blocks = [(48, w // 2, 2), (w // 2, w, 2), (w, w, 1), (w, w, 1), (w, w, 1)]
            heads, head_in, head_dt = 0, w, dt
        elif cfg.arch == "v2wide":
            blocks = [(48, 128, 2), (128, 256, 2), (256, 256, 1), (256, 256, 1), (128, 128, 1)]
            self.Conv_0 = Conv(256, 128, k=1, dtype=dt)
            heads, head_in, head_dt = 1, 128, dt
        elif cfg.arch in ("slim", "base"):
            s, mid, deep, head = (cfg.stem_features, cfg.mid_features, cfg.deep_features,
                                  cfg.head_features)
            if cfg.arch == "slim":
                blocks = [(48, s, 2), (s, mid, 1), (mid, mid, 2), (mid, deep, 1),
                          (deep, deep, 1), (mid, head, 1), (head, head, 1)]
                self.Conv_0 = Conv(deep, mid, k=1, dtype=dt)
                heads, head_dt = 1, dt
            else:
                blocks = [(48, s, 1), (s, s, 2), (s, mid, 1), (mid, mid, 2), (mid, deep, 1),
                          (deep, deep, 1), (mid + deep, head, 1), (head, head, 1)]
                heads, head_dt = 0, torch.float32
            head_in = head
        else:
            raise ValueError(f"unknown CNN detector arch {cfg.arch!r}")
        for i, (cin, cout, stride) in enumerate(blocks):
            setattr(self, f"_ConvBlock_{i}", ConvBlock(cin, cout, stride, dt))
        for j, cout in enumerate((NUM_CLASSES, 2, 2)):
            setattr(self, f"Conv_{heads + j}",
                    Conv(head_in, cout, dtype=head_dt, bias_init=HM_BIAS_INIT if j == 0 else 0.0))
        self._heads = heads

    def _block(self, i: int) -> ConvBlock:
        return getattr(self, f"_ConvBlock_{i}")

    @property
    def device(self) -> torch.device:
        return self.Conv_0.bias.device

    def forward(self, frames_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        if cfg.arch == "v3":
            return _v3_trunk_heads(self, self.Conv_0(frames_u8))
        dt = cfg.compute_dtype()
        x = frames_u8.to(dt) * _const(1 / 255.0, frames_u8, dt) - _const(0.5, frames_u8, dt)
        x = _space_to_depth(x, 4)                            # [B, H/4, W/4, 48]
        blk = self._block
        if cfg.arch in ("v2s16", "v2s16wide"):
            for i in range(5):
                x = blk(i)(x)
            fin = x
        elif cfg.arch == "v2wide":
            s8 = blk(0)(x)
            x = blk(3)(blk(2)(blk(1)(s8)))
            fin = blk(4)(s8 + _upsample2(self.Conv_0(x)))
        else:
            slim = cfg.arch == "slim"
            if slim:
                x = blk(0)(x)
                first = 1
            else:
                x = blk(1)(blk(0)(x))
                first = 2
            s8 = blk(first)(x)
            x = blk(first + 3)(blk(first + 2)(blk(first + 1)(s8)))
            if slim:
                fused = s8 + _upsample2(self.Conv_0(x))
            else:
                fused = torch.cat([s8, _upsample2(x)], dim=-1)
            fin = blk(first + 5)(blk(first + 4)(fused))
        h = self._heads
        return {name: getattr(self, f"Conv_{h + j}")(fin).float()
                for j, name in enumerate(("hm", "size", "off"))}

    def fused_upscaled(self, frames_u8: torch.Tensor,
                       plan: FusedUpscalePlan) -> dict[str, torch.Tensor]:
        """v3 head maps at the upscaled resolution through the folded
        upscale+patchify+stem (``ops/fused_upscale.py``), then the trunk."""
        stem = fused_upscale_stem(frames_u8, self.Conv_0.kernel_hwio(), self.Conv_0.bias,
                                  plan, self.cfg.compute_dtype())
        return _v3_trunk_heads(self, stem)


class V3TrunkHeads(nn.Module):
    """The v3 chain from stem activations on (Conv_1..Conv_6), parameter
    compatible with ``SignCenterNet``'s v3 branch minus ``Conv_0``."""

    def __init__(self, cfg: CNNDetectorConfig | None = None):
        super().__init__()
        self.cfg = cfg or CNNDetectorConfig(arch="v3")
        _add_v3_trunk_heads(self, self.cfg.compute_dtype())

    def forward(self, stem_out: torch.Tensor) -> dict[str, torch.Tensor]:
        return _v3_trunk_heads(self, stem_out)


# ---------------------------------------------------------------------------
# Parameter persistence (the reference's npz format)
# ---------------------------------------------------------------------------


def flax_entries(module: nn.Module, prefix: str = "", collection: str = "params"
                 ) -> Iterator[tuple[str, _FlaxLeaf, str]]:
    """(keystr, layer, flax name) for every array of ``collection``
    (``params`` or ``batch_stats``), keyed as ``jax.tree_util.keystr`` keys
    that collection of the reference's variables."""
    for child_name, child in module.named_children():
        path = f"{prefix}['{child_name}']"
        if isinstance(child, _FlaxLeaf):
            names = child._flax_names if collection == "params" else child._flax_stats
            for name in names:
                yield f"{path}['{name}']", child, name
        else:
            yield from flax_entries(child, path, collection)


def load_flat_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                     source: str = "params", collection: str = "params") -> nn.Module:
    """Fill ``model``'s ``collection`` from a flat keystr -> array dict (an
    npz, or the reference's ``tree_flatten_with_path`` of that collection),
    checking every key and shape with the reference's messages.  Returns
    ``model``."""
    for key, layer, name in flax_entries(model, collection=collection):
        if key not in flat:
            raise ValueError(f"checkpoint {source} is missing parameter {key}")
        arr = flat[key]
        want = layer.flax_shapes()[name]
        if tuple(arr.shape) != want:
            raise ValueError(
                f"checkpoint {source} parameter {key} has shape {tuple(arr.shape)}, "
                f"model expects {want}")
        layer.load_flax(name, arr)
    return model


def params_from_flat(cfg: CNNDetectorConfig, flat: Mapping[str, np.ndarray],
                     device="cuda") -> SignCenterNet:
    """The reference's flat parameter dict -> a ``SignCenterNet`` on ``device``."""
    return load_flat_params(SignCenterNet(cfg), flat).to(device)


def flat_params(model: nn.Module, collection: str = "params") -> dict[str, np.ndarray]:
    """A copy of ``model``'s ``collection`` in the reference's flat keystr
    layout (on the CPU a tensor's numpy view would follow later updates)."""
    return {key: np.array(layer.to_flax(name))
            for key, layer, name in flax_entries(model, collection=collection)}


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Give every layer of ``model`` flax's default initial values, drawn
    from ``seed``: truncated lecun-normal kernels, zero biases but the
    ``hm`` head's -4.59, norm scales 1 and biases 0, running means 0 and
    variances 1.  The values cannot be the reference's (another generator).
    Returns ``model``."""
    gen = torch.Generator().manual_seed(seed)
    for layer in model.modules():
        if isinstance(layer, _FlaxLeaf):
            layer.init_flax(gen)
    return model


def save_params(path: str, model: nn.Module, arch: str | None = None,
                score_threshold: float | None = None) -> None:
    arrays = flat_params(model)
    if arch is not None:
        arrays["__arch__"] = np.asarray(arch)
    if score_threshold is not None:
        arrays["__threshold__"] = np.asarray(score_threshold, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def saved_meta(path: str) -> dict:
    """Read the metadata tags stored in a checkpoint (may be empty)."""
    meta: dict = {}
    with np.load(path) as data:
        if "__arch__" in data.files:
            meta["arch"] = str(data["__arch__"])
        if "__threshold__" in data.files:
            meta["score_threshold"] = float(data["__threshold__"])
    return meta


def saved_arch(path: str) -> str | None:
    """Read the arch tag stored in a checkpoint, if present."""
    return saved_meta(path).get("arch")


def load_params(path: str, model: nn.Module) -> nn.Module:
    with np.load(path) as data:
        return load_flat_params(model, data, path)


# ---------------------------------------------------------------------------
# Decode and the detection routes
# ---------------------------------------------------------------------------


def decode_detections(outputs: dict, k: int, score_threshold: float, stride: int = STRIDE):
    """Head maps -> top-k boxes per frame: (boxes [B,k,4] f32 xyxy pixels,
    cls [B,k] int32 1..6, scores [B,k] f32, valid [B,k] bool).  A cell is a
    peak iff it is the maximum of its 3x3 neighbourhood in its class map."""
    prob = torch.sigmoid(outputs["hm"])                      # [B, Hc, Wc, C]
    b, hc, wc, c = prob.shape
    pooled = F.max_pool2d(prob.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    peaks = torch.where(prob >= pooled, prob, 0.0).reshape(b, hc * wc * c)
    scores, idx = torch.sort(peaks, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    cls = (idx % c).to(torch.int32)
    cell = idx // c
    cy = (cell // wc).to(torch.float32)
    cx = (cell % wc).to(torch.float32)

    def gather(m):                                           # [B, Hc, Wc, 2]
        return torch.gather(m.reshape(b, hc * wc, 2), 1, cell[:, :, None].expand(b, k, 2))

    wh = torch.clamp(gather(outputs["size"]), min=0.0)
    off = torch.clamp(gather(outputs["off"]), 0.0, 1.0)
    pcx = (cx + off[..., 0]) * stride
    pcy = (cy + off[..., 1]) * stride
    pw = wh[..., 0] * stride
    ph = wh[..., 1] * stride
    boxes = torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2, pcy + ph / 2], dim=-1)
    thr = resident(scalar, float(score_threshold), torch.float32, device=scores.device)
    valid = (scores >= thr) & (pw > 2) & (ph > 2)
    return boxes, cls + 1, scores, valid


def _box_scale(sx: float, sy: float) -> torch.Tensor:
    return torch.tensor([sx, sy, sx, sy], dtype=torch.float32)


def rescale_boxes(boxes: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Map decoded xyxy boxes from the upscaled grid back to native pixels."""
    return boxes / resident(_box_scale, float(sx), float(sy), device=boxes.device)


def upscale_frames(frames_u8: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Bilinear upscale of [B, H, W, C] uint8 frames to (th, tw), uint8: the
    two-stage route's resize (``ops/upscale.py: upscale_bilinear_u8``)."""
    return upscale_bilinear_u8(frames_u8, th, tw)


def upscaled_hw(h: int, w: int, scale: float, stride: int = 16) -> tuple[int, int]:
    """Target dims for upscaled inference: scale, rounded to the stride."""
    th = max(stride, int(round(h * scale / stride)) * stride)
    tw = max(stride, int(round(w * scale / stride)) * stride)
    return th, tw


def _detect(net, x, k, thresh, stride):
    """Native route: frames [B,H,W,3] or patches8 -> detections."""
    return decode_detections(net(x), k, thresh, stride)


def _detect_upscaled(net, frames, k, thresh, stride, th, tw):
    """Two-stage route: bilinear uint8 frames at (th, tw), the forward, and
    boxes mapped back by (tw/w, th/h)."""
    h, w = frames.shape[1:3]
    boxes, cls, scores, valid = _detect(net, upscale_bilinear_u8(frames, th, tw), k, thresh,
                                        stride)
    return rescale_boxes(boxes, tw / w, th / h), cls, scores, valid


def _detect_fused_upscaled(net, frames, k, thresh, stride, plan):
    """Fused route: the folded upscale+stem on native pixels, the trunk,
    boxes mapped back by t/a on both axes."""
    boxes, cls, scores, valid = decode_detections(net.fused_upscaled(frames, plan), k,
                                                  thresh, stride)
    sx, sy = plan.rescale_factors()
    return rescale_boxes(boxes, sx, sy), cls, scores, valid


def _detect_yuv_patches(net, y_p, cb_p, cr_p, k, thresh, stride):
    """Patchified 4:2:0 planes -> BGR patches8 in patch space -> forward."""
    return _detect(net, yuv420_patches_to_bgr_patches8(y_p, cb_p, cr_p), k, thresh, stride)


@dataclass(frozen=True)
class Route:
    """What a detection route bakes into its program: the reference's static
    jit arguments, and the key of a dispatch's CUDA graph.

    ``name``: ``native``, ``upscaled`` (two-stage), ``fused`` (the folded
    upscale+stem) or ``yuv_patches``; ``yuv``: tight 4:2:0 planes converted
    on the device first; the net, by identity; the decode's ``k``,
    ``thresh`` (a resident scalar) and ``stride``; the arch and compute
    dtype; ``upscale`` with the fused ``plan`` or the two-stage ``size``;
    the input's ``layout`` (ndim, last dimension)."""

    name: str
    yuv: bool
    net: object
    arch: str
    k: int
    thresh: float
    stride: int
    dtype: str
    upscale: float
    plan: FusedUpscalePlan | None
    size: tuple[int, int] | None
    layout: tuple[int, int]


def run_route(route: Route, x, *tensors):
    """``route`` on a batch on the net's device: frames or patches8, or the
    three 4:2:0 planes as a tuple.  The function a dispatch's graph
    captures; ``tensors`` are the net's (:func:`net_tensors`), which the
    route reads through the net and the graph by address."""
    net, k, thresh, stride = route.net, route.k, route.thresh, route.stride
    if route.name == "yuv_patches":
        return _detect_yuv_patches(net, *x, k, thresh, stride)
    if route.yuv:
        x = yuv420_to_bgr(*x)
    if route.name == "fused":
        return _detect_fused_upscaled(net, x, k, thresh, stride, route.plan)
    if route.name == "upscaled":
        return _detect_upscaled(net, x, k, thresh, stride, *route.size)
    return _detect(net, x, k, thresh, stride)


def net_tensors(net) -> tuple:
    """The tensors a route reads of ``net``: a module's parameters and
    buffers, or the int8 net's ``q`` arrays.  A dispatch passes them to its
    graph as constants, held by identity: a replaced one makes a new
    capture."""
    q = getattr(net, "q", None)
    return tuple(q.values()) if q is not None else (*net.parameters(), *net.buffers())


def unmatched_detections(ref: list[GroundTruthBox], got: list[GroundTruthBox],
                         score_tol: float, threshold: float,
                         box_tol: int = 1) -> list[GroundTruthBox]:
    """Detections of either list without a counterpart in the other: same
    file and class, every corner within ``box_tol`` px, score within
    ``score_tol``.  Detections whose score lies within ``score_tol`` of
    ``threshold`` may be missing from the other side and are not counted.
    The agreement test between two implementations that round bf16 at
    other places."""
    def has_match(d, pool):
        return any(e.filename == d.filename and e.class_id == d.class_id
                   and abs(e.score - d.score) <= score_tol
                   and max(abs(e.x1 - d.x1), abs(e.y1 - d.y1), abs(e.x2 - d.x2),
                           abs(e.y2 - d.y2)) <= box_tol
                   for e in pool)

    return [d for a, b in ((ref, got), (got, ref)) for d in a
            if abs(d.score - threshold) > score_tol and not has_match(d, b)]


class _HostCopy:
    """A dispatched batch's outputs being copied to pinned host memory; an
    event marks the copy's end (on the CPU the outputs are kept as they
    are)."""

    def __init__(self, outputs):
        self.done = None
        if outputs[0].device.type != "cuda":
            self.host = outputs
            return
        self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in outputs)
        for h, t in zip(self.host, outputs):
            h.copy_(t, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def numpy(self) -> list[np.ndarray]:
        if self.done is not None:
            self.done.synchronize()
        return [t.numpy() for t in self.host]


class CNNDetector:
    """Batched full-frame detector over saved weights, with the reference's
    dispatch/collect contract: ``dispatch`` enqueues a batch on the device
    and returns its outputs, ``collect`` turns them into records.

    On a card each dispatch replays one CUDA graph of its route
    (``runtime/graphs.py: CapturedFn``), as the reference runs one jitted
    program a route: captured at the first batch of each card, input shape
    and :class:`Route` (which holds the net, the threshold and ``upscale``,
    so a ``copy.copy`` with another ``upscale`` or a replaced ``cfg`` makes
    its own graph in the one :class:`CapturedFn` they share), with the net's
    tensors as constants.  The graphs share the card's memory pool with the
    MSER dispatches' and are replayed in turn on the current stream.
    :attr:`eager` set on a detector (or on the class) runs the routes
    eagerly instead (comparisons, profiler traces); the CPU always does."""

    eager = False

    def __init__(self, net, cfg: CNNDetectorConfig | None = None, upscale: float = 1.0):
        self.cfg = cfg or net.cfg
        self.net = net
        self.upscale = float(upscale)
        self.graphs = CapturedFn(run_route, keyed=True)

    @property
    def device(self) -> torch.device:
        return self.net.device

    def _fused_plan(self, h: int, w: int) -> FusedUpscalePlan | None:
        """Fused upscale+stem plan for this operating point, or None."""
        if self.upscale == 1.0 or self.cfg.arch != "v3":
            return None
        return find_plan(h, w, self.upscale)

    @classmethod
    def load(cls, path: str, cfg: CNNDetectorConfig | None = None, device="cuda"):
        if cfg is None:
            cfg = CNNDetectorConfig(**saved_meta(path))
        return cls(load_params(path, SignCenterNet(cfg)).to(device), cfg)

    def save(self, path: str) -> None:
        save_params(path, self.net, arch=self.cfg.arch,
                    score_threshold=self.cfg.score_threshold)

    def route(self, x) -> Route:
        """The route of this operating point for ``x`` (an array or tensor,
        only its shape read): frames [B,H,W,3] or patches8 [B,H/8,W/8,192],
        or a tuple of 4:2:0 planes, tight (Y [B,H,W]) or patchified (Y
        [B,H/8,W/8,64])."""
        yuv = isinstance(x, tuple)
        shape = tuple((x[0] if yuv else x).shape)
        cfg, ndim = self.cfg, len(shape)
        name, plan, size = "native", None, None
        if yuv and ndim == 4:
            if self.upscale != 1.0 or cfg.arch != "v3":
                raise ValueError(
                    "patchified yuv planes need the v3 arch at native "
                    "resolution (use tight planes for --upscale or other "
                    "arches)")
            name = "yuv_patches"
        elif self.upscale != 1.0:
            if not yuv and shape[-1] != 3:
                raise ValueError(
                    "upscaled inference needs [B,H,W,3] frames; the "
                    "patches8 layout is pre-patchified at native "
                    "resolution (use --input_format bgr or yuv420)")
            plan = self._fused_plan(shape[1], shape[2])
            if plan is not None:
                name = "fused"
            else:
                name, size = "upscaled", upscaled_hw(shape[1], shape[2], self.upscale, cfg.stride)
        return Route(name, yuv and ndim == 3, self.net, cfg.arch, cfg.max_detections,
                     cfg.score_threshold, cfg.stride, cfg.dtype, self.upscale, plan, size,
                     (ndim, int(shape[-1])))

    def detect(self, x):
        """The route, eagerly, of a batch already on the net's device: a
        tensor of frames or patches8, or the three 4:2:0 planes as a tuple.
        The entry a caller's own capture runs (``models/rec_pipeline.py:
        recognize_batch_cnn``): a graph cannot be captured inside another's
        capture."""
        return run_route(self.route(x), x)

    def _dispatch(self, x):
        full_f32_matmuls()
        route, dev = self.route(x), self.device
        x = tuple(pinned(p, dev) for p in x) if isinstance(x, tuple) else pinned(x, dev)
        return self.graphs(dev, x, *net_tensors(self.net), key=route, eager=self.eager)

    @torch.inference_mode()
    def dispatch(self, frames):
        """frames uint8 [B,H,W,3] BGR with H,W multiples of 16, or (v3,
        native resolution) patches8 [B,H/8,W/8,192]; numpy, pinned or on
        the card.  -> (boxes, cls, scores, valid) on the device.

        On a card these are the graph's static outputs: the next dispatch
        with the same route and shape rewrites them.  Every caller in the
        package reads them, or copies them to pinned memory on the same
        stream (:class:`_HostCopy`), before it dispatches again; a caller
        that keeps outputs past its next call clones them."""
        return self._dispatch(frames)

    @torch.inference_mode()
    def dispatch_yuv(self, y, cb, cr):
        """Raw 4:2:0 planes, converted on the device.  Two layouts, keyed on
        ndim: tight planes y [B,H,W], cb/cr [B,H/2,W/2]; or patchified planes
        (v3 at native resolution) y [B,H/8,W/8,64], cb/cr [B,H/8,W/8,16].
        Outputs as :meth:`dispatch`'s."""
        return self._dispatch((y, cb, cr))

    def collect(self, handles, filenames: list[str],
                orig_hw: tuple[int, int] | None = None) -> list[GroundTruthBox]:
        if not isinstance(handles, _HostCopy):
            handles = _HostCopy(handles)
        boxes, cls, scores, valid = handles.numpy()
        dets: list[GroundTruthBox] = []
        for i, name in enumerate(filenames):
            for j in range(boxes.shape[1]):
                if not valid[i, j]:
                    continue
                x1, y1, x2, y2 = boxes[i, j]
                if orig_hw is not None:
                    h, w = orig_hw
                    x1, x2 = np.clip([x1, x2], 0, w - 1)
                    y1, y2 = np.clip([y1, y2], 0, h - 1)
                if x2 - x1 < 2 or y2 - y1 < 2:
                    continue
                dets.append(GroundTruthBox(
                    filename=name,
                    x1=int(round(float(x1))), y1=int(round(float(y1))),
                    x2=int(round(float(x2))), y2=int(round(float(y2))),
                    class_id=int(cls[i, j]),
                    score=float(scores[i, j])))
        return dets

    def detect_frames(self, frames, filenames: list[str],
                      orig_hw: tuple[int, int] | None = None) -> list[GroundTruthBox]:
        """Run one batch of frames (as :meth:`dispatch` takes them) and
        unpack it into records, boxes clipped to ``orig_hw`` when given."""
        return self.collect(self.dispatch(frames), filenames, orig_hw)

    def run_directory(self, directory: str, batch_size: int = 32, progress: bool = False,
                      input_format: str = "bgr") -> list[GroundTruthBox]:
        """Detect over a dataset directory: frames are decoded ahead on a
        background thread and one batch stays in flight (its outputs copy
        to the host while the next batch is decoded and dispatched).

        ``yuv420`` ships raw 4:2:0 planes (1.5 bytes/px) and converts on
        the device; on v3 at native resolution it becomes ``yuv420p``, the
        same planes patchified on the host.  ``patches8`` decodes into the
        stem's layout."""
        if input_format == "yuv420" and self.cfg.arch == "v3" and self.upscale == 1.0:
            input_format = "yuv420p"
        files = list_frame_files(directory)
        dets: list[GroundTruthBox] = []
        pending = None
        done = 0
        orig_hw = None
        # yuv420p: tight planes from the loader, patchified by this package
        load_format = "yuv420" if input_format == "yuv420p" else input_format
        for frames, names in batched_frames(directory, files, batch_size,
                                            input_format=load_format):
            if isinstance(frames, tuple):
                h, w = frames[0].shape[1:3]
                if input_format == "yuv420p" and h % 8 == 0 and w % 8 == 0:
                    frames = patchify_yuv_planes(*frames)
                if orig_hw is None:
                    scale = 8 if frames[0].ndim == 4 else 1
                    orig_hw = (int(frames[0].shape[1]) * scale, int(frames[0].shape[2]) * scale)
                out = _HostCopy(self.dispatch_yuv(*frames))
            else:
                if orig_hw is None:
                    scale = 8 if frames.shape[-1] == 192 else 1
                    orig_hw = (int(frames.shape[1]) * scale, int(frames.shape[2]) * scale)
                out = _HostCopy(self.dispatch(frames))
            if pending is not None:
                dets.extend(d for d in self.collect(*pending) if d.filename != "__pad__")
                done = min(done + batch_size, len(files))
                if progress:
                    print(f"  processed {done}/{len(files)} frames")
            pending = (out, names, orig_hw)
        if pending is not None:
            dets.extend(d for d in self.collect(*pending) if d.filename != "__pad__")
            if progress:
                print(f"  processed {len(files)}/{len(files)} frames")
        return dets
