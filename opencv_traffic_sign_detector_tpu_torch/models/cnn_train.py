"""Training of the CNN sign detector, with the training set resident on the
device.

Counterpart of ``opencv_traffic_sign_detector_tpu/models/cnn_train.py``.
The whole training set is uploaded once; a step then draws its random
values on the device from ``(seed, step)`` alone, cuts and augments its
crops, renders CenterNet targets, and runs the forward pass, the backward
pass and the AdamW update, so the host hands over a step counter and reads
one scalar every ``log_every`` steps.  On a card the step is one CUDA graph,
captured at the first step and replayed for every later one, as the
reference jits its whole step (:class:`TrainStep`).

What the reference's numbers depend on, and this module keeps:

* the scale jitter is ``jax.image.scale_and_translate(method="linear")``
  with antialiasing, taken here as two products with per-sample weight
  matrices (``ops/upscale.py: scale_translate_weights``), and the colour
  jitter truncates to uint8;
* a crop's random values are split from its sampling (:func:`sample_draws`,
  :func:`crops_from_draws`), so tests feed the reference's own draws in;
* the center cell of a box truncates toward zero, and boxes on one cell
  average their size and offset targets;
* the v3 twin's BatchNorm is flax's: momentum 0.99, epsilon 1e-5, the
  biased batch variance ``max(E[x^2] - E[x]^2, 0)`` in f32;
* AdamW on every parameter, its learning rate optax's
  ``warmup_cosine_decay_schedule`` at the optimizer's own update count,
  which starts at 0: the first update is 0.

Supervision is the standard CenterNet recipe: penalty-reduced focal loss on
per-class center heatmaps with Gaussian targets, L1 on sub-cell offsets and
box sizes at the positive cells.  Unmapped GTSDB classes (the evaluation's
ignore regions) mask the heatmap loss.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.gt import boxes_by_file, load_ground_truth
from ..data.images import list_frame_files, load_image_bgr
from ..ops.mser import stage_scope
from ..ops.upscale import scale_translate_weights
from ..runtime import graphs
from .cnn_detector import (
    NUM_CLASSES,
    CNNDetectorConfig,
    Conv,
    SignCenterNet,
    _const,
    _FlaxLeaf,
    flat_params,
    init_params,
    load_flat_params,
)
from .detector import full_f32_matmuls

MAX_GT = 8          # max gt boxes per GTSDB frame is 6
CROP = 320          # training crop fed to the network
SLICE = 448         # raw slice taken before scale jitter (>= CROP / min_zoom)
BN_EPS = 1e-5       # flax nn.BatchNorm's default
BN_MOMENTUM = 0.99


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    steps: int = 4000
    lr: float = 2.5e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 200
    pos_fraction: float = 0.7     # crops centered near a gt sign
    min_zoom: float = 0.75        # output px per input px
    max_zoom: float = 1.4
    size_loss_weight: float = 0.1
    offset_loss_weight: float = 1.0
    seed: int = 0


# ---------------------------------------------------------------------------
# Host-side dataset assembly (runs once)
# ---------------------------------------------------------------------------


def pack_dataset(frames: np.ndarray, boxes: list) -> dict[str, np.ndarray]:
    """Frames [N, H, W, 3] uint8 (BGR) and, per frame, its gt boxes as
    ``(x1, y1, x2, y2, class)`` -> padded numpy arrays:

      frames  [N, H, W, 3] uint8 (BGR)
      boxes   [N, MAX_GT, 4] float32 xyxy
      cls     [N, MAX_GT] int32  (1..6 sign, -1 ignore, 0 padding)
      pos     [P, 3] float32 (frame_idx, cx, cy) one row per mapped gt box
    """
    all_boxes = np.zeros((len(frames), MAX_GT, 4), np.float32)
    all_cls = np.zeros((len(frames), MAX_GT), np.int32)
    pos = []
    for i, found in enumerate(boxes):
        for j, (x1, y1, x2, y2, c) in enumerate(found[:MAX_GT]):
            all_boxes[i, j] = (x1, y1, x2, y2)
            all_cls[i, j] = c
            if c > 0:
                pos.append((i, (x1 + x2) / 2.0, (y1 + y2) / 2.0))
    return {"frames": frames, "boxes": all_boxes, "cls": all_cls,
            "pos": np.asarray(pos, np.float32).reshape(-1, 3)}


def build_dataset(train_dir: str, gt_name: str = "gt.txt") -> dict[str, np.ndarray]:
    """Every frame of ``train_dir`` and its gt as :func:`pack_dataset`'s
    arrays."""
    gt = boxes_by_file(load_ground_truth(os.path.join(train_dir, gt_name)))
    files = list_frame_files(train_dir)
    frames = np.stack([load_image_bgr(os.path.join(train_dir, f)) for f in files])
    return pack_dataset(frames, [[(b.x1, b.y1, b.x2, b.y2, b.class_id) for b in gt.get(f, [])]
                                 for f in files])


# ---------------------------------------------------------------------------
# On-device crop sampling and augmentation
# ---------------------------------------------------------------------------


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` alone, as the
    reference folds ``step`` into ``PRNGKey(seed)``: a step's draws do not
    depend on the steps before it."""
    return _seeded((seed, step), device)


def shard_generator(seed: int, step: int, shard: int, device) -> torch.Generator:
    """:func:`step_generator` of one shard of a data mesh, seeded from
    ``(seed, step, shard)``, as the reference folds the step and then the
    device index into ``PRNGKey(seed)`` (``parallel/cnn.py``)."""
    return _seeded((seed, step, shard), device)


def _seeded(entropy: tuple[int, ...], device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed_state(entropy))


def _seed_state(entropy: tuple[int, ...]) -> int:
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def sample_draws(gen: torch.Generator, batch: int, n_frames: int, n_pos: int,
                 cfg: TrainConfig) -> dict[str, torch.Tensor]:
    """The random values of ``batch`` crops, on ``gen``'s device, scaled to
    the ranges of the reference's ``_sample_crop``: ``src`` (uniform, a
    positive crop below ``pos_fraction``), ``frame`` and ``pos_idx``
    (integers), ``jitter`` [B, 2] in +-CROP/3, ``zoom`` in
    [min_zoom, max_zoom), ``uv`` [B, 2] (uniform), ``bright`` in [-30, 30),
    ``contrast`` in [0.7, 1.3) and ``win`` [B, 2] (uniform)."""
    dev = gen.device

    def uniform(*shape, lo=0.0, hi=1.0):
        u = torch.rand((batch, *shape), generator=gen, device=dev)
        return u * (hi - lo) + lo

    return {
        "src": uniform(),
        "frame": torch.randint(0, n_frames, (batch,), generator=gen, device=dev),
        "pos_idx": torch.randint(0, n_pos, (batch,), generator=gen, device=dev),
        "jitter": uniform(2, lo=-CROP / 3, hi=CROP / 3),
        "zoom": uniform(lo=cfg.min_zoom, hi=cfg.max_zoom),
        "uv": uniform(2),
        "bright": uniform(lo=-30.0, hi=30.0),
        "contrast": uniform(lo=0.7, hi=1.3),
        "win": uniform(2),
    }


def crops_from_draws(draws: dict[str, torch.Tensor], data: dict[str, torch.Tensor],
                     cfg: TrainConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Augmented crops of ``data`` (:func:`pack_dataset`'s arrays on the
    device, :func:`upload_dataset`) at ``draws``: -> (images [B, CROP,
    CROP, 3] uint8, boxes
    [B, MAX_GT, 4] f32 in crop pixels, cls [B, MAX_GT] int32 with boxes
    outside the crop, smaller than 6 px or padding set to 0)."""
    frames, boxes, cls, pos = data["frames"], data["boxes"], data["cls"], data["pos"]
    _, img_h, img_w, _ = frames.shape
    b = draws["src"].shape[0]
    dev = frames.device

    # --- a frame and a slice origin: near a sign, or anywhere ------------
    use_pos = draws["src"] < cfg.pos_fraction
    prow = pos[draws["pos_idx"]]
    jit, ruv = draws["jitter"], draws["uv"]
    fidx = torch.where(use_pos, prow[:, 0].to(torch.int32), draws["frame"].to(torch.int32)).long()
    ox = torch.where(use_pos, prow[:, 1] + jit[:, 0] - SLICE / 2, ruv[:, 0] * (img_w - SLICE))
    oy = torch.where(use_pos, prow[:, 2] + jit[:, 1] - SLICE / 2, ruv[:, 1] * (img_h - SLICE))
    ox = torch.clamp(ox, 0, img_w - SLICE).to(torch.int32)
    oy = torch.clamp(oy, 0, img_h - SLICE).to(torch.int32)
    ar = torch.arange(SLICE, device=dev)
    raw = frames[fidx[:, None, None], (oy[:, None] + ar)[:, :, None],
                 (ox[:, None] + ar)[:, None, :]]                       # [B, SLICE, SLICE, 3]

    # --- scale jitter: a zoom-dependent window mapped onto CROP^2 --------
    zoom = draws["zoom"]
    max_uv = torch.clamp(SLICE - CROP / zoom, min=0.0)
    uv = draws["win"] * max_uv[:, None]
    inv_scale = 1.0 / zoom
    wy = scale_translate_weights(SLICE, CROP, inv_scale, -uv[:, 1] * zoom * inv_scale)
    wx = scale_translate_weights(SLICE, CROP, inv_scale, -uv[:, 0] * zoom * inv_scale)
    img = torch.bmm(wy.transpose(1, 2), raw.to(torch.float32).reshape(b, SLICE, SLICE * 3))
    img = img.reshape(b, CROP, SLICE, 3).transpose(2, 3).reshape(b, CROP * 3, SLICE)
    img = torch.bmm(img, wx).reshape(b, CROP, 3, CROP).transpose(2, 3)

    # --- colour jitter, truncated to uint8 -------------------------------
    gain = draws["contrast"][:, None, None, None]
    bias = draws["bright"][:, None, None, None]
    img = torch.clamp(img * gain + bias, 0, 255).to(torch.uint8)

    # --- this frame's gt in crop coordinates -----------------------------
    fb, fc = boxes[fidx], cls[fidx]                                  # [B, MAX_GT, 4], [B, MAX_GT]
    shift = torch.stack([ox, oy, ox, oy], dim=-1)[:, None, :].to(torch.float32)
    uv4 = torch.cat([uv, uv], dim=-1)[:, None, :]
    out_boxes = (fb - shift - uv4) * zoom[:, None, None]
    x1, y1, x2, y2 = out_boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    inside = (cx >= 0) & (cx < CROP) & (cy >= 0) & (cy < CROP)
    big_enough = ((x2 - x1) >= 6) & ((y2 - y1) >= 6)
    keep = inside & big_enough & (fc != 0)
    return img, out_boxes, torch.where(keep, fc, 0)


# ---------------------------------------------------------------------------
# Targets and loss
# ---------------------------------------------------------------------------


def _gaussian_radius(w: torch.Tensor, h: torch.Tensor, min_overlap: float = 0.7) -> torch.Tensor:
    """CenterNet radius rule (Zhou et al. 2019, eq. from CornerNet)."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 4 * 4.0 * c2, min=0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0))) / (2 * a3)
    return torch.clamp(torch.minimum(torch.minimum(r1, r2), r3), min=1.0)


def make_targets(boxes: torch.Tensor, cls: torch.Tensor, grid_h: int, grid_w: int,
                 stride: int) -> tuple[torch.Tensor, ...]:
    """CenterNet targets of a batch of crops.

    boxes [B, M, 4] crop pixels, cls [B, M] (0 pad, -1 ignore, 1..6 sign);
    ``stride`` is the model's head-grid stride.  -> (hm [B, H, W, C],
    wh [B, H, W, 2], off [B, H, W, 2], pos_mask [B, H, W], loss_mask
    [B, H, W, C]).  A valid box's Gaussian sits on its integer center cell
    (truncated toward zero, then clipped), where hm is exactly 1; boxes on
    one cell average their wh and off; ignore boxes zero the loss mask over
    their floor/ceil extent."""
    dev = boxes.device
    gy = torch.arange(grid_h, dtype=torch.float32, device=dev)[:, None]     # [H, 1]
    gx = torch.arange(grid_w, dtype=torch.float32, device=dev)[None, :]     # [1, W]

    def cells(v):                                                         # [B, M] -> [B, M, 1, 1]
        return v[..., None, None]

    w = (boxes[..., 2] - boxes[..., 0]) / stride                          # grid units
    h = (boxes[..., 3] - boxes[..., 1]) / stride
    cx = (boxes[..., 0] + boxes[..., 2]) / 2 / stride
    cy = (boxes[..., 1] + boxes[..., 3]) / 2 / stride
    valid = cls > 0
    icx = torch.clamp(cx.to(torch.int32), 0, grid_w - 1)
    icy = torch.clamp(cy.to(torch.int32), 0, grid_h - 1)

    sigma2 = torch.clamp((2 * _gaussian_radius(w, h) + 1) / 6, min=1e-3) ** 2
    d2 = (gx - cells(icx.to(torch.float32))) ** 2 + (gy - cells(icy.to(torch.float32))) ** 2
    g = torch.where(cells(valid), torch.exp(-d2 / (2 * cells(sigma2))), 0.0)      # [B, M, H, W]
    # one_hot's own range checks read the class ids back on the CPU
    onehot = (torch.clamp(cls - 1, 0, NUM_CLASSES - 1)[..., None]
              == torch.arange(NUM_CLASSES, device=dev)).to(torch.float32)
    onehot = onehot * valid[..., None]                                             # [B, M, C]
    hm = (g[..., None] * onehot[:, :, None, None, :]).amax(dim=1)

    cell = ((gy == cells(icy)) & (gx == cells(icx)) & cells(valid)).to(torch.float32)
    pos_mask = cell.amax(dim=1)
    denom = torch.clamp(cell.sum(dim=1), min=1.0)[..., None]
    vals = torch.stack([w, h, cx - icx, cy - icy], dim=-1) * valid[..., None]     # [B, M, 4]
    wh_off = (cell[..., None] * vals[:, :, None, None, :]).sum(dim=1) / denom
    wh, off = wh_off[..., :2], wh_off[..., 2:]

    ign = cells(cls == -1)
    x1, y1 = cells(torch.floor(boxes[..., 0] / stride)), cells(torch.floor(boxes[..., 1] / stride))
    x2, y2 = cells(torch.ceil(boxes[..., 2] / stride)), cells(torch.ceil(boxes[..., 3] / stride))
    covered = ((gx >= x1) & (gx <= x2) & (gy >= y1) & (gy <= y2) & ign).any(dim=1)
    loss_mask = torch.where(covered, 0.0, 1.0)[..., None].expand(*covered.shape, NUM_CLASSES)
    return hm, wh, off, pos_mask, loss_mask


def centernet_loss(outputs: dict[str, torch.Tensor], targets: tuple[torch.Tensor, ...],
                   cfg: TrainConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Penalty-reduced focal loss on ``hm`` (positives where the target is
    1), L1 on ``size`` and ``off`` at the positive cells; sums over the
    batch, normalised by the counts of positives.  -> (total, parts)."""
    hm_t, wh_t, off_t, pos_mask, loss_mask = targets
    logits = outputs["hm"]
    p = torch.sigmoid(logits)
    pos = (hm_t >= 0.9999).to(torch.float32)
    pos_loss = -((1 - p) ** 2) * F.logsigmoid(logits) * pos
    neg_loss = -((1 - hm_t) ** 4) * (p ** 2) * F.logsigmoid(-logits) * (1 - pos)
    hm_loss = torch.sum((pos_loss + neg_loss) * loss_mask) / torch.clamp(pos.sum(), min=1.0)

    pm = pos_mask[..., None]
    n_cells = torch.clamp(pos_mask.sum(), min=1.0)
    wh_loss = torch.sum(torch.abs(outputs["size"] - wh_t) * pm) / n_cells
    off_loss = torch.sum(torch.abs(outputs["off"] - off_t) * pm) / n_cells
    total = hm_loss + cfg.size_loss_weight * wh_loss + cfg.offset_loss_weight * off_loss
    return total, {"hm": hm_loss, "wh": wh_loss, "off": off_loss}


# ---------------------------------------------------------------------------
# v3 training twin: BatchNorm at train time, folded away at export
# ---------------------------------------------------------------------------


class BatchNorm(_FlaxLeaf):
    """flax ``nn.BatchNorm(dtype=float32)`` on NHWC input.  In training mode
    it normalises by the batch's f32 mean and biased variance
    ``max(E[x^2] - E[x]^2, 0)`` and moves the running statistics by
    ``ra = 0.99 * ra + 0.01 * batch``; in eval mode it uses them."""

    _flax_stats = ("mean", "var")

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self._flax_names = ("bias", "scale")

    def init_flax(self, gen):
        super().init_flax(gen)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return (xf - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias


class SignCenterNetV3Train(nn.Module):
    """BatchNorm twin of ``SignCenterNet(arch="v3")``: an 8x8 stride-8 stem
    conv and three 3x3 trunk convs (the first of stride 2), each without
    bias and followed by BatchNorm and relu, then the three head convs.
    Children carry the reference's names (``Conv_0..6``, ``BatchNorm_0..3``)
    so its ``params`` and ``batch_stats`` load one to one.
    :func:`fold_v3_batchnorm` folds the statistics into the inference net."""

    def __init__(self, cfg: CNNDetectorConfig | None = None):
        super().__init__()
        self.cfg = cfg = cfg or CNNDetectorConfig(arch="v3")
        dt = cfg.compute_dtype()
        for i, (cin, cout, k, stride) in enumerate([(3, 64, 8, 8), (64, 128, 3, 2),
                                                    (128, 128, 3, 1), (128, 128, 3, 1)]):
            setattr(self, f"Conv_{i}", Conv(cin, cout, k, stride, bias=False, dtype=dt))
            setattr(self, f"BatchNorm_{i}", BatchNorm(cout))
        self.Conv_4 = Conv(128, NUM_CLASSES, dtype=dt, bias_init=-4.59)
        self.Conv_5 = Conv(128, 2, dtype=dt)
        self.Conv_6 = Conv(128, 2, dtype=dt)

    def forward(self, frames_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        dt = self.cfg.compute_dtype()
        x = frames_u8.to(dt) * _const(1 / 255.0, frames_u8, dt) - _const(0.5, frames_u8, dt)
        for i in range(4):
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return {"hm": self.Conv_4(x).float(), "size": self.Conv_5(x).float(),
                "off": self.Conv_6(x).float()}


def fold_v3_batchnorm(twin: SignCenterNetV3Train) -> SignCenterNet:
    """Fold each BatchNorm's affine and running statistics into the conv
    before it: ``kernel' = kernel * g / sqrt(v + eps)`` per output channel,
    ``bias' = b - m * g / sqrt(v + eps)``; the heads pass through.  -> the
    inference ``SignCenterNet(arch="v3")`` on the twin's device (the stem's
    [8, 8, 3, 64] kernel loads into its patchify layout)."""
    flat = flat_params(twin)
    with torch.no_grad():
        for i in range(4):
            bn = getattr(twin, f"BatchNorm_{i}")
            scale = bn.scale / torch.sqrt(bn.var + BN_EPS)
            kernel = getattr(twin, f"Conv_{i}").weight.permute(2, 3, 1, 0) * scale
            flat[f"['Conv_{i}']['kernel']"] = kernel.cpu().numpy()
            flat[f"['Conv_{i}']['bias']"] = (bn.bias - bn.mean * scale).cpu().numpy()
    return load_flat_params(SignCenterNet(twin.cfg), flat).to(twin.Conv_4.weight.device)


# ---------------------------------------------------------------------------
# Optimizer, schedule and the train step
# ---------------------------------------------------------------------------


def learning_rate(count: int, cfg: TrainConfig) -> float:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup_steps, steps,
    0.02 * lr)`` at update ``count``, in f32 as optax evaluates it: linear
    from 0 over the warm-up (so count 0 gives 0), then a cosine decay to
    ``0.02 * lr`` at ``steps``."""
    f32 = np.float32
    peak, warmup = cfg.lr, cfg.warmup_steps
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float(f32(0.0 - peak) * frac + f32(peak))
    decay_steps = cfg.steps - warmup
    if decay_steps <= 0:
        raise ValueError(f"the cosine decay needs steps > warmup_steps, got {cfg}")
    alpha = 0.0 if peak == 0.0 else cfg.lr * 0.02 / peak
    c = f32(min(count - warmup, decay_steps))
    cosine = f32(0.5) * (f32(1) + f32(math.cos(f32(f32(math.pi) * c) / f32(decay_steps))))
    return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))


def lr_table(cfg: TrainConfig, device) -> torch.Tensor:
    """:func:`learning_rate` at every update count ``0..cfg.steps``, f32 on
    ``device``, made once: a step reads its rate there (:func:`lr_at`), so
    the host computes none.  A run no longer than its warm-up (which optax
    refuses) never leaves it: its table ends before the count where the
    decay would begin."""
    last = cfg.steps if cfg.steps > cfg.warmup_steps else min(cfg.steps, cfg.warmup_steps - 1)
    return torch.tensor([learning_rate(c, cfg) for c in range(last + 1)], dtype=torch.float32,
                        device=device)


def lr_at(table: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The rate of ``table`` (:func:`lr_table`) at update ``count`` (a 0-d
    int64 tensor on its device), its last past the end: a 0-d tensor, read
    on the device."""
    return torch.take(table, torch.clamp(count, max=table.numel() - 1))


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.AdamW:
    """optax ``adamw`` (betas 0.9/0.999, eps 1e-8, decoupled weight decay on
    every parameter); :class:`TrainStep` sets its learning rate before each
    update."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def capturable_optimizer(params, cfg: TrainConfig, lr: torch.Tensor) -> torch.optim.AdamW:
    """:func:`make_optimizer`'s AdamW with ``capturable=True``: its update
    counts, its bias corrections ``1 - b**t`` (in f32, as optax forms them)
    and its learning rate ``lr`` (a 0-d tensor that :func:`adamw_update`
    writes) stay on the card, so a CUDA graph holds the whole update.
    PyTorch refuses ``capturable`` on the CPU, which keeps
    :func:`make_optimizer`."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay, capturable=True)


def adamw_update(opt: torch.optim.AdamW, lr: torch.Tensor, table: torch.Tensor,
                 count: torch.Tensor) -> None:
    """One AdamW update of ``opt``'s parameters from their gradients at
    update ``count`` (a 0-d int64 tensor, advanced by one), its rate the
    table's at ``count`` written into ``lr``.  A :func:`make_optimizer`
    optimizer takes the rate as a number, which it reads back (on the CPU,
    where that does not wait); a :func:`capturable_optimizer` reads ``lr``
    on the card."""
    lr.copy_(lr_at(table, count))
    if not opt.defaults["capturable"]:
        for group in opt.param_groups:
            group["lr"] = lr.item()
    opt.step()
    count.add_(1)


def crop_targets(boxes: torch.Tensor, cls: torch.Tensor, stride: int) -> tuple[torch.Tensor, ...]:
    """:func:`make_targets` of a batch of crops on the CROP / stride grid."""
    return make_targets(boxes, cls, CROP // stride, CROP // stride, stride)


class TrainStep:
    """One training step a call: draws from ``(cfg.seed, step)``, crops,
    targets, the loss, its gradients and an AdamW update of ``model``'s
    parameters (and, for the twin, its running statistics).  The optimizer's
    own update count (:attr:`count`, a 0-d tensor on the device, from 0)
    sets the learning rate (:func:`lr_table`); it is independent of the
    ``step`` that seeds the draws.  ``timer``, when given, brackets the
    stages ``sample+resize``, ``targets``, ``forward+backward`` and
    ``optimizer`` (``timer(name)`` is a context).

    The step's body holds no host state: the count, the rate and the
    optimizer's state are device tensors, and the draws come from
    :attr:`gen`, seeded before each step with ``(cfg.seed, step)``'s state
    (on a card the graph registers it, so each replay draws from that seed).
    So on a card (:attr:`GRAPH_DEVICES`) the first call runs the body once
    eagerly on the card's capture stream (a real step, whose metrics it
    returns) and captures it into one CUDA graph with a memory pool of its
    own (``capture``, by default ``runtime/graphs.py: capture_call``); every
    later call with the same model, optimizer and data tensors (by identity;
    others make a new capture) seeds the generator, replays the graph and
    returns its static metrics, which the next replay rewrites.  The graph
    writes the gradients, which no parameter holds when it is captured, and
    moves the twin's running statistics once a replay.  A capture that fails
    raises ``GraphCaptureError``: there is no eager retry.  On the CPU, and
    with a ``timer`` (events between the stages cannot be read inside a
    graph), the body runs eagerly."""

    GRAPH_DEVICES = ("cuda",)

    def __init__(self, model: nn.Module, cfg: TrainConfig, timer=None, capture=None):
        self.model, self.cfg, self.timer = model.train(), cfg, timer
        params = list(model.parameters())
        for p in params:
            p.requires_grad_(True)
        self.device = params[0].device
        self.graphed = self.device.type in self.GRAPH_DEVICES
        self.count = torch.zeros((), dtype=torch.int64, device=self.device)
        self.lr_table = lr_table(cfg, self.device)
        self.lr = lr_at(self.lr_table, self.count)
        self.opt = (capturable_optimizer(params, cfg, self.lr) if self.graphed
                    else make_optimizer(params, cfg))
        self.gen = torch.Generator(device=self.device)
        self._capture = capture or graphs.capture_call
        self._held = None  # (model, optimizer and data tensors, graphs.Captured)

    def __call__(self, data: dict[str, torch.Tensor], step: int) -> dict[str, torch.Tensor]:
        self.gen.manual_seed(_seed_state((self.cfg.seed, step)))
        if self.timer is not None or not self.graphed:
            return self._body(data)
        key = (self.model, self.opt, *data.values())
        if self._held is not None and len(self._held[0]) == len(key) and all(
                a is b for a, b in zip(self._held[0], key)):
            return self._held[1].replay()
        first, entry = self._capture(self._body, self.device, (data,), "as a training step",
                                     generator=self.gen)
        self._held = (key, entry)
        return first

    @property
    def captured(self):
        """The step's ``graphs.Captured`` graph, or ``None`` before the first
        graphed step."""
        return None if self._held is None else self._held[1]

    def _body(self, data: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        with stage_scope(self.timer, "sample+resize"):
            draws = sample_draws(self.gen, self.cfg.batch_size, data["frames"].shape[0],
                                 data["pos"].shape[0], self.cfg)
            crops = crops_from_draws(draws, data, self.cfg)
        return self.update(*crops)

    def update(self, imgs: torch.Tensor, boxes: torch.Tensor,
               cls: torch.Tensor) -> dict[str, torch.Tensor]:
        """The step on a batch of crops: -> {"loss", "hm", "wh", "off"} as
        0-d tensors on the device (not synchronised).  The gradients stay
        on the parameters until the next update."""
        full_f32_matmuls()
        with stage_scope(self.timer, "targets"):
            targets = crop_targets(boxes, cls, self.model.cfg.stride)
        with stage_scope(self.timer, "forward+backward"):
            loss, parts = centernet_loss(self.model(imgs), targets, self.cfg)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        with stage_scope(self.timer, "optimizer"):
            adamw_update(self.opt, self.lr, self.lr_table, self.count)
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}


def upload_dataset(data: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """:func:`pack_dataset`'s arrays on ``device``, once."""
    if len(data["pos"]) == 0:
        raise ValueError("the training set has no mapped gt box to center crops on")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in data.items()}


def train(data: dict[str, np.ndarray], model_cfg: CNNDetectorConfig | None = None,
          cfg: TrainConfig | None = None, log_every: int = 200, log_fn=print,
          device="cuda", timer=None) -> tuple[SignCenterNet, dict[str, torch.Tensor]]:
    """A whole training run on ``device`` from :func:`pack_dataset`'s
    arrays, uploaded once.  ``arch="v3"`` trains the BatchNorm twin and
    returns the folded inference net, so callers are arch-agnostic.
    ``timer`` times the steps' stages, eagerly (:class:`TrainStep`; without
    it a card replays one CUDA graph a step).  -> (the inference
    ``SignCenterNet``, the last step's metrics)."""
    model_cfg = model_cfg or CNNDetectorConfig()
    cfg = cfg or TrainConfig()
    full_f32_matmuls()
    ddata = upload_dataset(data, device)
    v3 = model_cfg.arch == "v3"
    model = init_params(SignCenterNetV3Train(model_cfg) if v3 else SignCenterNet(model_cfg),
                        cfg.seed).to(device)
    step_fn = TrainStep(model, cfg, timer)
    metrics: dict[str, torch.Tensor] = {}
    for step in range(cfg.steps):
        metrics = step_fn(ddata, step)
        if log_every and (step % log_every == 0 or step == cfg.steps - 1):
            # one scalar read: also paces the host ahead of the card
            log_fn(f"step {step}: " + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()))
    # a replay's metrics are its graph's outputs, which the next replay rewrites
    metrics = {k: v.clone() for k, v in metrics.items()}
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return (fold_v3_batchnorm(model) if v3 else model), metrics
