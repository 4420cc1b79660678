#!/usr/bin/env python3
"""Time forward-pass variants of the CNN detector to attribute cost.

    python scripts/cnn_variants_torch.py --batch 16 --variant <name> [--device cuda|cpu]
    python scripts/cnn_variants_torch.py --variant product --arch v3

The twin of ``scripts/cnn_variants.py``: the same flags, variants and lines,
plus ``--device`` (default ``cuda``; without a visible card it exits 2) and a
first line with the card's name and power limit.  The variants (fresh-init
parameters; timing only, not quality):

  base        the ``base`` arch's net: concat-FPN, f32 heads
  nonorm      GroupNorm removed (a conv with a bias, then relu)
  addfpn      concat-FPN replaced by a 1x1-projected add
  bf16heads   the hm/size/off convs in bf16 (f32 cast at the end)
  slim        addfpn + bf16heads + stride-2 stem (no s4-resident conv)
  all         nonorm + slim
  v2wide      s8@128 + s16@256, one s8 conv each side of the FPN add
  v2s16       everything at s16@192, heads on the s16 grid
  v2s16wide   everything at s16@256, heads on the s16 grid

Each is an ``nn.Module`` on NHWC tensors built from the port's flax-layout
layers (``models/cnn_detector.py``: ``Conv``, ``GroupNorm``), with flax's
automatic names (``Block_i`` holding ``Conv_0`` and ``GroupNorm_0``, then the
bare ``Conv_i``), so :func:`params_from_flax` loads the original module's
initialised parameters.  For timing a variant draws fresh ones from a seeded
generator (flax's lecun normal).  The forward is replayed from one
``runtime/graphs.py: CapturedFn`` graph a card, frame shape and variant, as
the original jits it: the warm-up call is the capture, and each later call
copies the frames (already on the card) into the graph's input and replays.
``--variant product`` times ``CNNDetector.dispatch`` of a fresh ``--arch``
(forward and decode, one graph a route).  A time is one warm-up call, then
the mean of ``--iters`` calls ended by one synchronisation.  The CPU runs
everything eagerly.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd  # noqa: E402

BF16 = torch.bfloat16


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, iters=10):
    """Seconds a call: one warm-up (on a card, the capture), then the mean of
    ``iters`` calls ended by one synchronisation."""
    fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


class Block(nn.Module):
    """The original's ``Block``: a bf16 3x3 conv, with a bias only where
    there is no norm (``use_bias=not norm``), then GroupNorm (8 groups, f32
    out) and relu."""

    def __init__(self, cin: int, cout: int, stride: int = 1, norm: bool = True):
        super().__init__()
        self.Conv_0 = cd.Conv(cin, cout, stride=stride, bias=not norm, dtype=BF16)
        if norm:
            self.GroupNorm_0 = cd.GroupNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if hasattr(self, "GroupNorm_0"):
            x = self.GroupNorm_0(x)
        return torch.relu(x)


class _Net(nn.Module):
    """Blocks ``Block_0..`` of (cin, cout, stride), a 1x1 projection
    ``Conv_0`` (cin, cout) or none, and the three heads after it."""

    def __init__(self, blocks, proj, head_in: int, head_dtype=BF16, norm: bool = True):
        super().__init__()
        for i, (cin, cout, stride) in enumerate(blocks):
            setattr(self, f"Block_{i}", Block(cin, cout, stride, norm))
        if proj is not None:
            self.Conv_0 = cd.Conv(*proj, k=1, dtype=BF16)
        self._first_head = int(proj is not None)
        for j, cout in enumerate((cd.NUM_CLASSES, 2, 2)):
            setattr(self, f"Conv_{self._first_head + j}", cd.Conv(head_in, cout, dtype=head_dtype))

    def blocks(self) -> list[Block]:
        return [m for name, m in self.named_children() if name.startswith("Block_")]

    @staticmethod
    def stem(frames_u8: torch.Tensor) -> torch.Tensor:
        """u8 [B, H, W, 3] -> bf16 [B, H/4, W/4, 48]: ``x * 1/255 - 0.5`` with
        bf16 constants, space to depth by 4."""
        x = frames_u8.to(BF16) * cd._const(1 / 255.0, frames_u8, BF16) \
            - cd._const(0.5, frames_u8, BF16)
        return cd._space_to_depth(x, 4)

    def heads(self, feat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Each head in its dtype (the conv casts ``feat``), f32 out."""
        return {name: getattr(self, f"Conv_{self._first_head + j}")(feat).float()
                for j, name in enumerate(("hm", "size", "off"))}


class Variant(_Net):
    """The original's ``Variant`` at ``CNNDetectorConfig()``'s widths."""

    def __init__(self, norm: bool = True, addfpn: bool = False, bf16heads: bool = False,
                 slim_stem: bool = False):
        cfg = cd.CNNDetectorConfig()
        s, mid, deep, head = (cfg.stem_features, cfg.mid_features, cfg.deep_features,
                              cfg.head_features)
        stem = [(48, s, 2)] if slim_stem else [(48, s, 1), (s, s, 2)]
        blocks = stem + [(s, mid, 1), (mid, mid, 2), (mid, deep, 1), (deep, deep, 1),
                         (mid if addfpn else mid + deep, head, 1), (head, head, 1)]
        super().__init__(blocks, (deep, mid) if addfpn else None, head,
                         BF16 if bf16heads else torch.float32, norm)
        self.addfpn = addfpn

    def forward(self, frames_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        *stem, b8, b16a, b16b, b16c, h1, h2 = self.blocks()
        x = self.stem(frames_u8)
        for b in stem:
            x = b(x)
        s8 = b8(x)
        x = b16c(b16b(b16a(s8)))
        if self.addfpn:
            fused = s8 + cd._upsample2(self.Conv_0(x))
        else:
            fused = torch.cat([s8, cd._upsample2(x)], dim=-1)
        return self.heads(h2(h1(fused)))


class V2Wide(_Net):
    """Slim stem to s8@128, bulk compute at s16@256, add-FPN, bf16 heads."""

    def __init__(self):
        super().__init__([(48, 128, 2), (128, 256, 2), (256, 256, 1), (256, 256, 1),
                          (128, 128, 1)], (256, 128), 128)

    def forward(self, frames_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        b0, b1, b2, b3, b4 = self.blocks()
        s8 = b0(self.stem(frames_u8))                      # 48 -> 128 @ s8
        x = b3(b2(b1(s8)))                                 # 128 -> 256 @ s16
        return self.heads(b4(s8 + cd._upsample2(self.Conv_0(x))))  # one s8 head conv


class V2S16(_Net):
    """All compute at stride 16; heads on the s16 grid (decode stride 16)."""

    def __init__(self, width: int = 192):
        w = width
        super().__init__([(48, w // 2, 2), (w // 2, w, 2), (w, w, 1), (w, w, 1), (w, w, 1)],
                         None, w)

    def forward(self, frames_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.stem(frames_u8)
        for b in self.blocks():
            x = b(x)
        return self.heads(x)


VARIANTS = {
    "base": dict(),
    "nonorm": dict(norm=False),
    "addfpn": dict(addfpn=True),
    "bf16heads": dict(bf16heads=True),
    "slim": dict(addfpn=True, bf16heads=True, slim_stem=True),
    "all": dict(norm=False, addfpn=True, bf16heads=True, slim_stem=True),
    "v2wide": V2Wide,
    "v2s16": V2S16,
    "v2s16wide": partial(V2S16, width=256),
}


def make_variant(name: str) -> nn.Module:
    """The variant's module, its parameters zero until loaded or drawn."""
    spec = VARIANTS[name]
    return Variant(**spec) if isinstance(spec, dict) else spec()


def params_from_flax(variant: nn.Module, flat) -> nn.Module:
    """Load the original module's ``params`` collection, flattened to
    ``jax.tree_util.keystr`` keys (``['Block_0']['Conv_0']['kernel']``) with
    numpy arrays, into ``variant``; every key and shape is checked.
    Returns ``variant``."""
    return cd.load_flat_params(variant, flat, "flax init")


def param_count(model: nn.Module) -> int:
    """Elements of the model's flax ``params`` collection."""
    return sum(int(np.prod(layer.flax_shapes()[name]))
               for _, layer, name in cd.flax_entries(model))


def forward(model: nn.Module, frames_u8: torch.Tensor, *tensors) -> dict[str, torch.Tensor]:
    """The function a variant's graph captures, keyed by the model;
    ``tensors`` are its parameters, read through the model and the graph by
    address."""
    return model(frames_u8)


def _frames(batch: int, size: str, device) -> torch.Tensor:
    """The original's ``default_rng(0)`` frames, u8 [B, H, W, 3], on ``device``."""
    h, w = (1088, 1920) if size == "1080p" else (800, 1360)
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, (batch, h, w, 3), np.uint8)).to(device)


def product_timing(arch: str, batch: int, size: str, iters: int, device="cuda") -> None:
    """Time the PRODUCT inference path (forward + decode, one graph a route)
    with fresh-init params."""
    frames = _frames(batch, size, device)
    cfg = cd.CNNDetectorConfig(arch=arch)
    det = cd.CNNDetector(cd.init_params(cd.SignCenterNet(cfg)).to(device), cfg)
    out = det.dispatch(frames)
    out[2][0, 0].item()
    t0 = time.perf_counter()
    outs = [det.dispatch(frames) for _ in range(iters)]
    outs[-1][2][0, 0].item()
    dt = time.perf_counter() - t0
    n_params = param_count(det.net)
    print(f"{arch:10s} product batch={batch} {size} "
          f"{dt / iters * 1e3:8.2f} ms/batch "
          f"{iters * batch / dt:8.1f} fps  ({n_params/1e3:.0f}k params)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", default="1080p", choices=["1080p", "gtsdb"])
    ap.add_argument("--variant", default="base",
                    choices=sorted(VARIANTS) + ["product"])
    ap.add_argument("--arch", default="slim",
                    help="product mode: CNNDetectorConfig arch to time")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.models.detector import full_f32_matmuls
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import card_line, missing_card
    from opencv_traffic_sign_detector_tpu_torch.runtime.graphs import CapturedFn

    why = missing_card(args.device)
    if why:
        print(why)
        return 2
    device = torch.device(args.device)
    print(card_line(device))
    full_f32_matmuls()  # f32 heads in f32, not TF32

    if args.variant == "product":
        product_timing(args.arch, args.batch, args.size, args.iters, device)
        return 0

    frames = _frames(args.batch, args.size, device)
    m = cd.init_params(make_variant(args.variant)).to(device)
    graph = CapturedFn(forward, keyed=True)
    with torch.inference_mode():
        t = timeit(lambda fr: graph(device, fr, *m.parameters(), key=m), frames,
                   iters=args.iters)
    print(f"{args.variant:10s} batch={args.batch} {t*1e3:8.2f} ms "
          f"{args.batch/t:8.1f} fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
