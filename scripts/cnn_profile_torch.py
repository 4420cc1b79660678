#!/usr/bin/env python3
"""Decompose the CNN detector's cost on the PyTorch/CUDA port: per-stage
time, FLOPs and the rate achieved.

    python scripts/cnn_profile_torch.py [--batch 16] [--size 1080p|gtsdb] \
        [--segments] [--device cuda|cpu]

The twin of ``scripts/cnn_profile.py``: the same flags, FLOP model and
lines, plus ``--device`` (default ``cuda``; without a visible card it
exits 2).  Times (a) the full detect (forward + decode), (b) the forward
only, (c) the decode only, and with ``--segments`` (d) each prefix of the
backbone, built from the port's modules with weights drawn from a seeded
``torch.Generator``.  A time is the mean of ``iters`` calls between two
``torch.cuda.synchronize()``; the TFLOP/s line is the card's own.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, device, iters: int = 10) -> float:
    """Seconds a call of ``fn(*args)``: one warm-up, then the mean of
    ``iters`` calls ended by a synchronisation."""
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters


def conv_flops(cells, cin, cout, k=9):
    return cells * cin * cout * k * 2


def model_flops(cfg: cd.CNNDetectorConfig, h: int, w: int, b: int) -> int:
    """FLOPs of one batch of ``b`` frames of ``h`` x ``w`` through the
    network's convs (``scripts/cnn_profile.py``'s model of each arch)."""
    s4 = (h // 4) * (w // 4)
    s8 = (h // 8) * (w // 8)
    s16 = (h // 16) * (w // 16)
    f = cfg
    if f.arch == "v3":
        return (
            conv_flops(s8, 3, 64, k=64) +        # 8x8 patchify
            conv_flops(s16, 64, 128) +
            conv_flops(s16, 128, 128) * 2 +
            conv_flops(s16, 128, 6) +
            conv_flops(s16, 128, 2) * 2
        ) * b
    if f.arch == "slim":
        return (
            conv_flops(s8, 48, f.stem_features) +
            conv_flops(s8, f.stem_features, f.mid_features) +
            conv_flops(s16, f.mid_features, f.mid_features) +
            conv_flops(s16, f.mid_features, f.deep_features) +
            conv_flops(s16, f.deep_features, f.deep_features) +
            conv_flops(s16, f.deep_features, f.mid_features, k=1) +
            conv_flops(s8, f.mid_features, f.head_features) +
            conv_flops(s8, f.head_features, f.head_features) +
            conv_flops(s8, f.head_features, 6) +
            conv_flops(s8, f.head_features, 2) * 2
        ) * b
    return (
        conv_flops(s4, 48, f.stem_features) +
        conv_flops(s8, f.stem_features, f.stem_features) +
        conv_flops(s8, f.stem_features, f.mid_features) +
        conv_flops(s16, f.mid_features, f.mid_features) +
        conv_flops(s16, f.mid_features, f.deep_features) +
        conv_flops(s16, f.deep_features, f.deep_features) +
        conv_flops(s8, f.mid_features + f.deep_features, f.head_features) +
        conv_flops(s8, f.head_features, f.head_features) +
        conv_flops(s8, f.head_features, 6) +
        conv_flops(s8, f.head_features, 2) * 2
    ) * b


def arch_blocks(cfg: cd.CNNDetectorConfig) -> list[tuple[int, int, int]]:
    """(features, stride, kernel) of each trunk conv of ``cfg.arch``."""
    if cfg.arch == "v3":
        return [(64, 8, 8), (128, 2, 3), (128, 1, 3), (128, 1, 3)]
    if cfg.arch == "slim":
        return [(cfg.stem_features, 2, 3), (cfg.mid_features, 1, 3),
                (cfg.mid_features, 2, 3), (cfg.deep_features, 1, 3),
                (cfg.deep_features, 1, 3)]
    return [(cfg.stem_features, 1, 3), (cfg.stem_features, 2, 3),
            (cfg.mid_features, 1, 3), (cfg.mid_features, 2, 3),
            (cfg.deep_features, 1, 3), (cfg.deep_features, 1, 3)]


class Prefix(torch.nn.Module):
    """The first ``depth`` trunk convs of ``cfg.arch``, summed to a scalar:
    v3's patchify stem then relu'd convs, the other arches' space-to-depth
    input then conv blocks."""

    def __init__(self, cfg: cd.CNNDetectorConfig, depth: int):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype()
        blocks = arch_blocks(cfg)
        if cfg.arch == "v3":
            self.stem = cd.PatchifyStem(blocks[0][0], dt)
            cin, blocks = blocks[0][0], blocks[1:][: depth - 1]
            make = lambda i, o, s, k: cd.Conv(i, o, k, s, dtype=dt)  # noqa: E731
        else:
            self.stem = None
            cin, blocks = 48, blocks[:depth]
            make = lambda i, o, s, k: cd.ConvBlock(i, o, s, dt)  # noqa: E731
        layers = []
        for feat, stride, k in blocks:
            layers.append(make(cin, feat, stride, k))
            cin = feat
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, fr: torch.Tensor) -> torch.Tensor:
        if self.stem is not None:
            x = self.stem(fr)
            for conv in self.layers:
                x = torch.relu(conv(x))
        else:
            dt = self.cfg.compute_dtype()
            x = cd._space_to_depth(fr.to(dt) / 255.0 - 0.5, 4)
            for block in self.layers:
                x = block(x)
        return x.sum()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", default="1080p", choices=["1080p", "gtsdb"])
    ap.add_argument("--segments", action="store_true",
                    help="also time truncated-prefix networks")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card

    device = args.device
    why = missing_card(device)
    if why:
        print(why)
        return 2

    h, w = (1088, 1920) if args.size == "1080p" else (800, 1360)
    b = args.batch
    ckpt = cd.__file__.replace(
        os.path.join("opencv_traffic_sign_detector_tpu_torch", "models", "cnn_detector.py"),
        os.path.join("artifacts", "cnn_detector", "params.npz"))
    det = cd.CNNDetector.load(ckpt, device=device)  # arch/threshold from the npz tags
    cfg, model = det.cfg, det.net
    print(f"arch {cfg.arch} (stride {cfg.stride})")

    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), np.uint8)).to(device)

    def decode(o):
        return cd.decode_detections(o, cfg.max_detections, cfg.score_threshold, cfg.stride)

    with torch.inference_mode():
        cd.full_f32_matmuls()
        t_full = timeit(lambda f: decode(model(f)), frames, device=device)
        t_fwd = timeit(model, frames, device=device)
        out = model(frames)
        t_dec = timeit(decode, out, device=device)

        flops = model_flops(cfg, h, w, b)
        fps_full = b / t_full
        fps_fwd = b / t_fwd
        print(f"size={args.size} batch={b}")
        print(f"full (fwd+decode): {t_full*1e3:8.2f} ms  {fps_full:8.1f} fps")
        print(f"forward only:      {t_fwd*1e3:8.2f} ms  {fps_fwd:8.1f} fps")
        print(f"decode only:       {t_dec*1e3:8.2f} ms")
        print(f"model FLOPs/batch: {flops/1e9:.1f} GFLOP "
              f"-> {flops/t_fwd/1e12:.1f} TFLOP/s achieved")

        if not args.segments:
            return 0

        # segment timings: truncated networks attribute the time, block by
        # block, on the profiled arch
        dt = cfg.compute_dtype()

        def stem_only(fr):
            x = fr.to(dt) / 255.0 - 0.5
            if cfg.arch != "v3":
                x = cd._space_to_depth(x, 4)
            return x

        print(f"input prep:         {timeit(stem_only, frames, device=device)*1e3:.2f} ms")

        gen = torch.Generator().manual_seed(0)
        prev = 0.0
        for d in range(1, len(arch_blocks(cfg)) + 1):
            m = Prefix(cfg, d)
            for layer in m.modules():
                if isinstance(layer, cd._FlaxLeaf):
                    layer.init_flax(gen)
            m = m.to(device)
            t = timeit(m, frames, device=device, iters=5)
            print(f"prefix depth {d}: {t*1e3:8.2f} ms (+{(t-prev)*1e3:6.2f})")
            prev = t
    return 0


if __name__ == "__main__":
    sys.exit(main())
