#!/usr/bin/env python3
"""Measure the card's bf16 matmul and conv rate at the CNN detector's shapes.

    python scripts/mxu_peak_torch.py [--iters 10] [--device cuda|cpu]

The twin of ``scripts/mxu_peak.py``: the same flags, shapes and lines, plus
``--device`` (default ``cuda``; without a visible card it exits 2).  It is
the speed-of-light reference that ``scripts/cnn_profile_torch.py``'s
"TFLOP/s achieved" line is read against: square bf16 ``torch.matmul``
(cuBLAS) at 4096 and 8192, then the detector's 3x3 convs at 1080p batch 16
as bf16 ``F.conv2d`` (cuDNN), channels-last, padding 1.  These are library
calls by design: the probe measures what cuBLAS and cuDNN reach at these
shapes.  Inputs come from a seeded ``torch.Generator`` on the device.  A
time is one warm-up call, then the mean of ``--iters`` calls ended by one
synchronisation.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MATMULS = (4096, 8192)

# the detector's conv geometry at 1080p, batch 16: (name, NHWC input, cout)
CONVS = [
    ("stem s4 48->64", (16, 272, 480, 48), 64),
    ("head s8 224->96", (16, 136, 240, 224), 96),
    ("head s8 96->96", (16, 136, 240, 96), 96),
    ("deep s16 128->128", (16, 68, 120, 128), 128),
    ("wide s8 256->256", (16, 136, 240, 256), 256),
]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, device, iters: int = 10) -> float:
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card

    why = missing_card(args.device)
    if why:
        print(why)
        return 2
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)

    with torch.inference_mode():
        # Square bf16 matmuls: the tensor cores' best case.
        for n in MATMULS:
            a = torch.randn((n, n), generator=gen, device=device, dtype=torch.bfloat16)
            b = torch.randn((n, n), generator=gen, device=device, dtype=torch.bfloat16)
            t = timeit(torch.matmul, a, b, device=device, iters=args.iters)
            tf = 2 * n**3 / t / 1e12
            print(f"matmul {n}x{n}x{n} bf16: {t*1e3:7.2f} ms  {tf:6.1f} TFLOP/s")
            del a, b

        # Conv shapes matching the detector's actual geometry (1080p batch 16).
        for name, shape, cout in CONVS:
            # NCHW tensors for F.conv2d, laid out channels-last (NHWC in memory)
            b, h, w, cin = shape
            x, k = (torch.randn(s, generator=gen, device=device, dtype=torch.bfloat16)
                    .contiguous(memory_format=torch.channels_last)
                    for s in ((b, cin, h, w), (cout, cin, 3, 3)))
            t = timeit(lambda x, k: F.conv2d(x, k, padding=1), x, k, device=device,
                       iters=args.iters)
            cells = shape[0] * shape[1] * shape[2]
            fl = cells * shape[-1] * cout * 9 * 2
            print(f"conv {name:20s}: {t*1e3:7.2f} ms  {fl/t/1e12:6.1f} TFLOP/s")
            del x, k
    return 0


if __name__ == "__main__":
    sys.exit(main())
