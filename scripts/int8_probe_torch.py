#!/usr/bin/env python3
"""Probe: int8 against bf16 for the v3 trunk's hot conv and a big matmul on
the card.

    python scripts/int8_probe_torch.py [--device cuda|cpu]

The twin of ``scripts/int8_probe.py``, which runs at import; here the same
steps run in :func:`main`.  The same shapes (the v3 trunk's conv at batch
128 on the 1080p s16 grid, 68x120, 3x3 128->128; a 4096^3 matmul), the same
``np.random.default_rng(0)`` draws in the same order, and the same lines,
with a ``FAILED:`` line where a form raises.  The first line names the card
and its power limit where the original prints its devices.  The forms:

* ``conv bf16``: bf16 ``F.conv2d`` (cuDNN), channels-last;
* ``conv int8``: the port's serving conv, ``models/cnn_quant.py:
  conv_int8`` (an int8 im2col times the kernel, ``torch._int_mm`` on the
  card), int32 out;
* ``conv int8+requant``: that, then ``max(y, 0)``, ``round(y * 0.02)``
  and ``clip(0, 127)`` to int8;
* ``matmul bf16``: ``torch.matmul`` (cuBLAS); ``matmul int8``:
  ``cnn_quant.int8_matmul``.

A time is one warm-up call, then the mean of 20 calls ended by one
synchronisation.  Without a visible card ``--device cuda`` (the default)
exits 2.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from opencv_traffic_sign_detector_tpu_torch.models import cnn_quant  # noqa: E402

B, H, W, C = 128, 68, 120, 128
N = 4096
SCALE = 0.02


def draws(device, b: int = B, h: int = H, w: int = W, c: int = C, n: int = N) -> dict:
    """The original's operands, drawn from ``default_rng(0)`` in its order:
    bf16 and int8 NHWC activations and HWIO kernels, then the matmuls'
    bf16 and int8 ``[n, n]`` operands."""
    rng = np.random.default_rng(0)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(torch.bfloat16).to(device)

    def int8(shape):
        return torch.from_numpy(rng.integers(-127, 127, shape).astype(np.int8)).to(device)

    out = {"x_f": bf16((b, h, w, c)), "k_f": bf16((3, 3, c, c)),
           "x_i": int8((b, h, w, c)), "k_i": int8((3, 3, c, c))}
    out.update(a_f=bf16((n, n)), b_f=bf16((n, n)), a_i=int8((n, n)), b_i=int8((n, n)))
    return out


def conv_bf16(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """"SAME" 3x3 conv of bf16 NHWC ``x`` with the HWIO kernel ``k`` -> bf16
    NHWC, through channels-last NCHW views."""
    cl = torch.channels_last
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous(memory_format=cl),
                 padding=1)
    return y.permute(0, 2, 3, 1)


conv_int8 = cnn_quant.conv_int8
mm_bf16 = torch.matmul
mm_int8 = cnn_quant.int8_matmul


def conv_int8_requant(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    y = torch.clamp(conv_int8(x, k), min=0)
    return torch.clamp(torch.round(y.to(torch.float32) * SCALE), 0, 127).to(torch.int8)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(f, *args, device, iters: int = 20) -> float:
    f(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        f(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.runtime.build import card_line, missing_card

    why = missing_card(args.device)
    if why:
        print(why)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda":
        print(card_line(device))
    else:
        print([str(device)])
    d = draws(device)
    flop = 2 * B * H * W * C * C * 9
    mm_flop = 2 * N ** 3

    with torch.inference_mode():
        # ---- conv 3x3 128->128 ----
        t = timeit(conv_bf16, d["x_f"], d["k_f"], device=device)
        print(f"conv bf16: {t*1e3:.3f} ms  {flop/t/1e12:.1f} TFLOP/s")
        try:
            t = timeit(conv_int8, d["x_i"], d["k_i"], device=device)
            print(f"conv int8: {t*1e3:.3f} ms  {flop/t/1e12:.1f} TOP/s")
        except Exception as e:
            print("conv int8 FAILED:", repr(e)[:300])

        # ---- big matmul ratio ----
        t = timeit(mm_bf16, d["a_f"], d["b_f"], device=device)
        print(f"matmul bf16: {t*1e3:.3f} ms  {mm_flop/t/1e12:.1f} TFLOP/s")
        try:
            t = timeit(mm_int8, d["a_i"], d["b_i"], device=device)
            print(f"matmul int8: {t*1e3:.3f} ms  {mm_flop/t/1e12:.1f} TOP/s")
        except Exception as e:
            print("matmul int8 FAILED:", repr(e)[:300])

        # ---- int8 conv with requant epilogue (the realistic serving op) ----
        try:
            t = timeit(conv_int8_requant, d["x_i"], d["k_i"], device=device)
            print(f"conv int8+requant: {t*1e3:.3f} ms  {flop/t/1e12:.1f} TOP/s")
        except Exception as e:
            print("conv int8 requant FAILED:", repr(e)[:300])
    return 0


if __name__ == "__main__":
    sys.exit(main())
