#!/usr/bin/env python3
"""Convert a float v3 checkpoint to the int8 serving artifact, on the
PyTorch/CUDA port.

    python scripts/quantize_cnn_torch.py \
        [--params artifacts/cnn_detector/params.npz] \
        [--out artifacts/cnn_detector/params_int8.npz] \
        [--calib_dir train_jpg] [--calib_frames 32] [--percentile 100] \
        [--float_heads] [--device cuda|cpu]

The twin of ``scripts/quantize_cnn.py``: the same flags and prints, plus
``--device`` (default ``cuda``; without a visible card it exits 2).
Calibration frames default to the GTSDB training folder ``train_jpg`` in
the working directory; per-tensor activation scales only need a handful.
The npz carries ``__quant__='int8'`` and the first 12 hex digits of the
source checkpoint's sha256; every loader (``models/cnn_quant.py:
load_detector``) reads the tag.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_DEF_TRAIN = "/root/reference/Deteción de Objetos/train_jpg"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params", default="artifacts/cnn_detector/params.npz")
    ap.add_argument("--out", default="artifacts/cnn_detector/params_int8.npz")
    ap.add_argument("--calib_dir", default=_DEF_TRAIN)
    ap.add_argument("--calib_frames", type=int, default=32)
    # 100 = max calibration: a lower percentile clips the activation tail
    # that the detector's center peaks ride on
    ap.add_argument("--percentile", type=float, default=100.0)
    ap.add_argument("--float_heads", action="store_true",
                    help="keep head convs in bf16 (trunk output stays int8; "
                         "removes head weight-quant error)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the float calibration pass; cuda "
                         "exits 2 when no card is visible")
    args = ap.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_frames_batch,
    )
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import (
        CNNDetectorConfig,
        SignCenterNet,
        load_params,
        saved_meta,
    )
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_quant import (
        quantize_v3,
        save_quant_params,
    )
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card

    why = missing_card(args.device)
    if why:
        print(why)
        return 2
    cfg = CNNDetectorConfig(**saved_meta(args.params))
    if cfg.arch != "v3":
        raise SystemExit(f"int8 path implements arch v3, checkpoint is {cfg.arch!r}")
    net = load_params(args.params, SignCenterNet(cfg)).to(args.device)
    with open(args.params, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()[:12]

    files = list_frame_files(args.calib_dir)[: args.calib_frames]
    if not files:
        raise SystemExit(f"no calibration frames in {args.calib_dir}")
    frames = load_frames_batch(args.calib_dir, files)
    # crop to a stride multiple (native GTSDB 1360x800 already is)
    h = frames.shape[1] // 16 * 16
    w = frames.shape[2] // 16 * 16
    frames = frames[:, :h, :w]
    print(f"calibrating on {len(files)} frames {frames.shape[1:]} "
          f"(percentile {args.percentile})")

    q = quantize_v3(net, frames, percentile=args.percentile, float_heads=args.float_heads)
    save_quant_params(args.out, q, arch=cfg.arch, score_threshold=cfg.score_threshold,
                      source_sha256=sha)
    size = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size:.2f} MB, source sha {sha})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
