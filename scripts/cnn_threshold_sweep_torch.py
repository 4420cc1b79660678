#!/usr/bin/env python3
"""Operating-point sweep for a trained CNN detector checkpoint, on the
PyTorch/CUDA port.

    python scripts/cnn_threshold_sweep_torch.py --params /tmp/cnn_slim/params.npz \
        --arch slim [--thresholds 0.2,0.3,0.35,0.45,0.5,0.6] [--device cuda|cpu]

The twin of ``scripts/cnn_threshold_sweep.py``: the same flags, defaults
and lines, plus ``--device`` (default ``cuda``; without a visible card it
exits 2).  ONE inference pass at threshold 0.1 over the test set, then the
detection list is re-filtered at each threshold and scored with the parity
stats engine and PASCAL AP.  ``--input_scale 1080p`` scales the frames to
1920x1088 on the device first (``ops/upscale.py: resize_bilinear_u8``, the
reference's ``jax.image.resize``) and maps the boxes back to native
coordinates before scoring; ``--upscale s`` scores the product's upscaled
path instead, whose boxes come back native.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DET_DATA = "/root/reference/Deteción de Objetos"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="artifacts/cnn_detector/params.npz")
    ap.add_argument("--arch", default=None,
                    help="override the arch tag stored in the npz")
    ap.add_argument("--test_path", default=os.path.join(DET_DATA, "test_alumnos_jpg"))
    ap.add_argument("--thresholds", default="0.2,0.3,0.35,0.4,0.45,0.5,0.6")
    ap.add_argument("--eval_batch", type=int, default=8)
    ap.add_argument("--input_scale", default="native", choices=["native", "1080p"])
    ap.add_argument("--upscale", type=float, default=1.0,
                    help="score the PRODUCT upscaled-inference path "
                    "(CNNDetector upscale=s): on-device bilinear scale, "
                    "boxes already native — unlike --input_scale 1080p's "
                    "manual protocol")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from opencv_traffic_sign_detector_tpu_torch.eval.ap import score_detection_files
    from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_quant import (
        load_detector,
        saved_quant,
    )
    from opencv_traffic_sign_detector_tpu_torch.models.detector import upload
    from opencv_traffic_sign_detector_tpu_torch.ops.upscale import resize_bilinear_u8
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    why = missing_card(args.device)
    if why:
        print(why)
        return 2

    arch = args.arch or cd.saved_meta(args.params).get("arch") or "base"
    cfg = cd.CNNDetectorConfig(score_threshold=0.1, arch=arch)
    # float or int8, by __quant__ tag; --upscale rides the product path
    det = load_detector(args.params, cfg, upscale=args.upscale, device=args.device)
    print(f"arch {arch} (quant {saved_quant(args.params)}), "
          f"input_scale {args.input_scale}, upscale {args.upscale:g}")

    hd = args.input_scale == "1080p"
    files = list_frame_files(args.test_path)
    dets = []
    t0 = time.time()
    for i in range(0, len(files), args.eval_batch):
        chunk = files[i:i + args.eval_batch]
        frames = np.stack([load_image_bgr(os.path.join(args.test_path, f)) for f in chunk])
        if hd:
            sy = 1088.0 / frames.shape[1]
            sx = 1920.0 / frames.shape[2]
            native_hw = frames.shape[1:3]
            up = resize_bilinear_u8(upload(frames, det.device), 1088, 1920)
            for d in det.detect_frames(up, chunk, orig_hw=(1088, 1920)):
                dets.append(dataclasses.replace(
                    d,
                    x1=int(np.clip(round(d.x1 / sx), 0, native_hw[1] - 1)),
                    x2=int(np.clip(round(d.x2 / sx), 0, native_hw[1] - 1)),
                    y1=int(np.clip(round(d.y1 / sy), 0, native_hw[0] - 1)),
                    y2=int(np.clip(round(d.y2 / sy), 0, native_hw[0] - 1))))
        else:
            dets.extend(det.detect_frames(frames, chunk, orig_hw=frames.shape[1:3]))
    print(f"{len(dets)} detections at thr 0.1 over {len(files)} frames "
          f"({time.time() - t0:.1f}s)")

    gt_path = os.path.join(args.test_path, "gt.txt")
    print(f"{'thr':>5} {'n':>4} {'P':>5} {'R':>5} {'F1':>5} {'AP':>7}")
    for thr in [float(x) for x in args.thresholds.split(",")]:
        kept = [d for d in dets if d.score >= thr]
        t = compute_detection_statistics(kept, gt_path).total
        with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
            path = f.name
        write_results_file(path, kept)
        ap_res = score_detection_files(path, gt_path)
        os.unlink(path)

        def _f(v):
            return f"{v:5.2f}" if isinstance(v, float) else f"{v:>5}"

        print(f"{thr:5.2f} {len(kept):4d} {_f(t.precision)} {_f(t.recall)} "
              f"{_f(t.f1)} {ap_res['ap']:7.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
