#!/usr/bin/env python3
"""Train the CNN sign detector on a GTSDB-style directory and score it on
the test set, on the PyTorch/CUDA port.

    python scripts/train_cnn_torch.py --steps 4000 \
        [--out artifacts/cnn_detector/params.npz] [--device cuda|cpu] [--cpu] \
        [--skip_eval] [--eval_only]

The twin of ``scripts/train_cnn.py``: the same flags, defaults and prints,
plus ``--device`` (default ``cuda``; without a visible card it exits 2,
never falling back to the CPU; ``--cpu`` is ``--device cpu``).  The
training set is uploaded to the device once and the loop stays there
(``models/cnn_train.py``).  The weights are saved with their ``__arch__``
and ``__threshold__`` tags; then the detector runs over the test frames
at full frame, writes a resultado.txt and scores it with the parity stats
and PASCAL AP.  ``--train_path`` and ``--test_path`` default to the GTSDB
folders ``train_jpg`` and ``test_alumnos_jpg`` in the working directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DET_DATA = "/root/reference/Deteción de Objetos"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_path", default=os.path.join(DET_DATA, "train_jpg"))
    parser.add_argument("--test_path", default=os.path.join(DET_DATA, "test_alumnos_jpg"))
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--min_zoom", type=float, default=0.75)
    parser.add_argument("--max_zoom", type=float, default=1.4,
                        help="upper scale-jitter bound; raise to ~1.75 so "
                        "the upscaled-inference operating points "
                        "(--upscale 1.41-1.6, ops/fused_upscale.py) stay "
                        "inside the training scale distribution")
    parser.add_argument("--threshold", type=float, default=0.35)
    parser.add_argument("--arch", default="v3",
                        choices=["base", "slim", "v2wide", "v2s16", "v2s16wide", "v3"])
    parser.add_argument("--out", default="artifacts/cnn_detector/params.npz")
    parser.add_argument("--resultado",
                        default=os.path.join(tempfile.gettempdir(), "cnn_resultado.txt"))
    parser.add_argument("--eval_batch", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda exits 2 when no card is visible")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--skip_eval", action="store_true")
    parser.add_argument("--eval_only", action="store_true",
                        help="load --out and score it, no training")
    args = parser.parse_args(argv)

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_train as ct
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card

    device = "cpu" if args.cpu else args.device
    why = missing_card(device)
    if why:
        print(why)
        return 2
    model_cfg = cd.CNNDetectorConfig(score_threshold=args.threshold, arch=args.arch)

    if not args.eval_only:
        t0 = time.time()
        data = ct.build_dataset(args.train_path)
        print(f"dataset: {data['frames'].shape} frames, "
              f"{int((data['cls'] > 0).sum())} sign boxes, "
              f"{int((data['cls'] < 0).sum())} ignore boxes "
              f"({time.time() - t0:.1f}s)", flush=True)

        cfg = ct.TrainConfig(batch_size=args.batch, steps=args.steps, lr=args.lr,
                             seed=args.seed, min_zoom=args.min_zoom, max_zoom=args.max_zoom)
        t0 = time.time()
        net, _ = ct.train(data, model_cfg, cfg, device=device)
        print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")
        det = cd.CNNDetector(net, model_cfg)
        det.save(args.out)
        print(f"saved {args.out}")
    else:
        det = cd.CNNDetector.load(args.out, model_cfg, device=device)

    if args.skip_eval:
        return 0

    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from opencv_traffic_sign_detector_tpu_torch.eval.ap import score_detection_files
    from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    files = list_frame_files(args.test_path)
    dets = []
    t0 = time.time()
    for i in range(0, len(files), args.eval_batch):
        chunk = files[i:i + args.eval_batch]
        frames = np.stack([load_image_bgr(os.path.join(args.test_path, f)) for f in chunk])
        dets.extend(det.detect_frames(frames, chunk, orig_hw=frames.shape[1:3]))
    print(f"{len(dets)} detections over {len(files)} frames "
          f"in {time.time() - t0:.1f}s")
    write_results_file(args.resultado, dets)

    gt_path = os.path.join(args.test_path, "gt.txt")
    t = compute_detection_statistics(dets, gt_path).total
    print(f"totals: correct {t.correct} incorrect {t.incorrect} missed "
          f"{t.non_detected} | P {t.precision} R {t.recall} F1 {t.f1}")
    ap = score_detection_files(args.resultado, gt_path)
    print(f"PASCAL AP@0.5: {ap['ap']:.4f} (11pt {ap['ap_11pt']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
