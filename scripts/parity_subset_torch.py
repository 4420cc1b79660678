#!/usr/bin/env python3
"""Detection parity check on a frame subset vs the reference's resultado,
on the PyTorch/CUDA port.

    python scripts/parity_subset_torch.py --frames 24 [--cpu] [--device cuda|cpu]

The twin of ``scripts/parity_subset.py``: runs the port's práctica-1
pipeline over the first N test frames, then scores both its detections and
the reference's (``tests/fixtures/ref_resultado_MSER_7_200_2000_1.txt``,
read from the working directory) against gt.txt restricted to those
frames, and prints P/R/F1 and AP for each.  The same flags and defaults
(``--downscale 1 --max_regions 768``: the XLA level sweep), plus
``--device`` (default ``cuda``; without a visible card it exits 2;
``--cpu`` is ``--device cpu``).  The templates are cached as
``mean_masks.npz`` and ``--out`` written in the temp directory (``/tmp``
unless ``TMPDIR`` names another).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--max_regions", type=int, default=768)
    parser.add_argument("--downscale", type=int, default=1)
    parser.add_argument("--level_step", type=int, default=0)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "parity_resultado.txt"))
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda exits 2 when no card is visible")
    args = parser.parse_args(argv)

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.data.gt import (
        load_ground_truth,
        load_results_file,
    )
    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from opencv_traffic_sign_detector_tpu_torch.eval.ap import (
        pr_from_tp_fp,
        precision_recall_curve,
    )
    from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics
    from opencv_traffic_sign_detector_tpu_torch.models.detector import DetectionPipeline
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        train_mean_masks,
    )
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    device = "cpu" if args.cpu else args.device
    why = missing_card(device)
    if why:
        print(why)
        return 2

    det_root = "/root/reference/Deteción de Objetos"
    test_dir = os.path.join(det_root, "test_alumnos_jpg")
    files = list_frame_files(test_dir)[: args.frames]

    tmpl_cache = os.path.join(tempfile.gettempdir(), "mean_masks.npz")
    if os.path.exists(tmpl_cache):
        templates = MeanMaskTemplates.load(tmpl_cache)
    else:
        print("training templates...")
        templates = train_mean_masks(os.path.join(det_root, "train_jpg"), device)
        templates.save(tmpl_cache)

    cfg = PipelineConfig(
        mser=MSERConfig(max_variation=1.0, max_regions=args.max_regions,
                        downscale=args.downscale, level_step=args.level_step),
        batch_size=args.batch,
    )
    pipe = DetectionPipeline(cfg=cfg, templates=templates, device=device)

    print(f"detecting over {len(files)} frames...")
    t0 = time.time()
    dets = []
    for start in range(0, len(files), args.batch):
        chunk = files[start:start + args.batch]
        frames = np.stack([load_image_bgr(os.path.join(test_dir, f)) for f in chunk])
        names = list(chunk)
        if len(chunk) < args.batch:
            reps = args.batch - len(chunk)
            frames = np.concatenate([frames, frames[-1:].repeat(reps, 0)])
            names += ["__pad__"] * reps
        dets.extend(d for d in pipe.detect_frames(frames, names) if d.filename != "__pad__")
        print(f"  {min(start + args.batch, len(files))}/{len(files)} "
              f"({time.time() - t0:.0f}s)")
    dt = time.time() - t0
    print(f"{len(dets)} detections in {dt:.1f}s ({len(files) / dt:.2f} fps)")
    write_results_file(args.out, dets)

    stems = {f.split(".")[0] for f in files}
    gt = [g for g in load_ground_truth(os.path.join(test_dir, "gt.txt"))
          if g.filename.split(".")[0] in stems]
    ref_dets = [
        d
        for d in load_results_file("tests/fixtures/ref_resultado_MSER_7_200_2000_1.txt")
        if d.filename.split(".")[0] in stems
    ]

    for name, d in (("ours", dets), ("reference", ref_dets)):
        stats = compute_detection_statistics(d, gt, frame_names=sorted(stems))
        t = stats.total
        tp, fp, _thr, n_gt = precision_recall_curve(gt, d)
        _, _, ap, _ = pr_from_tp_fp(tp, fp, n_gt)
        print(
            f"{name}: {len(d)} dets | correct {t.correct} incorrect "
            f"{t.incorrect} missed {t.non_detected} | P {t.precision} "
            f"R {t.recall} F1 {t.f1} | AP {ap:.4f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
