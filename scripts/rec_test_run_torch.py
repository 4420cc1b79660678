#!/usr/bin/env python3
"""Run a saved recognition model over the test set and score it, on the
PyTorch/CUDA port.

    python scripts/rec_test_run_torch.py --model /tmp/sign_classifier \
        [--downscale 2] [--out /tmp/rec_resultado.txt] [--device cuda|cpu] [--cpu]

The twin of ``scripts/rec_test_run.py``: the same flags, defaults and lines
(the totals and the PASCAL AP), plus ``--device`` (default ``cuda``;
without a visible card it exits 2; ``--cpu`` is ``--device cpu``).
``--model`` and ``--out`` default to the temp directory (``/tmp`` unless
``TMPDIR`` names another).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    tmp = tempfile.gettempdir()
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default=os.path.join(tmp, "sign_classifier"))
    parser.add_argument("--test_path",
                        default="/root/reference/Deteción de Objetos/test_alumnos_jpg")
    parser.add_argument("--downscale", type=int, default=2)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--no_sign_tol", type=float, default=0.5)
    parser.add_argument("--rec_grows", default="1.15",
                        help="comma list of proposal grow factors")
    parser.add_argument("--sign_margin", type=float, default=0.0,
                        help="accept p_sign >= 0.5 - margin (P/R dial)")
    parser.add_argument("--max_regions", type=int, default=384)
    parser.add_argument("--out", default=os.path.join(tmp, "rec_resultado.txt"))
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda exits 2 when no card is visible")
    args = parser.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.eval.ap import score_detection_files
    from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics
    from opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline import RecognitionPipeline
    from opencv_traffic_sign_detector_tpu_torch.models.recognizer import SignClassifier
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    device = "cpu" if args.cpu else args.device
    why = missing_card(device)
    if why:
        print(why)
        return 2

    clf = SignClassifier.load(args.model)
    print(f"loaded {clf.config.to_string()} from {args.model}")
    if clf.proposal_spec:
        print(f"  trained on proposal distribution: {clf.proposal_spec} "
              "(keep inference proposals matched — see note below)")
    # keep the proposal distribution matched to training (max_regions 512,
    # level_step = delta): a tighter tuned detector config starves the
    # classifier of candidates
    mser = MSERConfig(max_variation=1.0, max_regions=args.max_regions,
                      downscale=args.downscale,
                      ccl_iters=8 if args.downscale > 1 else 16,
                      ccl_jumps=0 if args.downscale > 1 else 1)
    pipe = RecognitionPipeline(
        cfg=PipelineConfig(mser=mser, batch_size=args.batch,
                           no_sign_tol=args.no_sign_tol,
                           sign_margin=args.sign_margin,
                           rec_grows=tuple(float(g) for g in args.rec_grows.split(","))),
        classifier=clf,
        device=device,
    )
    t0 = time.time()
    dets = pipe.run_directory(args.test_path, progress=True)
    dt = time.time() - t0
    print(f"{len(dets)} detections in {dt:.1f}s")
    write_results_file(args.out, dets)

    gt_path = os.path.join(args.test_path, "gt.txt")
    t = compute_detection_statistics(dets, gt_path).total
    print(f"totals: correct {t.correct} incorrect {t.incorrect} missed "
          f"{t.non_detected} | P {t.precision} R {t.recall} F1 {t.f1}")
    ap = score_detection_files(args.out, gt_path)
    print(f"PASCAL AP@0.5: {ap['ap']:.4f} (11pt {ap['ap_11pt']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
