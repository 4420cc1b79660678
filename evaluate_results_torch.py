#!/usr/bin/env python3
"""Detection-results scorer on the PyTorch/CUDA port's host modules: PASCAL
AP + PR curves (the instructor's protocol).

Same flags and output as ``evaluate_results.py``: loads a detections file
and the ground truth, computes the class-agnostic PR curve at overlap 0.5
with ignore-region handling, prints VOC and 11-point AP, optionally scores
more result files and writes a PR plot or per-frame overlays.  It runs on
the host only (numpy).

    python evaluate_results_torch.py --test_path test_alumnos_jpg \
        --detections_file resultado.txt [--compare a.txt b.txt] [--plot pr.png]

The two instructor golden files are overlaid by default when found (in the
working directory or as the checked-in fixtures); --no_golden scores the
given files alone.
"""

from __future__ import annotations

import argparse
import os
import sys

from opencv_traffic_sign_detector_tpu_torch.data.gt import (
    boxes_by_file,
    load_ground_truth,
    load_results_file,
)
from opencv_traffic_sign_detector_tpu_torch.eval.ap import (
    pr_from_tp_fp,
    precision_recall_curve,
)

_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
# the instructor golden result files: the reference's names first, then the
# fixture copies checked into this repository
_GOLDEN_CANDIDATES = (
    ("resultado_práctica1_jmbuena.txt", os.path.join(_FIXTURES, "instructor_practica1.txt")),
    ("resultado_práctica2_jmbuena.txt", os.path.join(_FIXTURES, "instructor_practica2.txt")),
)


def find_golden_files() -> list[str]:
    """The instructor golden result files that can be found."""
    found = []
    for candidates in _GOLDEN_CANDIDATES:
        for path in candidates:
            if os.path.exists(path):
                found.append(path)
                break
    return found


def score(dets_path: str, gt) -> dict:
    dets = load_results_file(dets_path)
    tp, fp, _thr, n_gt = precision_recall_curve(gt, dets)
    rec, prec, ap, ap11 = pr_from_tp_fp(tp, fp, n_gt)
    return {"name": os.path.basename(dets_path), "rec": rec, "prec": prec, "ap": ap,
            "ap11": ap11, "n_det": len(dets), "n_gt": n_gt}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Scores detection results")
    parser.add_argument("--test_path", default="test_alumnos_jpg")
    parser.add_argument("--detections_file", default="resultado.txt")
    parser.add_argument("--compare", nargs="*", default=[],
                        help="additional result files to overlay")
    parser.add_argument("--no_golden", action="store_true",
                        help="skip the default instructor golden-file overlay")
    parser.add_argument("--plot", default=None, help="write PR curve PNG here")
    parser.add_argument("--draw_dir", default=None,
                        help="write per-frame overlay images here: GT boxes "
                             "green, scored detections red")
    args = parser.parse_args(argv)

    gt = load_ground_truth(os.path.join(args.test_path, "gt.txt"))
    results = [score(args.detections_file, gt)]
    compare = list(args.compare)
    if not args.no_golden:
        compare += [g for g in find_golden_files() if g not in compare]
    for extra in compare:
        results.append(score(extra, gt))

    for r in results:
        print(f"{r['name']}: AP={r['ap'] * 100:.1f} 11pt={r['ap11'] * 100:.1f} "
              f"({r['n_det']} detections, {r['n_gt']} GT)")

    if args.plot:
        import matplotlib  # imported here: hosts without matplotlib run the rest

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        for r in results:
            plt.plot(r["rec"], r["prec"], label=f"{r['name']} AP={r['ap'] * 100:.1f}")
        plt.grid()
        plt.xlim(0, 1)
        plt.ylim(0, 1.1)
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.legend()
        plt.title("Precision-Recall")
        plt.savefig(args.plot, dpi=120)
        print(f"PR plot written to {args.plot}")

    if args.draw_dir:
        draw_overlays(args.test_path, args.detections_file, gt, args.draw_dir)
    return 0


def draw_overlays(test_path: str, dets_path: str, gt, out_dir: str) -> None:
    """GT (green) + detection (red) rectangles per frame, saved to out_dir."""
    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from opencv_traffic_sign_detector_tpu_torch.utils.annotate import (
        draw_boxes_bgr,
        save_image_bgr,
    )

    dets = boxes_by_file(load_results_file(dets_path))
    gts = boxes_by_file(gt)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname in list_frame_files(test_path):
        d, g = dets.get(fname, []), gts.get(fname, [])
        if not d and not g:
            continue
        img = load_image_bgr(os.path.join(test_path, fname))
        img = draw_boxes_bgr(img, [(b.x1, b.y1, b.x2, b.y2) for b in g], color=(0, 255, 0),
                             thickness=2)
        img = draw_boxes_bgr(img, [(b.x1, b.y1, b.x2, b.y2) for b in d], color=(0, 0, 255),
                             thickness=1)
        save_image_bgr(os.path.join(out_dir, fname.replace(".jpg", ".png")), img)
        n += 1
    print(f"{n} overlay frames written to {out_dir}/")


if __name__ == "__main__":
    sys.exit(main())
