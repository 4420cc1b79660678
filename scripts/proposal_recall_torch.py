#!/usr/bin/env python3
"""Proposal-recall probe on the PyTorch/CUDA port: what fraction of GT
signs get an MSER proposal?

    python scripts/proposal_recall_torch.py --downscale 2 --max_regions 512 \
        [--device cuda|cpu] [--cpu]

The twin of ``scripts/proposal_recall.py``: the same flags, defaults and
lines, plus ``--device`` (default ``cuda``; without a visible card it
exits 2; ``--cpu`` is ``--device cpu``).  A GT box is covered if any grown
proposal reaches IoU >= 0.5 with it (the scorer's match threshold), so the
coverage bounds the recognizer's recall.  ``--fused_sweep 1`` (the
default) takes the fused level sweep, 0 the XLA sweep; ``--vs_cv2`` holds
the proposals against cv2.MSER's own grown box set (imports ``cv2``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TEST = "/root/reference/Deteción de Objetos/test_alumnos_jpg"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--test_path", default=TEST)
    ap.add_argument("--downscale", type=int, default=2)
    ap.add_argument("--max_regions", type=int, default=512)
    ap.add_argument("--level_step", type=int, default=0)
    ap.add_argument("--ccl_iters", type=int, default=24)
    ap.add_argument("--refine_scan", type=int, default=2)
    ap.add_argument("--max_variation", type=float, default=1.0)
    ap.add_argument("--delta", type=int, default=7)
    ap.add_argument("--min_area", type=int, default=200)
    ap.add_argument("--max_area", type=int, default=2000)
    ap.add_argument("--grow", default="1.15",
                    help="comma list: union of per-grow proposal sets")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--fused_sweep", type=int, default=1,
                    help="0 = the XLA level sweep, which (unlike the fused "
                    "kernel's per-pixel level collapse) can emit MULTIPLE "
                    "nested regions per anchor")
    ap.add_argument("--vs_cv2", action="store_true",
                    help="measure recall against cv2.MSER's own "
                    "aspect-filtered grown box set instead of GT")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig
    from opencv_traffic_sign_detector_tpu_torch.data.gt import load_ground_truth
    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from opencv_traffic_sign_detector_tpu_torch.models.detector import upload
    from opencv_traffic_sign_detector_tpu_torch.ops.geometry import filter_and_grow_boxes
    from opencv_traffic_sign_detector_tpu_torch.ops.mser import mser_regions
    from opencv_traffic_sign_detector_tpu_torch.ops.preprocess import enhance_contrast
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card

    device = "cpu" if args.cpu else args.device
    why = missing_card(device)
    if why:
        print(why)
        return 2

    cfg = MSERConfig(
        delta=args.delta, min_area=args.min_area, max_area=args.max_area,
        max_variation=args.max_variation, downscale=args.downscale,
        ccl_iters=args.ccl_iters, ccl_jumps=0, level_step=args.level_step,
        max_regions=args.max_regions, refine_scan_passes=args.refine_scan,
        fused_sweep=bool(args.fused_sweep),
    )

    gt = load_ground_truth(os.path.join(args.test_path, "gt.txt"), drop_unmapped=True)
    by_frame: dict[str, list] = {}
    for b in gt:
        by_frame.setdefault(b.filename, []).append(b)

    cv2_boxes: dict[str, list] | None = None
    if args.vs_cv2:
        # target set = cv2.MSER's own proposals after the reference's
        # aspect filter + 1.15 grow on the reference-exact enhanced gray
        import cv2 as _cv2

        from opencv_traffic_sign_detector_tpu_torch.data.gt import GroundTruthBox

        _mser = _cv2.MSER_create(delta=args.delta, min_area=args.min_area,
                                 max_area=args.max_area, max_variation=args.max_variation)
        _lut = (np.clip(((np.arange(256) / 255.0) ** 0.5) * 255.0, 0, 255)).astype(np.uint8)

        def _cv2_props(img):
            g = _cv2.cvtColor(img, _cv2.COLOR_BGR2GRAY)
            g = _cv2.createCLAHE(clipLimit=2.0).apply(g)
            g = _lut[_cv2.GaussianBlur(g, (3, 3), 0)]
            out = []
            for x, y, ww, hh in _mser.detectRegions(g)[1]:
                ar = ww / hh if hh else 0.0
                if not (0.8 < ar < 1.20):
                    continue
                cx, cy = x + ww / 2, y + hh / 2
                nw, nh = ww * 1.15, hh * 1.15
                out.append(GroundTruthBox(
                    filename="", x1=int(max(0, cx - nw / 2)),
                    y1=int(max(0, cy - nh / 2)), x2=int(cx + nw / 2),
                    y2=int(cy + nh / 2), class_id=1))
            return out
        cv2_boxes = {}

    files = list_frame_files(args.test_path)
    if args.limit:
        files = files[: args.limit]

    grows = tuple(float(g) for g in args.grow.split(","))

    def propose(frames):
        props, pvalid = mser_regions(enhance_contrast(frames), cfg)
        bs, ks = zip(*(filter_and_grow_boxes(props, pvalid, g) for g in grows))
        return torch.cat(bs, dim=1), torch.cat(ks, dim=1)

    n_gt = 0
    n_cov = 0
    per_class = {}
    props_per_frame = []
    for i in range(0, len(files), args.batch):
        chunk = files[i:i + args.batch]
        frames = np.stack([load_image_bgr(os.path.join(args.test_path, f)) for f in chunk])
        boxes, keep = propose(upload(frames, device))
        boxes = boxes.cpu().numpy()
        keep = keep.cpu().numpy()
        for j, fname in enumerate(chunk):
            bx = boxes[j][keep[j]]
            props_per_frame.append(len(bx))
            targets = (by_frame.get(fname, []) if cv2_boxes is None
                       else _cv2_props(frames[j]))
            for g in targets:
                n_gt += 1
                cls = g.class_id
                per_class.setdefault(cls, [0, 0])[0] += 1
                if len(bx) == 0:
                    continue
                # scorer IoU convention (+1 inclusive pixel widths)
                ix1 = np.maximum(bx[:, 0], g.x1)
                iy1 = np.maximum(bx[:, 1], g.y1)
                ix2 = np.minimum(bx[:, 2], g.x2)
                iy2 = np.minimum(bx[:, 3], g.y2)
                iw = np.maximum(0, ix2 - ix1 + 1)
                ih = np.maximum(0, iy2 - iy1 + 1)
                inter = iw * ih
                a1 = (bx[:, 2] - bx[:, 0] + 1) * (bx[:, 3] - bx[:, 1] + 1)
                a2 = (g.x2 - g.x1 + 1) * (g.y2 - g.y1 + 1)
                iou = inter / (a1 + a2 - inter)
                if np.max(iou) >= 0.5:
                    n_cov += 1
                    per_class[cls][1] += 1
        print(f"  {min(i + args.batch, len(files))}/{len(files)} frames | "
              f"coverage {n_cov}/{n_gt}", flush=True)

    print(f"\nproposal recall ceiling: {n_cov}/{n_gt} = {n_cov / max(1, n_gt):.3f}")
    print(f"mean proposals/frame: {np.mean(props_per_frame):.1f}")
    for cls in sorted(per_class):
        tot, cov = per_class[cls]
        print(f"  class {cls}: {cov}/{tot} = {cov / max(1, tot):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
