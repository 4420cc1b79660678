#!/usr/bin/env python3
"""Quick full-set quality probe for MSER sweep variants, on the
PyTorch/CUDA port.

    python scripts/quality_probe_torch.py [--limit N] [--tag t] [--device cuda|cpu]

The twin of ``scripts/quality_probe.py``: the same flags, defaults, cache
(``mean_masks.npz`` at the repository root, trained from ``DET``'s
``train_jpg`` when absent) and one ``PROBE`` line: detections / P / R / F1
/ AP and frames/s; the detections go to ``probe_<tag>.txt`` in the temp
directory (``/tmp`` unless ``TMPDIR`` names another).  Plus ``--device``
(default ``cuda``; without a visible card it exits 2).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DET = "/root/reference/Deteción de Objetos"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--downscale", type=int, default=2)
    ap.add_argument("--max_regions", type=int, default=256)
    ap.add_argument("--level_step", type=int, default=0)
    ap.add_argument("--ccl_iters", type=int, default=8)
    ap.add_argument("--topk_pool", type=int, default=4)
    ap.add_argument("--cap_scale", type=float, default=4.0)
    ap.add_argument("--fused", type=int, default=1)
    ap.add_argument("--extent_only", type=int, default=0)
    ap.add_argument("--scan_passes", type=int, default=0)
    ap.add_argument("--refine_scan", type=int, default=0)
    ap.add_argument("--sweep_res", type=int, default=0,
                    help="1 = low-res front-end (preprocess + refine at "
                         "sweep resolution)")
    ap.add_argument("--fine_scores", type=int, default=0,
                    help="1 = unrounded score ranking (AP tie-breaks)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--limit", type=int, default=0, help="frame limit")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.data.images import list_frame_files
    from opencv_traffic_sign_detector_tpu_torch.eval.ap import score_detection_files
    from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics
    from opencv_traffic_sign_detector_tpu_torch.models.detector import DetectionPipeline
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        train_mean_masks,
    )
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    why = missing_card(args.device)
    if why:
        print(why)
        return 2

    mser = MSERConfig(
        max_variation=1.0, downscale=args.downscale, ccl_iters=args.ccl_iters,
        ccl_jumps=0, level_step=args.level_step, max_regions=args.max_regions,
        fused_sweep=bool(args.fused), bbox_area_cap_scale=args.cap_scale,
        topk_pool=args.topk_pool,
        sweep_extent_only=bool(args.extent_only),
        scan_passes=args.scan_passes,
        refine_scan_passes=args.refine_scan,
        sweep_res_pipeline=bool(args.sweep_res),
    )
    cfg = PipelineConfig(mser=mser, batch_size=args.batch, fine_scores=bool(args.fine_scores))

    cache = os.path.join(os.path.dirname(__file__), "..", "mean_masks.npz")
    if os.path.exists(cache):
        templates = MeanMaskTemplates.load(cache)
    else:
        templates = train_mean_masks(os.path.join(DET, "train_jpg"), args.device)
        templates.save(cache)

    pipe = DetectionPipeline(cfg=cfg, templates=templates, device=args.device)
    test_dir = os.path.join(DET, "test_alumnos_jpg")
    t0 = time.time()
    if args.limit:
        from opencv_traffic_sign_detector_tpu_torch.data.prefetch import batched_frames

        files = list_frame_files(test_dir)[: args.limit]
        dets = []
        for frames, names in batched_frames(test_dir, files, args.batch):
            dets.extend(d for d in pipe.detect_frames(frames, names) if d.filename != "__pad__")
    else:
        dets = pipe.run_directory(test_dir)
    dt = time.time() - t0
    n_frames = args.limit or len(list_frame_files(test_dir))

    out = os.path.join(tempfile.gettempdir(), f"probe_{args.tag or 'x'}.txt")
    write_results_file(out, dets)
    gt = os.path.join(test_dir, "gt.txt")
    stats = compute_detection_statistics(dets, gt)
    tot = stats.total
    p = tot.correct / max(tot.correct + tot.incorrect, 1)
    r = tot.correct / max(tot.expected, 1)
    f1 = 2 * p * r / max(p + r, 1e-9)
    ap_res = score_detection_files(out, gt)
    print(
        f"PROBE tag={args.tag} ds={args.downscale} step={args.level_step} "
        f"iters={args.ccl_iters} pool={args.topk_pool} cap={args.cap_scale} "
        f"regions={args.max_regions} fused={args.fused} ext={args.extent_only} "
        f"scan={args.scan_passes} rscan={args.refine_scan} | "
        f"dets={len(dets)} correct={tot.correct} P={p:.3f} R={r:.3f} "
        f"F1={f1:.3f} AP={ap_res['ap']:.4f} | {n_frames / dt:.2f} fps"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
