#!/usr/bin/env python3
"""Práctica-1 CLI on the PyTorch/CUDA port: traffic-sign detection over a
test directory.

Same grammar and output files as ``main_detection.py`` for the MSER
detector (``--pixel_area_stability``, every ``--downscale``, ``--n_devices``
sharding over cards or CPU shards and ``--trace_dir`` profiler traces
included) and the CNN family (``--detector CNN[_<thr>]`` with ``--cnn_params``,
``--input_format`` and ``--upscale``), plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain PyTorch versions; with no card and
no ``--device cpu`` it exits 2):

    python main_detection_torch.py --detector MSER_7_200_2000_1 \
        --train_path train_jpg --test_path test_alumnos_jpg
    python main_detection_torch.py --detector CNN \
        --cnn_params artifacts/cnn_detector/params.npz --upscale 1.6

MSER trains the mean-mask templates from train_path; CNN loads its weights
(float or int8, by the checkpoint's own tag).  Both detect on every frame of
test_path, write resultado.txt + annotated frames to resultado_imgs/, and
print per-type / total precision, recall and F1 against test_path/gt.txt.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import time

from opencv_traffic_sign_detector_tpu_torch.config import (
    ConfigError,
    MSERConfig,
    PipelineConfig,
)
from opencv_traffic_sign_detector_tpu_torch.data.gt import boxes_by_file
from opencv_traffic_sign_detector_tpu_torch.data.images import (
    list_frame_files,
    load_image_bgr,
)
from opencv_traffic_sign_detector_tpu_torch.eval.ap import score_detection_files
from opencv_traffic_sign_detector_tpu_torch.eval.stats import (
    compute_detection_statistics,
    format_stats_report,
)
from opencv_traffic_sign_detector_tpu_torch.models.detector import DetectionPipeline
from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import train_mean_masks
from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card
from opencv_traffic_sign_detector_tpu_torch.utils.annotate import (
    draw_boxes_bgr,
    save_image_bgr,
)
from opencv_traffic_sign_detector_tpu_torch.utils.profiling import (
    StageProfiler,
    profiler_trace,
)
from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file
from opencv_traffic_sign_detector_tpu_torch.utils.stages import StageError, stage

USAGE_HINT = """\
Detector spec: MSER_<delta>_<minArea>_<maxArea>_<maxVariation>
    delta          integer in (0, 40]
    minArea        integer in (0, 20000], <= maxArea
    maxArea        integer in (0, 20000]
    maxVariation   decimal in (0, 1]
Example: MSER_5_200_3000_0.45
Or the trained CNN family: CNN[_<scoreThreshold>]  (e.g. CNN_0.45);
weights from --cnn_params (train with scripts/train_cnn_torch.py)."""


def _run_cnn(args) -> int:
    """CNN-family orchestration (``main_detection.py: _run_cnn``): trained
    weights instead of mean-mask templates.  Spec: ``CNN`` or
    ``CNN_<scoreThreshold>``."""
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import (
        CNNDetectorConfig,
        saved_meta,
    )
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_quant import load_detector

    parts = args.detector.split("_")
    # arch and operating threshold come from the checkpoint's own tags; the
    # CNN_<thr> spec only overrides the threshold
    cfg = CNNDetectorConfig(**(saved_meta(args.cnn_params)
                               if os.path.exists(args.cnn_params) else {}))
    if len(parts) > 2 or (len(parts) == 2 and not parts[1]):
        print(f"Invalid detector spec: {args.detector!r}\n{USAGE_HINT}")
        return 2
    if len(parts) == 2:
        try:
            thr = float(parts[1])
            if not 0.0 < thr < 1.0:
                raise ValueError
        except ValueError:
            print(f"Invalid CNN score threshold: {parts[1]!r}\n{USAGE_HINT}")
            return 2
        cfg = dataclasses.replace(cfg, score_threshold=thr)

    test_path = args.test_path.replace("\\", "/")
    try:
        print(f"[1/4] loading CNN detector weights from {args.cnn_params} ...")
        with stage("load CNN detector weights"):
            det = load_detector(args.cnn_params, cfg, upscale=args.upscale,
                                device=args.device)
        if args.upscale != 1.0:
            print(f"      upscaled inference x{args.upscale:g} "
                  "(on-device bilinear; boxes in native coordinates)")

        print(f"[2/4] detecting over {test_path} on {args.device} "
              f"(score threshold {cfg.score_threshold}) ...")
        with stage("detect over test directory"):
            t0 = time.time()
            detections = det.run_directory(test_path, batch_size=args.batch_size,
                                           progress=True, input_format=args.input_format)
            dt = time.time() - t0
            n_frames = len(list_frame_files(test_path))
            print(f"      {len(detections)} detections over {n_frames} "
                  f"frames in {dt:.1f}s ({n_frames / max(dt, 1e-9):.2f} fps)")
        _write_and_score(args, test_path, detections)
    except StageError:
        return 1
    return 0


def _write_and_score(args, test_path: str, detections) -> None:
    """Stages 3 and 4: resultado.txt (+ annotated frames), then statistics
    and AP against test_path/gt.txt when it exists."""
    print(f"[3/4] writing {args.out}"
          + ("" if args.no_images else f" and {args.out_imgs}/"))
    with stage("serialize results"):
        write_results_file(args.out, detections)
        if not args.no_images:
            if os.path.isdir(args.out_imgs):
                shutil.rmtree(args.out_imgs)
            os.mkdir(args.out_imgs)
            per_file = boxes_by_file(detections)
            for fname in list_frame_files(test_path):
                img = load_image_bgr(os.path.join(test_path, fname))
                boxes = [(d.x1, d.y1, d.x2, d.y2) for d in per_file.get(fname, [])]
                save_image_bgr(os.path.join(args.out_imgs, fname),
                               draw_boxes_bgr(img, boxes))

    gt_path = os.path.join(test_path, "gt.txt")
    if os.path.exists(gt_path):
        print("[4/4] statistics vs", gt_path)
        with stage("statistics vs ground truth"):
            stats = compute_detection_statistics(detections, gt_path)
            print(format_stats_report(stats, per_file=args.per_file_stats))
            ap = score_detection_files(args.out, gt_path)
            print(f"\nPASCAL AP@0.5: {ap['ap']:.4f}  "
                  f"(11pt: {ap['ap_11pt']:.4f}, "
                  f"{ap['n_det']} detections, {ap['n_gt']} GT)")
    else:
        print("[4/4] no gt.txt found; skipping statistics")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Trains and executes a detector over a set of testing images")
    parser.add_argument("--detector", type=str, default="MSER_7_200_2000_1",
                        help="Detector string (default: MSER_7_200_2000_1)")
    parser.add_argument("--train_path", default="train_jpg")
    parser.add_argument("--test_path", default="test_alumnos_jpg")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda launches the CUDA kernels, "
                             "cpu runs their plain PyTorch versions")
    parser.add_argument("--input_format", default="bgr",
                        choices=["bgr", "yuv420", "yuv420p", "patches8"],
                        help="CNN-detector decode layout: yuv420 ships raw "
                             "JPEG 4:2:0 planes and converts them on the "
                             "device (the patchified yuv420p on v3 at native "
                             "resolution); patches8 decodes into the stem's "
                             "layout.  Ignored by MSER (bgr only)")
    parser.add_argument("--upscale", type=float, default=1.0,
                        help="CNN-detector upscaled inference: frames are "
                             "bilinearly upscaled before the forward (folded "
                             "into the stem for fusable ratios on v3) and "
                             "boxes mapped back to native coordinates.  "
                             "bgr/yuv420 ingest only")
    parser.add_argument("--out", default="resultado.txt")
    parser.add_argument("--out_imgs", default="resultado_imgs")
    parser.add_argument("--no-images", action="store_true",
                        help="skip writing annotated frames")
    parser.add_argument("--per-file-stats", action="store_true")
    parser.add_argument("--downscale", type=int, default=2,
                        help="MSER-stage downscale (2 = tuned fast mode; "
                             "1 = native-res sweep)")
    parser.add_argument("--max_regions", type=int, default=128,
                        help="proposal capacity per frame")
    parser.add_argument("--n_devices", type=int, default=0,
                        help="shard each batch over this many devices of "
                             "--device (0 = single device; ignored by the "
                             "CNN detector)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-stage wall-clock summary")
    parser.add_argument("--trace_dir", default=None,
                        help="capture a torch.profiler trace to this "
                             "directory (ignored by the CNN detector)")
    parser.add_argument("--cnn_params", default="artifacts/cnn_detector/params.npz",
                        help="weights for --detector CNN (float or int8)")
    parser.add_argument("--pixel_area_stability", action="store_true",
                        help="use OpenCV's exact pixel-count stability "
                             "semantics (the XLA level sweep with per-level "
                             "component-area counts) instead of the fused "
                             "sweep's bbox-area substitute; slower")
    args = parser.parse_args(argv)

    if args.upscale <= 0:
        print(f"Invalid --upscale {args.upscale!r}: must be > 0")
        return 2
    if args.upscale != 1.0 and args.input_format in ("patches8", "yuv420p"):
        print("--upscale needs full frames; patches8/yuv420p are "
              "pre-patchified at native resolution (use --input_format "
              "bgr or yuv420)")
        return 2
    why = missing_card(args.device)
    if why:
        print(why)
        return 2
    if args.detector.upper().startswith("CNN"):
        # as main_detection.py: the CNN branch returns before --n_devices and
        # --trace_dir are read, so both are ignored there
        return _run_cnn(args)

    try:
        mser = MSERConfig.from_string(args.detector)
    except ConfigError as e:
        print(f"Invalid detector spec: {e}\n{USAGE_HINT}")
        return 2
    mesh = None
    if args.n_devices:
        from opencv_traffic_sign_detector_tpu_torch.parallel.mesh import data_mesh

        try:
            mesh = data_mesh(args.n_devices, device=args.device)
        except ValueError as e:
            print(e)
            return 2
    # config selection copied from main_detection.py
    if args.downscale > 1 and not args.pixel_area_stability:
        # fused-kernel tuned operating point
        mser = dataclasses.replace(mser, downscale=args.downscale, ccl_iters=2,
                                   level_step=9, ccl_jumps=0)
    if args.max_regions:
        mser = dataclasses.replace(mser, max_regions=args.max_regions)
    if args.pixel_area_stability:
        # the XLA sweep keeps its own tuned params (iters 8, auto level step)
        mser = dataclasses.replace(mser, downscale=args.downscale, fused_sweep=False)
    cfg = PipelineConfig(mser=mser, batch_size=args.batch_size)
    train_path = args.train_path.replace("\\", "/")
    test_path = args.test_path.replace("\\", "/")
    prof = StageProfiler()

    try:
        print(f"[1/4] training mean-mask templates from {train_path} ...")
        t0 = time.time()
        with stage("train mean-mask templates"), prof.stage("train_templates"):
            templates = train_mean_masks(train_path, args.device)
        print(f"      done in {time.time() - t0:.1f}s")

        print(f"[2/4] detecting over {test_path} on {args.device} "
              f"(delta={mser.delta} area=[{mser.min_area},{mser.max_area}] "
              f"maxVar={mser.max_variation}) ...")
        with stage("detect over test directory"):
            if mesh is not None:
                print(f"      sharding batches over {args.n_devices} devices")
            pipe = DetectionPipeline(cfg=cfg, templates=templates, device=args.device,
                                     mesh=mesh)
            t0 = time.time()
            n_frames = len(list_frame_files(test_path))
            with profiler_trace(args.trace_dir), prof.stage("detect", items=n_frames):
                detections = pipe.run_directory(test_path, progress=True)
            dt = time.time() - t0
            print(f"      {len(detections)} detections over {n_frames} frames "
                  f"in {dt:.1f}s ({n_frames / max(dt, 1e-9):.2f} fps)")

        _write_and_score(args, test_path, detections)
    except StageError:
        return 1

    if args.profile:
        print("\n== stage profile ==")
        print(prof.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
