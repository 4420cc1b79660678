#!/usr/bin/env python3
"""Streaming detection server on the PyTorch/CUDA port: watch a directory,
emit JSONL detections.

Same flags, rejections, JSONL lines and report as ``serve_detection.py``,
plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions; with no card and no ``--device cpu`` it exits 2).  Frames
appearing in ``--watch_dir`` are decoded ahead on a background thread,
batched with a bounded linger (a partial batch is padded and flushed after
``--max_wait_ms``), uploaded pinned and non-blocking with one batch in
flight, and appended to ``--out`` as one JSON object per frame:

    {"file": "00600.jpg", "latency_ms": 41.3,
     "detections": [{"box": [x1, y1, x2, y2], "type": 3, "score": 0.78}]}

    python serve_detection_torch.py --watch_dir incoming/ --out results.jsonl
    python serve_detection_torch.py --watch_dir dir/ --once   # drain + exit

``--once`` processes the frames present and exits; otherwise the server
polls for new files until SIGINT.  Before the first frame is served, one
warm-up batch builds the kernels (and K2's launch plan) on the card; frames
are billed from after it.  On exit it prints frames/s and the p50/p95/p99
latency a frame, decode to result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _percentile(sorted_vals, p):
    if not sorted_vals:
        return float("nan")
    k = min(len(sorted_vals) - 1, max(0, int(round(p / 100 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class _CNNPipe:
    """The CNN detector behind the server's dispatch/collect/detect_frames
    calls: each batch's frame size is kept at dispatch so that collect
    clips its boxes to the frame (bgr, patches8, yuv420, yuv420p)."""

    def __init__(self, cnn):
        self.cnn = cnn
        self._orig_hw = None

    def dispatch(self, frames):
        from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import _HostCopy

        if isinstance(frames, tuple):  # yuv420 planes (y, cb, cr)
            s = 8 if frames[0].ndim == 4 else 1  # yuv420p patches
            self._orig_hw = (int(frames[0].shape[1]) * s, int(frames[0].shape[2]) * s)
            return _HostCopy(self.cnn.dispatch_yuv(*frames))
        scale = 8 if frames.shape[-1] == 192 else 1  # patches8
        self._orig_hw = (int(frames.shape[1]) * scale, int(frames.shape[2]) * scale)
        return _HostCopy(self.cnn.dispatch(frames))

    def collect(self, out, names):
        return self.cnn.collect(out, names, orig_hw=self._orig_hw)

    def detect_frames(self, frames, names):
        return self.cnn.detect_frames(frames, names,
                                      orig_hw=(int(frames.shape[1]), int(frames.shape[2])))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Streaming sign detector")
    parser.add_argument("--watch_dir", required=True)
    parser.add_argument("--out", default="detections.jsonl")
    parser.add_argument("--detector", default="MSER_7_200_2000_1",
                        help="MSER_<d>_<minA>_<maxA>_<maxVar> (parity "
                             "pipeline) or CNN[_<scoreThreshold>] (trained "
                             "detector; weights from --cnn_params)")
    parser.add_argument("--cnn_params", default="artifacts/cnn_detector/params.npz")
    parser.add_argument("--templates", default="mean_masks.npz",
                        help="trained mean-mask templates (trained on first "
                             "use if missing and --train_path is given)")
    parser.add_argument("--train_path", default=None)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda launches the CUDA kernels, "
                             "cpu runs their plain PyTorch versions")
    parser.add_argument("--input_format", default="bgr",
                        choices=["bgr", "yuv420", "yuv420p", "patches8"],
                        help="decode layout for the CNN detector: yuv420 ships "
                             "raw JPEG 4:2:0 planes, converted on the device "
                             "(yuv420p: the same planes patchified at decode "
                             "time); patches8 decodes into the stem's layout; "
                             "MSER requires bgr")
    parser.add_argument("--max_wait_ms", type=float, default=200.0,
                        help="max linger before flushing a partial batch")
    parser.add_argument("--poll_ms", type=float, default=50.0)
    parser.add_argument("--upscale", type=float, default=1.0,
                        help="CNN upscaled inference: frames are upscaled by "
                             "this factor (folded into the stem for fusable "
                             "ratios), boxes emitted in native coordinates; "
                             "bgr/yuv420 ingest only")
    parser.add_argument("--downscale", type=int, default=2)
    parser.add_argument("--max_regions", type=int, default=128)
    parser.add_argument("--once", action="store_true",
                        help="process existing frames, then exit")
    args = parser.parse_args(argv)

    import dataclasses as _dc

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.config import (
        ConfigError,
        MSERConfig,
        PipelineConfig,
    )
    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from opencv_traffic_sign_detector_tpu_torch.data.prefetch import batched_frames
    from opencv_traffic_sign_detector_tpu_torch.models.detector import DetectionPipeline
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        train_mean_masks,
    )
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card

    use_cnn = args.detector.upper().startswith("CNN")
    if args.input_format != "bgr" and not use_cnn:
        print("--input_format yuv420/patches8 requires --detector CNN "
              "(the MSER pipeline's color ops are defined on the "
              "cv2.imread-parity BGR decode)")
        return 2
    if args.upscale != 1.0 and (not use_cnn or args.input_format
                                in ("patches8", "yuv420p")):
        print("--upscale requires --detector CNN with bgr/yuv420 ingest "
              "(patches8/yuv420p are pre-patchified at native resolution)")
        return 2
    if use_cnn:
        from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import (
            CNNDetectorConfig,
            saved_meta,
        )
        from opencv_traffic_sign_detector_tpu_torch.models.cnn_quant import load_detector

        parts = args.detector.split("_")
        ccfg = CNNDetectorConfig(**(saved_meta(args.cnn_params)
                                    if os.path.exists(args.cnn_params) else {}))
        if len(parts) == 2:
            try:
                ccfg = _dc.replace(ccfg, score_threshold=float(parts[1]))
            except ValueError:
                print(f"Invalid CNN score threshold: {parts[1]!r}")
                return 2
        elif len(parts) > 2:
            print(f"Invalid spec: {args.detector!r} (CNN[_<threshold>])")
            return 2
        if not os.path.exists(args.cnn_params):
            print(f"CNN weights {args.cnn_params!r} not found "
                  "(train with scripts/train_cnn_torch.py)")
            return 2
        why = missing_card(args.device)
        if why:
            print(why)
            return 2
        pipe = _CNNPipe(load_detector(args.cnn_params, ccfg, upscale=args.upscale,
                                      device=args.device))
    else:
        try:
            mser = MSERConfig.from_string(args.detector)
        except ConfigError as e:
            print(f"Invalid spec: {e}")
            return 2
        if args.downscale > 1:
            mser = _dc.replace(mser, downscale=args.downscale, ccl_iters=2,
                               level_step=9, ccl_jumps=0)
        if args.max_regions:
            mser = _dc.replace(mser, max_regions=args.max_regions)
        cfg = PipelineConfig(mser=mser, batch_size=args.batch)
        why = missing_card(args.device)
        if why:
            print(why)
            return 2

        if os.path.exists(args.templates):
            templates = MeanMaskTemplates.load(args.templates)
        elif args.train_path:
            templates = train_mean_masks(args.train_path, args.device)
            templates.save(args.templates)
        else:
            print(f"templates file {args.templates!r} not found and no "
                  "--train_path given")
            return 2
        pipe = DetectionPipeline(cfg=cfg, templates=templates, device=args.device)
    seen: set[str] = set()
    latencies: list[float] = []
    n_frames = 0
    warmed = False
    t_start = time.time()

    def flush(batch_files, batch_arrivals, out_fh):
        """Process any number of pending frames with decode-ahead and one
        dispatched batch in flight while the previous one is unpacked."""
        nonlocal n_frames
        if not batch_files:
            return
        arrival_of = dict(zip(batch_files, batch_arrivals))

        def emit(out, names):
            nonlocal n_frames
            dets = pipe.collect(out, names)
            done = time.time()
            by_file: dict[str, list] = {}
            for d in dets:
                if d.filename != "__pad__":
                    by_file.setdefault(d.filename, []).append(d)
            for f in names:
                if f == "__pad__":
                    continue
                lat = (done - arrival_of[f]) * 1e3
                latencies.append(lat)
                n_frames += 1
                out_fh.write(json.dumps({
                    "file": f,
                    "latency_ms": round(lat, 1),
                    "detections": [
                        {"box": [d.x1, d.y1, d.x2, d.y2],
                         "type": d.class_id, "score": d.score}
                        for d in by_file.get(f, [])
                    ],
                }) + "\n")
            out_fh.flush()

        in_flight = None
        for frames, names in batched_frames(
            args.watch_dir, batch_files, args.batch,
            input_format=args.input_format if use_cnn else "bgr",
        ):
            out = pipe.dispatch(frames)
            if in_flight is not None:
                emit(*in_flight)
            in_flight = (out, names)
        if in_flight is not None:
            emit(*in_flight)

    print(f"serving {args.watch_dir} -> {args.out} "
          f"(batch {args.batch}, linger {args.max_wait_ms} ms"
          f"{', drain-once' if args.once else ''}, device {args.device})")
    pending: list[str] = []
    arrivals: list[float] = []
    first_pending = None
    try:
        with open(args.out, "a", encoding="utf-8") as out_fh:
            while True:
                now = time.time()
                for f in list_frame_files(args.watch_dir):
                    if f not in seen:
                        seen.add(f)
                        pending.append(f)
                        arrivals.append(now)
                        if first_pending is None:
                            first_pending = now
                if pending and not warmed:
                    # one-time kernel build and plan upload before serving
                    # starts; frames are billed from server readiness
                    frame0 = load_image_bgr(os.path.join(args.watch_dir, pending[0]))
                    pipe.detect_frames(np.stack([frame0] * args.batch),
                                       ["__pad__"] * args.batch)
                    warmed = True
                    now = time.time()
                    arrivals = [now] * len(arrivals)
                    first_pending = now
                    t_start = now  # fps report also bills from readiness
                while len(pending) >= args.batch:
                    flush(pending[: args.batch], arrivals[: args.batch], out_fh)
                    pending = pending[args.batch :]
                    arrivals = arrivals[args.batch :]
                    first_pending = time.time() if pending else None
                lingered = (
                    first_pending is not None
                    and (now - first_pending) * 1e3 >= args.max_wait_ms
                )
                if pending and (lingered or args.once):
                    flush(pending, arrivals, out_fh)
                    pending, arrivals, first_pending = [], [], None
                if args.once and not pending:
                    break
                time.sleep(args.poll_ms / 1e3)
    except KeyboardInterrupt:
        pass

    wall = time.time() - t_start
    lat_sorted = sorted(latencies)
    print(f"{n_frames} frames in {wall:.1f}s "
          f"({n_frames / max(wall, 1e-9):.1f} fps) | latency ms "
          f"p50 {_percentile(lat_sorted, 50):.0f} "
          f"p95 {_percentile(lat_sorted, 95):.0f} "
          f"p99 {_percentile(lat_sorted, 99):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
