#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: detect+classify frames/s on one card.

    python bench_torch.py [--device cuda|cpu] [--model auto|cnn|mser] \
        [--frames 256] [--batch 32] [--cnn_batch 128] [--cnn_iters 12] ...

The twin of ``bench.py``: the same flags, defaults, scopes and JSON keys,
plus ``--device`` (default ``cuda``; without a visible card it exits 2,
never falling back to the CPU) and one more key, ``device`` (the card's
name, or ``cpu``).  Frames are GTSDB's test frames (1360x800) when
``DET_DATA`` holds them, else ``default_rng(0)`` noise; the 1080p scopes
pad them to 1088x1920.  It prints exactly one JSON line.

Scopes, timed on the host's clock around work that ends in
``torch.cuda.synchronize()``:

* CNN device queue (``value`` with the CNN): one batch uploaded before the
  window and dispatched ``--cnn_iters`` times, no copy and no sync inside
  the window; the median of 3 windows and their spread.  Layouts
  ``patches8``, ``bgr`` and ``yuv420p`` (4:2:0 planes repacked on the host);
  the int8 artifact and the upscaled operating point beside them.
* CNN fed (``fed_fps``, ``fed_yuv_fps``): distinct host batches, pinned
  before the window; batch i+1's copy runs on a side stream while batch i
  computes.
* MSER (``mser_fps``, or ``value`` with ``--model mser``): ``detect_batch``
  in the form the product runs it (``DetectionPipeline``): on a card one
  CUDA graph a frame shape, keyed by the config (``runtime/graphs.py:
  CapturedFn``), captured at the first of 3 warm-ups and replayed on the
  uploaded batches, each batch synchronised; the 1080p probe
  (``fps_1080p``) likewise, its warm-up the capture.  On the CPU each call
  runs ``detect_batch``.
* End to end (``e2e_fps``) and live quality (``*_test``, ``*_1080p``):
  ``run_directory`` over ``DET_DATA``'s test frames, scored with the parity
  stats and PASCAL AP, when the frames are there.

``REFERENCE_FPS`` and ``REFERENCE_DETECT_FPS`` are the original course
code's CPU runs over the GTSDB test set, the baselines ``bench.py`` uses.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from opencv_traffic_sign_detector_tpu_torch.models import detector
from opencv_traffic_sign_detector_tpu_torch.models.detector import upload
from opencv_traffic_sign_detector_tpu_torch.ops.upscale import resize_bilinear_u8

REFERENCE_FPS = 1.43  # the reference end to end: 150 frames / 105 s
# The reference's detect loop alone (MSERTrafficSignDetector a frame, no
# mask training, image writing or statistics) over the same 150 frames.
REFERENCE_DETECT_FPS = 1.715  # 150 frames / 87.5 s, MSER_7_200_2000_1
DET_DATA = "/root/reference/Deteción de Objetos"

CNN_PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "artifacts", "cnn_detector", "params.npz")


def _load_frames(n: int, size: str) -> np.ndarray:
    """[n, H, W, 3] uint8: the first test frames of ``DET_DATA``, tiled to
    ``n``, or noise; ``1080p`` reflect-pads them to 1088x1920."""
    test_dir = os.path.join(DET_DATA, "test_alumnos_jpg")
    frames = []
    if os.path.isdir(test_dir):
        from opencv_traffic_sign_detector_tpu_torch.data.images import (
            list_frame_files,
            load_image_bgr,
        )

        files = list_frame_files(test_dir)
        for f in files[: min(n, len(files))]:
            frames.append(load_image_bgr(os.path.join(test_dir, f)))
    if not frames:
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 256, (800, 1360, 3), np.uint8) for _ in range(n)]
    frames = np.stack(frames[:n])
    if len(frames) < n:
        reps = -(-n // len(frames))
        frames = np.tile(frames, (reps, 1, 1, 1))[:n]
    if size == "1080p":
        pad_h = 1088 - frames.shape[1]  # 800 -> 1088 (divisible tiling)
        pad_w = 1920 - frames.shape[2]
        frames = np.pad(frames, [(0, 0), (0, pad_h), (0, pad_w), (0, 0)], mode="reflect")
    return frames


def _detect(cfg, frames: torch.Tensor, red: torch.Tensor, blue: torch.Tensor):
    """``detect_batch`` under ``cfg``, the function the MSER scopes capture
    (looked up at each call)."""
    return detector.detect_batch(frames, red, blue, cfg)


def _weights_fingerprint(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:12]


def _score_dets(dets, gt_path: str) -> tuple:
    """Score a detection list live: (f1, ap, precision, recall)."""
    from opencv_traffic_sign_detector_tpu_torch.eval.ap import score_detection_files
    from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    stats = compute_detection_statistics(dets, gt_path)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        path = f.name
    write_results_file(path, dets)
    ap = score_detection_files(path, gt_path)["ap"]
    os.unlink(path)
    t = stats.total
    f1 = t.f1 if isinstance(t.f1, float) else 0.0
    p = t.precision if isinstance(t.precision, float) else 0.0
    r = t.recall if isinstance(t.recall, float) else 0.0
    return f1, ap, p, r


def _yuv420_planes(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[B, H, W, 3] BGR -> tight 4:2:0 planes (y, cb, cr): BT.601 full range,
    chroma averaged over 2x2 blocks, on the host, as a 4:2:0 camera or
    video feed would hand them over.  A frame a task on a thread pool (numpy
    releases the interpreter lock), each with ``bench.py``'s arithmetic."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        parts = list(ex.map(_yuv420_chunk, [frames[i:i + 1] for i in range(len(frames))]))
    return tuple(np.concatenate(p) for p in zip(*parts))


def _yuv420_chunk(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    f = frames.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = np.clip(np.round(0.299 * r + 0.587 * g + 0.114 * b), 0, 255).astype(np.uint8)
    cb = np.clip(np.round(128 - 0.168735892 * r - 0.331264108 * g + 0.5 * b), 0, 255)
    cr = np.clip(np.round(128 + 0.5 * r - 0.418687589 * g - 0.081312411 * b), 0, 255)

    def pool(p):
        return ((p[:, 0::2, 0::2] + p[:, 0::2, 1::2] + p[:, 1::2, 0::2] + p[:, 1::2, 1::2] + 2)
                / 4).astype(np.uint8)

    return y, pool(cb), pool(cr)


def _upscale(frames_u8: torch.Tensor) -> torch.Tensor:
    """The quality pass's resize to 1920x1088 (bench.py's jitted
    ``jax.image.resize``)."""
    return resize_bilinear_u8(frames_u8, 1088, 1920)


def _sync(device) -> None:
    """Wait for the card's work; a no-op on the CPU, where ops are done
    when they return."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _pinned(arrays, device) -> tuple:
    """Host arrays as tensors, page-locked when ``device`` is a card (so a
    copy from them does not block the host)."""
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return tuple(t.pin_memory() for t in out) if torch.device(device).type == "cuda" else out


def _fed(dispatch, host: list[tuple], device) -> None:
    """Dispatch each host batch (a tuple of tensors) in turn, batch i+1's
    upload enqueued before batch i's result is waited on.  On a card the
    uploads go from pinned memory on a side stream, so a copy overlaps the
    compute before it; each dispatch waits for its own copy."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for arrays in host:
            dispatch(*(upload(a, dev) for a in arrays))
        return
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)

    def stage(arrays):
        with torch.cuda.stream(side):
            return tuple(upload(a, dev) for a in arrays)

    staged = stage(host[0])
    for i in range(len(host)):
        main.wait_stream(side)
        for t in staged:
            t.record_stream(main)
        dispatch(*staged)
        if i + 1 < len(host):
            staged = stage(host[i + 1])


def _native_box(d, sx: float, sy: float, nh: int, nw: int):
    """A detection on the 1920x1088 frame mapped back to the native one."""
    return dataclasses.replace(
        d,
        x1=int(np.clip(round(d.x1 / sx), 0, nw - 1)),
        x2=int(np.clip(round(d.x2 / sx), 0, nw - 1)),
        y1=int(np.clip(round(d.y1 / sy), 0, nh - 1)),
        y2=int(np.clip(round(d.y2 / sy), 0, nh - 1)))


def _bench_cnn(args, result: dict, device) -> None:
    """The CNN scopes: device queue, fed, end to end and live quality.
    Every quality key is measured on the loaded checkpoint, and
    ``weights_sha256`` names it."""
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import CNNDetector
    from opencv_traffic_sign_detector_tpu_torch.ops.yuv import patchify_yuv_planes

    det = CNNDetector.load(CNN_PARAMS, device=device)
    result["weights_sha256"] = _weights_fingerprint(CNN_PARAMS)
    result["arch"] = det.cfg.arch

    # the int8 serving artifact (scripts/quantize_cnn_torch.py), a scope of
    # its own when present
    int8_path = os.path.join(os.path.dirname(CNN_PARAMS), "params_int8.npz")
    qdet = None
    if os.path.exists(int8_path):
        from opencv_traffic_sign_detector_tpu_torch.models.cnn_quant import QuantCNNDetector

        qdet = QuantCNNDetector.load(int8_path, device=device)
        result["int8_weights_sha256"] = _weights_fingerprint(int8_path)

    def run(size: str, layout: str = "patches8", d=None) -> float:
        """Device-queue frames/s: ONE batch, uploaded before the window,
        dispatched ``cnn_iters`` times; no copy from the host and no sync
        inside the window (on a card each dispatch copies the batch into its
        graph's input and replays the graph).  ``patches8`` is the serving
        layout of v3 (the loader decodes into it); ``bgr`` plain frames;
        ``yuv420p`` patchified 4:2:0 planes."""
        d = det if d is None else d
        frames = _load_frames(args.cnn_batch, size)
        if layout == "patches8" and d.cfg.arch == "v3":
            b, h, w, _ = frames.shape
            frames = np.ascontiguousarray(
                frames.reshape(b, h // 8, 8, w // 8, 24)
                .transpose(0, 1, 3, 2, 4)
                .reshape(b, h // 8, w // 8, 192))
        if layout == "yuv420p":
            dev = tuple(upload(p, device) for p in patchify_yuv_planes(*_yuv420_planes(frames)))
            dispatch = lambda: d.dispatch_yuv(*dev)  # noqa: E731
        else:
            dev_arr = upload(frames, device)
            dispatch = lambda: d.dispatch(dev_arr)  # noqa: E731
        dispatch()  # warm-up
        _sync(device)
        # the median of 3 timed windows, and their spread
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.cnn_iters):
                dispatch()
            _sync(device)
            windows.append(args.cnn_iters * args.cnn_batch / (time.perf_counter() - t0))
        windows.sort()
        run.last_spread_pct = round(100.0 * (windows[-1] - windows[0]) / windows[-1], 1)
        return windows[1]

    def run_fed(size: str, n_batches: int, yuv: bool = False) -> float:
        """Fed frames/s: every timed batch is a DISTINCT host batch whose
        upload is inside the window (:func:`_fed`); ``yuv`` ships tight
        4:2:0 planes (1.5 bytes a pixel), converted on the card."""
        frames = _load_frames(args.cnn_batch * n_batches, size)
        chunks = [frames[i * args.cnn_batch:(i + 1) * args.cnn_batch] for i in range(n_batches)]
        host = [_pinned(_yuv420_planes(c) if yuv else (c,), device) for c in chunks]
        dispatch = det.dispatch_yuv if yuv else det.dispatch
        dispatch(*(upload(a, device) for a in host[0]))  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        _fed(dispatch, host, device)
        _sync(device)
        return n_batches * args.cnn_batch / (time.perf_counter() - t0)

    fps = run("gtsdb")
    result.update({
        "metric": "gtsdb_1360x800_frames_per_sec_per_chip_detect_classify",
        "scope": "device_queue_batch%d_patches8" % args.cnn_batch,
        "model": "cnn_centernet",
        "value": round(fps, 3),
        "unit": "frames/s",
        "n_windows": 3,
        "spread_pct": run.last_spread_pct,
        "vs_baseline": round(fps / REFERENCE_FPS, 2),
        "vs_reference_detect_only": round(fps / REFERENCE_DETECT_FPS, 2),
    })
    result["gtsdb_fps_bgr_layout"] = round(run("gtsdb", "bgr"), 3)
    result["gtsdb_fps_yuv"] = round(run("gtsdb", "yuv420p"), 3)
    if not args.skip_1080p:
        result["fps_1080p"] = round(run("1080p"), 3)
        result["fps_1080p_bgr_layout"] = round(run("1080p", "bgr"), 3)
        result["fps_1080p_yuv"] = round(run("1080p", "yuv420p"), 3)
    if qdet is not None:
        result["gtsdb_fps_int8"] = round(run("gtsdb", d=qdet), 3)
        if not args.skip_1080p:
            result["fps_1080p_int8"] = round(run("1080p", d=qdet), 3)

    # the upscaled operating point (--upscale 1.6: the fused 8/5 plan on
    # native pixels, ops/fused_upscale.py), on BGR frames, int8 when present
    up_det = copy.copy(qdet if qdet is not None else det)
    up_det.upscale = args.upscale
    result["gtsdb_fps_upscaled"] = round(run("gtsdb", "bgr", d=up_det), 3)
    if not args.skip_1080p:
        result["fps_1080p_upscaled"] = round(run("1080p", "bgr", d=up_det), 3)
    up_float = copy.copy(det)
    up_float.upscale = args.upscale
    result["gtsdb_fps_upscaled_float"] = round(run("gtsdb", "bgr", d=up_float), 3)
    if args.fed_batches > 0:
        result["fed_fps"] = round(run_fed("gtsdb", args.fed_batches), 3)
        result["fed_yuv_fps"] = round(run_fed("gtsdb", args.fed_batches, yuv=True), 3)

    test_dir = os.path.join(DET_DATA, "test_alumnos_jpg")
    gt_path = os.path.join(test_dir, "gt.txt")
    if args.skip_e2e or not os.path.isdir(test_dir):
        return
    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_image_bgr,
    )
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    n_files = len(list_frame_files(test_dir))
    t0 = time.perf_counter()
    dets = det.run_directory(test_dir, batch_size=args.batch)
    with tempfile.NamedTemporaryFile("w", suffix=".txt") as f:
        write_results_file(f.name, dets)
    e2e_dt = time.perf_counter() - t0
    result["e2e_fps"] = round(n_files / e2e_dt, 3)
    result["e2e_vs_reference"] = round(n_files / e2e_dt / REFERENCE_FPS, 2)
    # live quality at the shipped operating point (native input)
    f1, ap, _, _ = _score_dets(dets, gt_path)
    result["cnn_f1_test"] = round(f1, 4)
    result["cnn_ap_test"] = round(ap, 4)

    if qdet is not None:
        dets_q = qdet.run_directory(test_dir, batch_size=args.batch)
        f1q, apq, _, _ = _score_dets(dets_q, gt_path)
        result["cnn_f1_int8_test"] = round(f1q, 4)
        result["cnn_ap_int8_test"] = round(apq, 4)

    # upscaled inference: its boxes come back in native coordinates
    dets_u = up_det.run_directory(test_dir, batch_size=args.batch)
    f1u, apu, _, _ = _score_dets(dets_u, gt_path)
    result["cnn_f1_upscaled_test"] = round(f1u, 4)
    result["cnn_ap_upscaled_test"] = round(apu, 4)

    # end to end on 4:2:0 planes, converted on the card, and its quality
    t0 = time.perf_counter()
    dets_yuv = det.run_directory(test_dir, batch_size=args.batch, input_format="yuv420")
    e2e_yuv_dt = time.perf_counter() - t0
    result["e2e_yuv_fps"] = round(n_files / e2e_yuv_dt, 3)
    f1y, apy, _, _ = _score_dets(dets_yuv, gt_path)
    result["cnn_f1_yuv_test"] = round(f1y, 4)
    result["cnn_ap_yuv_test"] = round(apy, 4)

    if args.skip_1080p:
        return
    # quality AT 1080p: frames scaled up on the card, detected, boxes mapped
    # back to native coordinates and scored on the reference protocol
    files = list_frame_files(test_dir)
    hd_dets = []
    bs = args.batch
    for i in range(0, len(files), bs):
        chunk = files[i:i + bs]
        frames = np.stack([load_image_bgr(os.path.join(test_dir, f)) for f in chunk])
        sy = 1088.0 / frames.shape[1]
        sx = 1920.0 / frames.shape[2]
        nh, nw = frames.shape[1:3]
        names = list(chunk)
        if len(chunk) < bs:  # whole batches, as the reference's static shapes
            pad = bs - len(chunk)
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
            names += ["__pad__"] * pad
        up = _upscale(upload(frames, device))
        hd_dets += [_native_box(d, sx, sy, nh, nw)
                    for d in det.detect_frames(up, names, orig_hw=(1088, 1920))
                    if d.filename != "__pad__"]
    f1h, aph, _, _ = _score_dets(hd_dets, gt_path)
    result["cnn_f1_1080p"] = round(f1h, 4)
    result["cnn_ap_1080p"] = round(aph, 4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    # 256 frames = 8 timed batches at the default batch 32
    parser.add_argument("--frames", type=int, default=256)
    # the CNN scopes: batch 128, 12 dispatches a window
    parser.add_argument("--cnn_batch", type=int, default=128)
    parser.add_argument("--cnn_iters", type=int, default=12)
    # the fed scope: distinct host batches, their uploads inside the window
    parser.add_argument("--fed_batches", type=int, default=3)
    parser.add_argument("--upscale", type=float, default=1.6,
                        help="upscaled-inference factor for the *_upscaled "
                        "scopes.  1.6 -> the fused 8/5 plan "
                        "(ops/fused_upscale.py: upscale+patchify+stem as "
                        "banded convs on native pixels, no upscaled frame), "
                        "boxes in native coordinates")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--size", choices=["gtsdb", "1080p"], default="gtsdb")
    parser.add_argument("--model", choices=["auto", "cnn", "mser"],
                        default="auto",
                        help="flagship scope: cnn (if weights exist) with "
                             "the MSER parity pipeline as extra fields")
    parser.add_argument("--max_regions", type=int, default=128)
    parser.add_argument("--downscale", type=int, default=2,
                        help="MSER-stage downscale (2 = tuned fast mode)")
    parser.add_argument("--ccl_iters", type=int, default=2)
    parser.add_argument("--level_step", type=int, default=9,
                        help="0 = auto (= delta); 9 = tuned")
    parser.add_argument("--scan_passes", type=int, default=0)
    parser.add_argument("--extent_only", type=int, default=0)
    parser.add_argument("--refine_scan", type=int, default=2)
    parser.add_argument("--skip_e2e", action="store_true",
                        help="skip the end-to-end (decode+serialize) scope")
    parser.add_argument("--skip_1080p", action="store_true",
                        help="skip the 1080p probe")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda exits 2 when no card is visible")
    args = parser.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        templates_to_torch,
        train_mean_masks,
    )
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card
    from opencv_traffic_sign_detector_tpu_torch.runtime.graphs import CapturedFn

    device = args.device
    why = missing_card(device)
    if why:
        print(why)
        return 2

    use_cnn = args.model == "cnn" or (args.model == "auto" and os.path.exists(CNN_PARAMS))
    cnn_result: dict = {}
    if use_cnn:
        _bench_cnn(args, cnn_result, device)

    frames = _load_frames(args.frames, args.size)
    n_batches = len(frames) // args.batch
    frames = frames[: n_batches * args.batch]

    tmpl_cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mean_masks.npz")
    train_dir = os.path.join(DET_DATA, "train_jpg")
    if os.path.exists(tmpl_cache):
        templates = MeanMaskTemplates.load(tmpl_cache)
    elif os.path.isdir(train_dir):
        templates = train_mean_masks(train_dir, device)
        templates.save(tmpl_cache)
    else:
        rng = np.random.default_rng(0)
        templates = MeanMaskTemplates(
            red=(rng.random((6, 625)) < 0.3).astype(np.float32),
            blue=(rng.random((6, 625)) < 0.3).astype(np.float32),
        )

    cfg = PipelineConfig(
        mser=MSERConfig(max_variation=1.0, max_regions=args.max_regions,
                        downscale=args.downscale, ccl_iters=args.ccl_iters,
                        ccl_jumps=0, level_step=args.level_step,
                        scan_passes=args.scan_passes,
                        sweep_extent_only=bool(args.extent_only),
                        refine_scan_passes=args.refine_scan),
        batch_size=args.batch,
    )
    red, blue = templates_to_torch(templates, device)
    batches = [upload(frames[i * args.batch:(i + 1) * args.batch], device)
               for i in range(n_batches)]
    mser = CapturedFn(_detect, keyed=True)

    def detect(b: torch.Tensor):
        return mser(device, b, red, blue, key=cfg)

    for _ in range(3):  # warm-up; the first captures the graph
        detect(batches[0])
        _sync(device)
    t0 = time.perf_counter()
    for b in batches:
        detect(b)
        _sync(device)
    fps = (n_batches * args.batch) / (time.perf_counter() - t0)

    test_dir = os.path.join(DET_DATA, "test_alumnos_jpg")
    if use_cnn:
        # the MSER pipeline rides along as extra keys; the headline is the CNN
        cnn_result["mser_fps"] = round(fps, 3)
        if not args.skip_e2e and os.path.isdir(test_dir):
            from opencv_traffic_sign_detector_tpu_torch.models.detector import (
                DetectionPipeline,
            )

            pipe = DetectionPipeline(cfg=cfg, templates=templates, device=device)
            mser_dets = pipe.run_directory(test_dir)
            f1, ap_m, _, _ = _score_dets(mser_dets, os.path.join(test_dir, "gt.txt"))
            cnn_result["mser_f1_test"] = round(f1, 4)
            cnn_result["mser_ap_test"] = round(ap_m, 4)
        cnn_result["device"] = _device_name(device)
        print(json.dumps(cnn_result))
        return 0

    metric = ("1080p_frames_per_sec_per_chip_detect_classify" if args.size == "1080p"
              else "gtsdb_1360x800_frames_per_sec_per_chip_detect_classify")
    result = {
        "metric": metric,
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_FPS, 2),
        "vs_reference_detect_only": round(fps / REFERENCE_DETECT_FPS, 2),
    }

    if not args.skip_e2e and args.size == "gtsdb" and os.path.isdir(test_dir):
        # end to end: JPEG decode (decode-ahead thread) -> card -> records ->
        # resultado.txt, over the whole test set
        from opencv_traffic_sign_detector_tpu_torch.data.images import list_frame_files
        from opencv_traffic_sign_detector_tpu_torch.models.detector import DetectionPipeline
        from opencv_traffic_sign_detector_tpu_torch.utils.serialization import (
            write_results_file,
        )

        pipe = DetectionPipeline(cfg=cfg, templates=templates, device=device)
        pipe.detect_frames(frames[: args.batch], ["w"] * args.batch)  # warm-up
        n_files = len(list_frame_files(test_dir))
        t0 = time.perf_counter()
        dets = pipe.run_directory(test_dir)
        with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=True) as f:
            write_results_file(f.name, dets)
        e2e_dt = time.perf_counter() - t0
        result["e2e_fps"] = round(n_files / e2e_dt, 3)
        result["e2e_vs_reference"] = round(n_files / e2e_dt / REFERENCE_FPS, 2)

    if not args.skip_1080p and args.size == "gtsdb":
        hd = _load_frames(2 * args.batch, "1080p")
        hd_batches = [upload(hd[i * args.batch:(i + 1) * args.batch], device) for i in range(2)]
        detect(hd_batches[0])  # warm-up: the 1088x1920 graph captured
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(2):
            for b in hd_batches:
                detect(b)
                _sync(device)
        result["fps_1080p"] = round(4 * args.batch / (time.perf_counter() - t0), 3)

    result["device"] = _device_name(device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
