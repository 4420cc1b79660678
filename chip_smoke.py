#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--ptxas]

Phases, one line each:

1. device: requires ``torch.cuda.is_available()`` (else exit 1) and prints
   the card's name and ``nvidia-smi`` name and power limit;
2. build: builds the CUDA kernels from ``csrc/`` (into ``build/``) and loads
   them;
3. kernels: captures the inputs that the main path hands each kernel
   (K1-K4) on 32 synthetic 1360x800 frames, runs the kernel and its plain
   PyTorch version on those same CUDA tensors, requires exact equality,
   and times both with CUDA events (median of 10 after warm-up);
4. slice: runs ``DetectionPipeline`` (batch 32, MSER_7_200_2000_1 at the
   tuned ``--downscale 2`` point) for one warm-up and 3 timed batches from
   host frames to detection records, with per-stage CUDA-event times, and
   requires every kernel to have launched and every frame to have proposals;
5. slice vs plain: the same pipeline on 2 frames on the CPU (plain
   versions) must give identical proposals and matching detections.

Then one JSON line with the kernel table, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch


def _device_phase() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "one CUDA card", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()} name {name}")
    print(f"[device] nvidia-smi: {smi.splitlines()[0]}")
    return name


class CudaStageTimer:
    """Callable stage timer: ``with timer("name"):`` brackets the stage with
    CUDA events; :meth:`per_batch_ms` sums each stage per batch."""

    def __init__(self):
        self.events = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events[name].append((start, end))

    def per_batch_ms(self, batches: int) -> dict[str, float]:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / batches
                for k, v in self.events.items()}


def _time_ms(fn, runs: int = 10) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's per-kernel register/shared-memory report")
    args = ap.parse_args()

    kind = _device_phase()

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        templates_to_torch,
    )
    from opencv_traffic_sign_detector_tpu_torch.ops import clahe_cuda, mser, mser_cuda, prop_cuda
    from opencv_traffic_sign_detector_tpu_torch.ops.preprocess import enhance_contrast
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # --- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    if args.ptxas:
        rt.build(verbose=True)
    rt.library()
    print(f"[build] {rt.build().relative_to(rt.BUILD_ROOT.parents[1])} "
          f"built and loaded in {time.perf_counter() - t0:.2f} s")

    # main path: MSER_7_200_2000_1, tuned --downscale 2 point, batch 32
    mcfg = dataclasses.replace(MSERConfig.from_string("MSER_7_200_2000_1"),
                               downscale=2, ccl_iters=2, level_step=9,
                               ccl_jumps=0, max_regions=128)
    cfg = PipelineConfig(mser=mcfg, batch_size=32)
    frames = make_frames(32, 800, 1360, seed=args.seed)
    names = [f"{i:05d}.jpg" for i in range(len(frames))]
    templates = MeanMaskTemplates.load("artifacts/mean_masks.npz")
    red, blue = templates_to_torch(templates, dev)
    frames_dev = torch.from_numpy(frames).to(dev)

    # --- 3. kernels vs plain at the main path's shapes -------------------
    kernels = [
        ("tile_histograms", clahe_cuda, "tile_histograms", "tile_histograms_plain",
         "csrc/clahe.cu", "opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py:66"),
        ("clahe_apply", clahe_cuda, "clahe_apply", "clahe_apply_plain",
         "csrc/clahe.cu", "opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py:165"),
        ("level_sweep", mser_cuda, "level_sweep_windows", "level_sweep_windows_plain",
         "csrc/mser_sweep.cu", "opencv_traffic_sign_detector_tpu/ops/mser_pallas.py:507"),
        ("flood_bbox", prop_cuda, "flood_bbox", "flood_bbox_plain",
         "csrc/flood.cu", "opencv_traffic_sign_detector_tpu/ops/pallas_prop.py:234"),
    ]
    captured = {}
    originals = {}

    def recorder(name, fn):
        def wrapped(*a, **kw):
            captured.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapped

    # K4's wrapper is bound into ops/mser.py's namespace at import
    for name, mod, fn, _, _, _ in kernels:
        target = mser if fn == "flood_bbox" else mod
        originals[name] = (target, fn, getattr(target, fn))
        setattr(target, fn, recorder(name, getattr(target, fn)))
    try:
        det.detect_batch(frames_dev, red, blue, cfg)
    finally:
        for target, fn, orig in originals.values():
            setattr(target, fn, orig)
    torch.cuda.synchronize()

    table = []
    for name, mod, fn, plain_fn, src, replaces in kernels:
        a, kw = captured[name]
        kern, plain = getattr(mod, fn), getattr(mod, plain_fn)
        got = kern(*a, **kw)
        want = plain(*a, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs plain "
                                 f"{want.shape}/{want.dtype}")
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        shapes = [tuple(x.shape) for x in a if isinstance(x, torch.Tensor)]
        ms = _time_ms(lambda: kern(*a, **kw))
        plain_ms = _time_ms(lambda: plain(*a, **kw))
        print(f"[kernel] {name}: inputs {shapes} -> {tuple(got.shape)} "
              f"max_abs_err {err} (exact required) kernel {ms:.3f} ms "
              f"plain {plain_ms:.3f} ms")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version")
        table.append({"name": name, "route": "cuda",
                      "source": f"opencv_traffic_sign_detector_tpu_torch/{src}",
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms})

    # --- 4. the slice through DetectionPipeline --------------------------
    timer = CudaStageTimer()
    pipe = det.DetectionPipeline(cfg=cfg, templates=templates, device=dev)
    rt.reset_launch_counts()
    pipe.detect_frames(frames, names)  # warm-up batch
    torch.cuda.synchronize()
    pipe.timer = timer
    batch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        dets = pipe.detect_frames(frames, names)
        batch_s.append(time.perf_counter() - t0)
    counts = rt.launch_counts()
    stage_ms = timer.per_batch_ms(3)
    for row in table:
        row["launches"] = counts[row["name"]]

    props, pvalid = mser.mser_regions(enhance_contrast(frames_dev), mcfg)
    per_frame = pvalid.sum(-1).cpu().numpy()
    fps = len(frames) / statistics.median(batch_s)
    print(f"[slice] batch 32 of 1360x800: {fps:.2f} frames/s "
          f"(batch s {', '.join(f'{s:.4f}' for s in batch_s)}); stage ms per batch "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; proposals/frame min {per_frame.min()} mean {per_frame.mean():.2f}; "
          f"detections {len(dets)}; launches {counts}")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if (per_frame < 1).any():
        raise AssertionError(f"frames without proposals: {np.nonzero(per_frame < 1)[0]}")
    if not all(np.isfinite(d.score) and 1 <= d.class_id <= 6 for d in dets):
        raise AssertionError("malformed detection records")

    # --- 5. slice vs plain on 2 frames -----------------------------------
    cpu = torch.device("cpu")
    props_c, pvalid_c = mser.mser_regions(enhance_contrast(torch.from_numpy(frames[:2])), mcfg)
    if not (torch.equal(props[:2].cpu(), props_c) and torch.equal(pvalid[:2].cpu(), pvalid_c)):
        raise AssertionError("proposals on the card differ from the CPU plain slice")
    cpu_dets = det.DetectionPipeline(cfg=cfg, templates=templates,
                                     device=cpu).detect_frames(frames[:2], names[:2])
    gpu_dets = [d for d in dets if d.filename in names[:2]]

    def iou(a, b):
        ix = max(0, min(a.x2, b.x2) - max(a.x1, b.x1))
        iy = max(0, min(a.y2, b.y2) - max(a.y1, b.y1))
        inter = ix * iy
        union = ((a.x2 - a.x1) * (a.y2 - a.y1) + (b.x2 - b.x1) * (b.y2 - b.y1) - inter)
        return inter / union if union else 1.0

    ok = len(cpu_dets) == len(gpu_dets) and all(
        a.filename == b.filename and a.class_id == b.class_id and iou(a, b) >= 0.99
        for a, b in zip(gpu_dets, cpu_dets))
    print(f"[slice-vs-plain] 2 frames: proposals identical "
          f"({int(pvalid_c.sum())} valid); detections card {len(gpu_dets)} "
          f"cpu {len(cpu_dets)} match {ok}")
    if not ok:
        raise AssertionError(f"detections differ: card {gpu_dets} cpu {cpu_dets}")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
