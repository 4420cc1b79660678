#!/usr/bin/env python3
"""Per-stage profile of the MSER detection pipeline on the PyTorch/CUDA port.

    python scripts/stage_profile_torch.py [--batch 16] [--size gtsdb|1080p] \
        [--downscale 2] [--level_step 9] [--ccl_iters 2] [--refine_scan 2] \
        [--max_regions 128] [--device cuda|cpu]

The twin of ``scripts/stage_profile.py``: the same flags, config and lines,
plus ``--device`` (default ``cuda``; without a visible card it exits 2) and
a first line with the card's name and power limit.  The reference jits each
stage of ``detect_batch`` on its own and times it; here each stage is a
``runtime/graphs.py: CapturedFn``, captured as a CUDA graph at its first call
and replayed after that, as the product replays ``detect_batch``.  On the CPU
the stages run eagerly.  The stages are the module's functions of the
config (the key of their graphs) and one input:

* ``total``: the whole ``detect_batch``;
* ``pre``: ``enhance_contrast`` (gray, CLAHE, blur, gamma);
* ``downs_pad``: the 2x2-mean downscale and the padded polarity stack;
* ``sweep``: the fused level sweep over the ``[B*2, h, w]`` planes;
* ``msr``: ``mser_regions_batch`` (downscale, sweep, top-k, refine);
* ``post``: filter and grow, crops, both dedups and the mean-mask classify
  of ``(frames, props, pvalid)``.

A time is one first call (the capture), then the mean of 20 replays ended by
one synchronisation.  Frames come from ``bench_torch._load_frames`` (the
GTSDB test frames under ``bench_torch.DET_DATA``, else noise), templates
from ``artifacts/mean_masks.npz``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from opencv_traffic_sign_detector_tpu_torch.config import (  # noqa: E402
    MSERConfig,
    PipelineConfig,
)
from opencv_traffic_sign_detector_tpu_torch.constants import (  # noqa: E402
    DEDUP_COORD_TOL,
    DEDUP_HIST_TOL,
    DETECT_CROP,
    DETECT_GROW,
)
from opencv_traffic_sign_detector_tpu_torch.models import detector  # noqa: E402
from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (  # noqa: E402
    mask_correlation_classify,
)
from opencv_traffic_sign_detector_tpu_torch.ops.dedup import (  # noqa: E402
    dedup_by_coords,
    dedup_by_histogram,
)
from opencv_traffic_sign_detector_tpu_torch.ops.geometry import (  # noqa: E402
    filter_and_grow_boxes,
)
from opencv_traffic_sign_detector_tpu_torch.ops.mser import mser_regions_batch  # noqa: E402
from opencv_traffic_sign_detector_tpu_torch.ops.mser_cuda import (  # noqa: E402
    fused_level_sweep,
)
from opencv_traffic_sign_detector_tpu_torch.ops.preprocess import (  # noqa: E402
    enhance_contrast,
)
from opencv_traffic_sign_detector_tpu_torch.ops.resize import crop_and_resize  # noqa: E402

STAGES = ("total", "pre", "downs_pad", "sweep", "msr", "post")


def stage_config(batch: int = 16, downscale: int = 2, level_step: int = 9, ccl_iters: int = 2,
                 refine_scan: int = 2, max_regions: int = 128) -> PipelineConfig:
    """The original's config: the tuned MSER point with no pointer jumps."""
    return PipelineConfig(
        mser=MSERConfig(
            max_variation=1.0,
            max_regions=max_regions,
            downscale=downscale,
            ccl_jumps=0,
            ccl_iters=ccl_iters,
            level_step=level_step,
            refine_scan_passes=refine_scan,
        ),
        batch_size=batch,
    )


def total(cfg, frames, red, blue):
    return detector.detect_batch(frames, red, blue, cfg)


def pre(cfg, frames):
    return enhance_contrast(frames)


def downs_pad(cfg, gray):
    """[B, H, W] uint8 -> [B, 2, h+2, w+2] uint8: the 2x2 mean (floored),
    the ``[g, 255-g]`` stack and a border of 255."""
    ds = max(1, cfg.mser.downscale)
    b, h0, w0 = gray.shape
    hc, wc = (h0 // ds) * ds, (w0 // ds) * ds
    d = gray
    if ds > 1:
        d = (gray[:, :hc, :wc].reshape(b, hc // ds, ds, wc // ds, ds).to(torch.int32)
             .sum(dim=(2, 4)) // (ds * ds)).to(torch.uint8)
    both = torch.stack([d, 255 - d], dim=1)
    return torch.nn.functional.pad(both, (1, 1, 1, 1), value=255)


def sweep(cfg, im2s):
    """[B, 2, h, w] uint8 -> the level-collapsed map [B, 2, rows, cols], at
    the downscaled resolution's area bounds."""
    c = cfg.mser
    ds = max(1, c.downscale)
    s = c.level_step if c.level_step > 0 else c.delta
    d_idx = max(1, round(c.delta / s))
    num_levels = len(range(0, 256 + (d_idx + 1) * s + 1, s))
    sub = dataclasses.replace(c, min_area=max(c.min_area // (ds * ds), 1),
                              max_area=max(c.max_area // (ds * ds), 1), downscale=1)
    b, two, h, w = im2s.shape
    cmap = fused_level_sweep(im2s.reshape(b * two, h, w), sub, d_idx, num_levels)
    return cmap.reshape((b, two) + cmap.shape[1:])


def msr(cfg, gray):
    return mser_regions_batch(gray, cfg.mser)


def post(cfg, x, red, blue):
    """``(frames, props, pvalid)`` -> (boxes, types, scores, valid), each
    [B, N, ...]: ``detect_batch``'s classify stage before it compacts."""
    frames, props, pvalid = x
    detector.full_f32_matmuls()
    boxes, keep = filter_and_grow_boxes(props, pvalid, DETECT_GROW)
    crops = crop_and_resize(frames, boxes, DETECT_CROP)
    crops, boxes, keep = dedup_by_histogram(crops, boxes, keep, DEDUP_HIST_TOL)
    crops, boxes, keep = dedup_by_coords(crops, boxes, keep, DEDUP_COORD_TOL)
    types, scores, accept = mask_correlation_classify(crops, red, blue, cfg.mask_corr_tol)
    return boxes, types, scores, keep & accept


def stage_graphs() -> dict:
    """{stage: CapturedFn} of fresh graphs, keyed by the config."""
    from opencv_traffic_sign_detector_tpu_torch.runtime.graphs import CapturedFn

    return {name: CapturedFn(globals()[name], keyed=True) for name in STAGES}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, x, device, iters: int = 20):
    """(seconds a call, the last output): one first call, which captures
    the stage's graph, then ``iters`` replays ended by one synchronisation."""
    out = fn(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    _sync(device)
    return (time.perf_counter() - t0) / iters, out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", choices=["gtsdb", "1080p"], default="gtsdb")
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--level_step", type=int, default=9)
    p.add_argument("--ccl_iters", type=int, default=2)
    p.add_argument("--refine_scan", type=int, default=2)
    p.add_argument("--max_regions", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda exits 2 when no card is visible")
    args = p.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.runtime.build import card_line, missing_card

    why = missing_card(args.device)
    if why:
        print(why)
        return 2

    import bench_torch
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        templates_to_torch,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = stage_config(args.batch, args.downscale, args.level_step, args.ccl_iters,
                       args.refine_scan, args.max_regions)
    print(card_line(device))
    frames = torch.from_numpy(bench_torch._load_frames(args.batch, args.size)).to(device)
    templates = MeanMaskTemplates.load(os.path.join(REPO, "artifacts", "mean_masks.npz"))
    red, blue = templates_to_torch(templates, device)
    graphs = stage_graphs()

    def stage(name, *consts):
        return lambda x: graphs[name](device, x, *consts, key=cfg)

    with torch.inference_mode():
        t_total, _ = timeit(stage("total", red, blue), frames, device)
        t_pre, gray = timeit(stage("pre"), frames, device)
        t_dp, im2s = timeit(stage("downs_pad"), gray, device)
        t_sw, _ = timeit(stage("sweep"), im2s, device)
        t_msr, (props, pvalid) = timeit(stage("msr"), gray, device)
        t_post, _ = timeit(stage("post", red, blue), (frames, props, pvalid), device)

    b = args.batch
    print(f"batch={b} {args.size}  total={t_total*1e3:8.1f} ms  "
          f"({b/t_total:6.1f} fps)")
    for name, t in [
        ("preprocess (CLAHE etc.)", t_pre),
        ("downsample + polarity pad", t_dp),
        ("fused level sweep", t_sw),
        ("MSER total (sweep+topk+refine)", t_msr),
        ("crop/dedup/classify", t_post),
    ]:
        print(f"  {name:32s} {t*1e3:8.1f} ms  {100*t/t_total:5.1f}%")
    print(f"  {'topk+refine (MSER total - sweep - pad)':38s} "
          f"{(t_msr - t_sw - t_dp)*1e3:8.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
