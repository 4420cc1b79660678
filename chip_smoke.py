#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--ptxas]

Phases:

1. device: requires ``torch.cuda.is_available()`` (else exit 1) and prints
   the card's name and ``nvidia-smi`` name and power limit;
2. build: builds the CUDA kernels from ``csrc/`` (into ``build/``, one nvcc
   per source, in parallel) and loads them, and prints ptxas' registers and
   spills of the tiled sweep's two instantiations (K3 and K7), the scan-pass
   body's and K5's two register forms, and the integer minima and maxima in
   the SASS of the tiled sweep and K5's register forms (``cuobjdump``),
   which their bounds count;
3. kernels: captures the inputs that the paths hand each kernel on
   synthetic 1360x800 frames (K1 with and without its LUT tail, K2-K4, K7
   on the tuned main path at batch 32; K6 on that path's refine windows;
   K5 on the XLA sweep of the recall config at batch 8 (48 passes a call)
   and of the pixel-area config at batch 32 (8 passes a call), and on the
   roll-flood refine of the tuned config with ``refine_scan_passes=0`` at
   batch 32, 4096 windows of 128x128 held in registers, 96 passes or fewer
   where a window's flood is at rest), runs the kernel and its plain
   PyTorch version on those same CUDA tensors, requires exact equality, and
   times both with CUDA events (median of 10 after warm-up, :func:`_time_ms`;
   a plain version of 300 ms a call or more on its one checking call),
   with K1's library yardstick (``torch.bincount``), and computes each
   kernel's bound from its inputs (:func:`_bound`); the kernel is also
   timed as calls queued behind a spin of the card (:func:`_queued_ms`),
   which leaves a short kernel's launch overhead out; the lines of K1-K7
   also print the recorded times of their earlier designs
   (:data:`OLD_DESIGN`); K5's bound, where its form stops at a fixed point
   (every form but the tiled one), counts the passes each plane's data
   needs (:func:`_passes_to_rest`); then the sweep's other bodies at the
   tuned shapes, K3 and K7 each in its extent-only, scan-pass (2 passes)
   and combined form (:func:`_sweep_bodies`), and K4 and K5 at the low-res
   refine's shapes (``sweep_res_pipeline``: 4096 windows of 64x64 over the
   small stack; K5 with ``refine_scan_passes=0``, in its 64-px register
   form); one more line each times K5's two register-form calls where no
   window comes to rest and all 96 passes run (:func:`_k5_all_passes`);
4. identities: K7's per-level maps folded into ``max((qv << lbits) | t)``
   equal K3's output on the tuned single-strip windows (the two outputs of
   one tiled kernel), and the bbox and area of ``K6(seed map, mask) == 0``
   equal K4's output, both exactly (the launches of K6 and K7 are counted
   here: they are oracles); K7 folded equals K3 in each of the other three
   bodies; the scan-pass body of K3 on a 2-strip ``--downscale 1`` window
   set (4 frames of 1024x1360: 16 windows of 808x1364, halo 96) against
   its plain version (:func:`_scan_strips`), and K3 and K7's scan-pass body
   under plans forced to bands of 1, 2, 3 and 7 rows and several waves
   (:func:`_scan_bands`); then K3 and K7 at seven more
   shapes and
   configs cut from the tuned windows, each against its plain version and
   K7 folded against K3, and their refusal of windows too wide for their
   int16 bbox planes (:func:`_sweep_shapes`); K4 at more shapes
   against its plain version and K6 (:func:`_k4_shapes`); K2 at odd tile
   heights, unaligned rows and a reflect-padded frame (:func:`_k2_shapes`);
   K5's tiled form at planes narrower and shorter than a region, ragged
   sizes, 0 to 2 spans + 3 passes, masks on all four edges, 1 and 130
   planes, its register forms at 1, 133 and 300 planes of 128x128 and 1,
   3, 4 and 4097 of 64x64 with masks on all four edges, at each side a
   serpentine whose flood outlasts its passes and a sparse mask that must
   stop early (by its time), and its resident form at planes smaller than
   a window, 98x98 among them, and at the largest it takes (160x161)
   beside the smallest tiled plane (161x161), each shape's form as
   :func:`ops.prop_cuda.rolls_form` and the library name it
   (:func:`_k5_shapes`); K6 on random keys of both
   signs at 128x128, 37x100, thin and odd-width planes, passes 0 to 3, and
   on one run along a whole row and column (:func:`_k6_shapes`); K1 and its
   LUT tail at 1, 4 and 8 tiles,
   narrow tiles, unaligned widths and bases, flat and two-valued frames
   and the clip rule's corner cases (:func:`_k1_shapes`);
5. slice 1: runs ``DetectionPipeline`` (batch 32, MSER_7_200_2000_1 at the
   tuned ``--downscale 2`` point) for one warm-up batch, which captures the
   dispatch into a CUDA graph (``runtime/graphs.py``; the launches recorded
   at capture, a replay's, and the graph's kernel nodes read from its
   ``debug_dump`` must hold K1 with its tail and K2-K4, :func:`_graph_report`,
   :func:`_graph_kernel_names`), and 10 timed batches from
   host frames to detection records, run eagerly with the stage timer,
   with per-stage CUDA-event times
   (their sum is the device-side ms a batch, the yardstick between
   versions; frames/s on the host's clock is printed as median, min and
   max), then 10 batches replayed (the main path: launch counts equal the
   eager batches', each replay adding its capture's, and records equal;
   frames/s), the replayed packed output equal to the eager dispatch's bit
   for bit, one batch at a time and two in flight (:func:`_replay_vs_eager`),
   and requires K1 with its LUT tail and K2-K4 to have launched,
   every frame to have proposals and K2's plan tables not to have been
   built (uploaded) in the timed batches; requires one ``enhance_contrast``
   call to launch K1 with its tail and K2 once each (launch counts), and
   prints the CUDA kernels it launches, and those of the histogram-to-LUT
   steps as K1 with the plain steps and as ``tile_luts``
   (``torch.profiler``, :func:`_cuda_trace`); requires no host sync in a
   window of ``detect_batch`` calls and of ``DetectionPipeline.dispatch``
   calls (:func:`_require_no_sync`), and times the slice one batch at a
   time against two in flight (batch k+1 dispatched before batch k is
   collected, as ``run_directory`` does), 24 batches each way in turns,
   graph replays against eager dispatches: frames/s on the host's clock
   (:func:`_in_turns`), and the host's ms a dispatch spends enqueueing,
   replay against eager (:func:`_enqueue_ms`);
5b. the tracer (:func:`_trace_phase`; alone: :func:`trace_phase`, which
    also runs it on 32 frames of 1088x1920): the stamp kernel in stream
    order on the host's clock, outside the launch counts; the tuned slice's
    capture and 8 replays one in flight, each replay's stamps resolved in
    ``collect`` with every stage of ``detect_batch`` inside its host spans,
    the stages within 3% of the graph's stamps; the tracer off captures anew
    and records nothing; under ``torch.profiler`` the stamp that opens
    ``sweep`` within 0.1 ms of its kernels; the card's gaps between batches
    by host span, and the clock's drift;
6. slice 2: the same for the ``--pixel_area_stability`` config (XLA sweep,
   pixel-count stability), requiring K1, K2 and K4 to launch, K3 not to
   launch and every frame to have proposals; then one batch of 8 of the
   recall config (requires K5 launches on the sweep) and one batch of 32
   of the tuned config with the roll-flood refine (requires K5 launches on
   the refine); then slice 9, the tuned config with each of the sweep's
   knobs (``sweep_extent_only``, ``scan_passes=2``,
   ``sweep_res_pipeline``), one warm-up and 3 timed batches each (K1-K4
   must launch), and the low-res refine with ``refine_scan_passes=0`` (K5
   on the refine must launch, K4 not); each configuration's dispatch
   captured, replayed with the eager batches' launches and equal to the
   eager dispatch bit for bit, and without a host sync, as in phase 5;
7. slices vs plain: the tuned path on 2 frames, the pixel-area path on 2
   frames and the recall path on 1 frame on the CPU (plain versions) must
   give identical proposals, and the tuned path matching detections; each
   knob of slice 9 identical proposals and matching detections on 2
   frames;
8. slice 3, the CNN detector: the same 32 frames through every route of
   ``main_detection_torch.py --detector CNN`` (float v3 ``params.npz``:
   bgr, patches8, yuv420 tight and yuv420p planes made with numpy,
   ``--upscale`` 1.6 and 1.412 fused, 1.3 two-stage, 0.9 dense downscale;
   int8 ``params_int8.npz``: bgr and 1.6; ``params_slim.npz`` and
   ``params_v3.npz``: bgr), one warm-up batch, which captures the route's
   CUDA graph (one capture; the route check reads the route functions
   called at the capture; the graph's nodes by type and pool bytes,
   :func:`_cnn_graph_report`), and 3 timed batches each (1 for the last
   two), replayed (3 replays, no route function called), from host arrays
   to detection records; requires each route to take its branch, finite
   outputs and well-formed records, the replay equal to the eager dispatch
   bit for bit, or within an eager-against-eager control, one batch at a
   time and two in flight (:func:`_cnn_replay_vs_eager`), no host sync in
   4 replays, patches8 outputs equal to bgr's and yuv420p BGR patches equal
   to the patchified tight conversion; then float bgr at batch 32 and 8 and
   int8 ``--upscale 1.6`` at batch 32 replayed against eager in turns
   (:func:`_cnn_turns`: frames/s one at a time and two in flight, the
   host's ms a dispatch, busy ms and idle share by ``torch.profiler``);
9. CNN card vs CPU: each route on 1 frame (2 for float bgr) through the
   port's CPU path must give matching detections; the int8 stem
   activations agree within +-1 on a stated share, and the card's yuv BGR
   equals the CPU's.  The CNN path runs none of K1-K7 (its convs and
   products are PyTorch's), so its launch counts are 0;
10. the server, MSER: ``serve_detection_torch.py --once`` drains 64 JPEG
    frames of 1360x800 at its defaults (batch 8, ``--downscale 2``, 128
    regions) with templates the port trains on a synthetic crop tree; K1
    through its LUT tail, K2, K3 and K4 must launch; one well-formed JSONL
    line a frame; prints the server's frames/s and latency report and the
    p50/p95/p99 from the JSONL; the CPU server on 2 of the frames must
    write the same JSONL apart from ``latency_ms`` (:func:`_serve_phases`);
11. the server, CNN: the same with ``--detector CNN`` on bgr and yuv420
    ingest, boxes inside the frame, against the CPU within the CNN bound;
    in 10 and 11 every batch after the capture replays a graph (one capture,
    two with yuv420 ingest: the warm-up is bgr);
12. práctica 2, MSER proposals: ``run_validation`` (HOG_LDA_BAYES) on 12
    synthetic GTSDB-style train frames of 1360x800 with a gt.txt at the
    recognizer's defaults (``--downscale 1``, pointer jumps, 384 regions),
    then ``RecognitionPipeline.run_directory`` over 16 test frames with
    ``artifacts/sign_classifier_r5_cnn/``; K1 through its LUT tail, K2, K4
    and K5 must launch, K3 must not (the MSER dispatch replays a graph, which
    must hold them, and its output equals the eager one's bit for bit, one
    batch at a time and two in flight; a batch's ms replayed and eager); K4
    on the path's B x 384 windows and K5
    at its ``[2B, 802, 1362]`` sweep call are held against their plain
    versions exactly and timed as in phase 3; one frame's proposals,
    boxes, labels and scores (1e-4) against the CPU path
    (:func:`_recognition_phases`);
13. práctica 2, CNN proposals (the CLI's default source): mining (the
    detector's dispatch: one capture, then replays), validation and
    inference with the detector at threshold 0.10, where the first batch
    captures the whole of ``recognize_batch_cnn`` as one graph and the
    detector captures nothing more (its nodes and pool bytes printed), the
    replay equal to the eager function one batch at a time and two in
    flight, a batch's ms replayed and eager; frames/s and the same
    comparison with the CPU path; in 12 and 13
    ``RecognitionPipeline.dispatch`` without a host sync, as in phase 5;
14. training (:func:`_train_phases`): ``models/cnn_train.py: train`` of the
    v3 BatchNorm twin at the default ``TrainConfig`` (batch 32, 320x320
    crops, bf16 convs) but ``warmup_steps=3``, 31 steps, on 64 synthetic
    1360x800 frames with gt uploaded once, twice: eager with the stage
    timer, then replayed from one CUDA graph a step (no timer, as users
    run it); prints for each steps/s and crops/s on the host's clock
    (median, min, max of the 30 steps after the first), the peak memory
    allocated and the loss of the first and last 5 steps, for the eager run
    device ms a step by CUDA events split into sample+resize, targets,
    forward+backward and optimizer; requires finite losses and a lower mean
    of the last 5 than of the first 5 in each run, the replayed run's 31
    losses within 1e-2 relative of the eager run's, and well-formed records
    from the replayed run's folded net through ``CNNDetector`` on 8 frames;
    then the bf16 step eager and replayed in turns (:func:`_train_turns`:
    steps/s, the host's ms a step, device busy time and launches by
    ``torch.profiler`` and the card's idle share for each, the graph's nodes
    by type beside the eager launch count, its pool bytes, and no host sync
    in a window of replays); the card's captured AdamW against the CPU's
    over 48 counts of a schedule (:func:`_adamw_card_vs_cpu`: every update
    within 2e-5 relative); then for v3 and ``slim`` two f32 steps on the
    card and on the CPU from the same weights and draws
    (:func:`_f32_step_vs_cpu`: the CPU tests' bounds, but gradients within
    1e-3, and the parameters after the second update printed) and five f32
    steps replayed against eager on the card (:func:`_train_replay_vs_eager`:
    draws and crops equal, the rest within those bounds);
15. calibration: ``quantize_v3`` of the shipped v3 checkpoint on 8 of those
    frames on the card and on the CPU (int8 kernels identical, the other
    arrays within 1e-5 relative), and the card's artifact through
    ``QuantCNNDetector`` on the card.  Neither phase runs K1-K7;
16. scale-out (:func:`_scale_out_phases`): (a) ``DetectionPipeline(mesh=
    data_mesh())`` (every visible card) on the tuned slice at batch 32, a
    warm-up and 3 timed batches, records equal to the unsharded pipeline's,
    K1 with its LUT tail, K2, K3 and K4 launched (in each card's graph, and
    as many times replayed as eager), device-side ms and
    frames/s, replays equal to the eager dispatch bit for bit (one at a time
    and two in flight), its dispatch without a host sync, frames/s one
    batch at a time and two in flight, replayed and eager, beside one card
    where there are more, and the host's enqueue ms a shard, replay against
    eager (:func:`_scale_out_detection`; alone:
    :func:`scale_out_detection`); (b) ``distributed_train_step`` over 2
    shards on the card on the dry run's planted frames against 2 CPU
    shards (class counts equal, statistics within 1e-5, each fit within
    1e-5 of solving the CPU's statistics, :func:`_lda_backward_error`),
    and K5 at that step's sweep
    planes (``[8,98,98]``, 8 passes, the resident form) as a kernel row
    measured as in phase 3, its launches those of the step (78 a shard); (c) ``sharded_recognize_fn`` with (b)'s heads against the
    unsharded ``recognize_batch`` (boxes, labels, valid equal); (d) the
    SPMD CNN step on the tiny config for 2 steps, a capture a shard and a
    replay (finite losses, moving parameters, every shard's replica and
    AdamW state equal to the first's), its first step at f32 against the
    CPU mesh on the same
    crops of labelled frames (loss 1e-5, gradients 1e-3 of their largest,
    parameters equal after the count-0 update; on the noise frames
    printed); (e) sharded v3 inference with the head-bias
    surgery (a detection a frame, scores within 1e-5 and raw maps within
    5e-3 of the unsharded run); (f) ``distributed_statistics`` of (a)'s
    detections against the frames' drawn signs equal to the host engine;
    (g) (b) and (f) again through a one-rank NCCL process group (a
    ``FileStore`` under ``build/``), so the all-reduce runs on the card,
    and the graphed SPMD CNN step over the cards through it, its losses
    equal to the same shards' without the group
    (:func:`_spmd_group_losses`); (h) one MSER batch under
    ``profiler_trace``, whose trace must name the tiled sweep kernel; (i)
    the SPMD CNN step at the reference's training width (the published
    ``slim``, batch 32 crops a shard) over every card, one card and 2
    shards, eager against replayed (:func:`_scale_out_training`; with (g)'s
    CNN step alone: :func:`scale_out_training`);
17. the bench and the tool twins (:func:`_bench_phases`), on a
    ``write_gt_dir`` tree of 16 labelled 1360x800 frames with template
    crops under ``build/`` as the bench's data root: (a) K1 with and
    without its LUT tail, K2, K3 and K4 at the shapes the bench's 1080p
    probe gives them (batch 32 of 1088x1920: 8x8 tiles of 136x240, one
    strip of sweep windows, 4096 flood windows), exact against their plain
    versions, timed and bounded as in phase 3, and K3 and K7's scan-pass
    body with extent-only (as the bench's ``--scan_passes 2 --extent_only
    1`` runs it) on that strip; (b) ``bench_torch.main``
    at ``--frames 64 --cnn_iters 4 --fed_batches 2`` (every CNN scope at
    batch 128, the MSER scope, end to end and live quality on the tree:
    smoke values), its JSON line and peak memory printed; the MSER scope
    replays the graph the product runs (``bench_torch._detect`` through
    ``CapturedFn``): one capture at its first warm-up and 4 replays (2
    warm-ups, 2 timed batches), each replay adding K1-K4 once to the counts
    (``Captured.replay``, counted by frame shape), and no launch in the CNN
    scopes; (c) ``--model mser --skip_e2e`` replayed, eagerly
    (``CapturedFn.EAGER_DEVICES`` holding the card), eagerly and replayed in
    turns: ``mser_fps`` and ``fps_1080p`` each way, the probe one capture
    and 4 replays of K1-K4 once each; the same with ``--scan_passes 2
    --extent_only 1``; the scope's graph at 1360x800 and 1088x1920
    replayed against ``detect_batch`` eagerly, bit for bit, one batch at a
    time and two in flight (:func:`_replay_vs_eager`); the CNN scopes'
    graph captures (each input and reserved bytes) and replays, and the
    card's peak memory;
    (d) the probe's records on 2 frames against the CPU path; (e) one
    window of 4 dispatches of each CNN device-queue route, and of the fed
    scope, under ``torch.cuda.set_sync_debug_mode("warn")``: no host sync,
    each window replaying its route's graph; the device queue (patches8,
    batch 128) replayed against eager in turns (frames/s, the host's ms a
    dispatch) and the copy of its batch into the graph's input;
    (f) ``scripts/cnn_profile_torch.py --size gtsdb --batch 16`` and (g)
    ``scripts/quality_probe_torch.py --limit 4`` on the tree, and with
    ``--sweep_res 1``; (h) the stage profile twin and the two CNN rate
    probes (:func:`_stage_profile_phases`; alone: :func:`stage_profile`);
    (i) ``scripts/cnn_variants_torch.py`` for its nine variants at 1080p and
    GTSDB's size, batch 16 (one capture and 12 replays each, the last replay
    equal to the eager forward bit for bit), each variant's card forward
    against the CPU's (:data:`VARIANT_BOUND`), product mode for six archs,
    and ``scripts/tpu_microbench_torch.py`` for its nine cases, each equal
    to the CPU on the same inputs (:func:`_probe_phases`; alone:
    :func:`tool_probes`).  Templates
    the bench trains at the repository root are removed at the end;
18. graph memory (:func:`_graph_memory`; alone: :func:`graph_memory`): one
    process meets 8 MSER frame sizes at batch 32 (:data:`GRAPH_SIZES`,
    640x480 to 1920x1088) through one ``DetectionPipeline``, the 12 CNN
    routes of phase 8 at batch 32 (phase 17's float and int8 nets, with
    graphs of their own) and the first size again: after each, the
    captures and their reserved bytes, ``memory_reserved`` split by pool
    (``torch.cuda.memory_snapshot``), the bytes in use by ``mem_get_info`` and the
    card's graph account against its budget (``runtime/graphs.py``);
    requires a capture at each new key and no eager call, reserved after
    the 8th size within 10% of the 4th, at or under the budget plus the
    largest MSER graph after every step, and the first size evicted,
    captured again and replayed equal to eager bit for bit.

Then one JSON line with the kernel table (each kernel's launches on its
path's run, max abs error, ms, plain ms, bound ms and what bounds it, the
library call's ms or null, and the queued ms), and as the last line ``{"ok": true,
"device": {...}}``.  Any failure raises and exits non-zero; so does an
import of JAX, flax, optax or of the reference package.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
import weakref
from collections import defaultdict

import torch


# Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet):
# 3.35 TB/s of HBM, and 67 TFLOP/s of f32 outside the tensor cores, which
# counts a fused multiply-add as two: 33.5 T lane operations a second, the
# most an SM starts (128 lanes a cycle).  Integer compares, min/max,
# selects and logic run on the integer pipe, 64 lanes an SM a cycle against
# the f32 pipe's 128 (NVIDIA's Hopper architecture white paper): half that.
HBM_BYTES_S = 3.35e12
LANE_OPS_S = 33.5e12
INT_OPS_S = LANE_OPS_S / 2
# Operations per element of each kernel's plain formulation, one compare,
# and/or, min/max, select, add, multiply, division or conversion each, as
# (integer pipe, f32 pipe).  The sweep (K3, K7), per mask pixel and level
# (a pixel outside the level's mask keeps its sentinels and, the mask
# growing with the level, has no ring value to move): the warm start (mask
# 5, key 2, min/max 5, selects 5), each Jacobi pass as the card runs it
# (the least of five keys, two 3-input minima; the least (ymin, xmin) and
# the largest (ymax, xmax) of five, each pair packed 16x2 in a word, two
# 3-input packed minima or maxima each; the liveness test and the dead
# pixel's two sentinels: 9, where 4 two-input minima and a select a plane
# over 5 planes, 27, were counted before; the SASS of sweep_tile_kernel
# holds VIMNMX3 twice for the key and three VIMNMX(3).S16x2 for each pair)
# and the emit (anchor 2, bbox area 8, dead mark 4, variation 7, candidate
# 9, diversity 7, last-emit 1, byte 5, packing 4, max 1, bf16 conversions
# 8), whose f32 products, sums, division, floor and conversions (20 of its
# 56) take the f32 pipe.
SWEEP_OPS = {"init": (17, 0), "pass": (9, 0), "emit": (36, 20)}
# The extent-only emit takes the squared height: two shifts, a subtraction,
# an add and a conversion fewer than the bbox area.
EXTENT_EMIT_OPS = (32, 19)
# The scan-pass body (mser_pallas.py: axis_resolve) per mask pixel and run
# resolve, along a row or a column alike: the reduce of each run over its
# line, one fold of each pixel into its run (mask 1, the key's min 1, live
# 1, two packed min/max) and the run's start and end tests 3, then the
# whole run's value written back (the result's live test and two selects
# 3).  A row's runs wrap from column w - 1 to 0, a carry a row, not a
# pixel.  Warm start and emit as above.
SWEEP_SCAN_OPS = (11, 0)
# K1 one count a pixel (its LUT tail adds, a bin of each tile's 256, two
# for the clip, three for the bonus, a sum, a conversion, a product and a
# round: LUT_OPS); K2 four lookups, their conversions, the bilinear
# blend (6 products, 3 sums; the row and column weights are per row and per
# column, not per pixel), round and two clamps; K6 per resolve of a run
# scan: two directed scans (2 each), their min and a select.
K2_OPS, SCAN_OPS, LUT_OPS = 20, 6, 9
# K4 on bits (csrc/flood.cu): a compare a pixel for the mask, then per
# 32-pixel word its ballot, each row resolve (two carry fills of 5, three
# reversals, a union), each column resolve (an and and an or down and up)
# and the reduction (popcount, sum, column OR).
FLOOD_OPS = {"mask": 1, "pack": 1, "row": 14, "col": 4, "reduce": 3}
# K5 a pixel a pass: the least of five keys, two 3-input minima (one
# integer instruction each on sm_90, __vimin3_s32), and the mask, one
# maximum with a floor or a select; plus the mask once a pixel.  A test for
# a change that lets a form stop at a fixed point is the design's work, not
# the function's: the passes counted are those the data needs instead.
ROLLS_OPS = 3
# Earlier designs at the tuned path's shapes, one call between events, as
# recorded on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6): K3 per
# pass (an init, each pass and an emit a launch, state in device memory;
# [64,408,684] windows, 31 levels) and K7 on the same design ([64,402,682]
# planes to [64,31,402,682] bytes); K4 with a thread walking each row or
# column run by run (4096 windows of 128x128) and K2 with the frame's whole
# LUT set a block and per-pixel coordinate loads ([32,800,1360]); K5 on the
# sweep streaming the key stack through device memory, a launch a pass
# ([16,402,682], 48 passes) and K1 with a block a (frame, tile), a byte a
# thread a step ([32,800,1360]); K5 on the refine with a window's keys and
# mask in one block's shared memory, all 96 passes ([4096,128,128]) and K6
# with a thread walking each row or column run by run in shared memory
# ([4096,128,128], 2 passes).
K3_OLD_MS = 46.198
K4_OLD_MS = 1.356
K2_OLD_MS = 0.443
K5_OLD_MS = 1.089
K1_OLD_MS = 0.0857
K5_REFINE_OLD_MS = 10.4507
K6_OLD_MS = 3.6236
K7_OLD_MS = 44.4576
# The scan-pass body's first form (a launch a run resolve, the state in
# device memory between them), 2 passes: K3 on the tuned [64,408,684]
# windows and the 2-strip [16,808,1364] set, K7 on [64,402,682] planes.
K3_SCAN_OLD_MS = 48.2324
K3_SCAN_STRIPS_OLD_MS = 60.0918
K7_SCAN_OLD_MS = 47.7864
# K5 at the low-res refine's [4096,64,64] windows, 96 passes, in the
# shared-memory form that ran every pass (a block a plane of 1024 threads).
K5_SWEEP_RES_OLD_MS = 3.0928
OLD_DESIGN = {"level_sweep": ("old per-pass design", K3_OLD_MS),
              "level_sweep_full": ("old per-pass design", K7_OLD_MS),
              "flood_bbox": ("old run-walk design", K4_OLD_MS),
              "clahe_apply": ("old whole-LUT design", K2_OLD_MS),
              "propagate_rolls": ("old streaming design, a launch a pass", K5_OLD_MS),
              "tile_histograms": ("old block-a-tile design", K1_OLD_MS),
              "propagate_rolls_refine": ("old shared-memory design, all passes",
                                         K5_REFINE_OLD_MS),
              "propagate_scan": ("old run-walk design", K6_OLD_MS),
              "level_sweep_scan": ("scan body's first form", K3_SCAN_OLD_MS),
              "level_sweep_scan_strips": ("scan body's first form", K3_SCAN_STRIPS_OLD_MS),
              "level_sweep_full_scan": ("scan body's first form", K7_SCAN_OLD_MS),
              "propagate_rolls_sweep_res": ("old shared-memory form, all passes",
                                            K5_SWEEP_RES_OLD_MS)}


def _mask_pixel_levels(x: torch.Tensor, step: int, num_levels: int) -> int:
    """Sum over the sweep's levels of the pixels in the level's mask:
    value <= level * step, off a window's first and last rows."""
    below = torch.bincount(x[:, 1:-1].reshape(-1).long(), minlength=256).cumsum(0)
    return sum(int(below[min(t * step, 255)]) for t in range(num_levels))


def _window_union(shape, cand: torch.Tensor, wh: int, ww: int) -> int:
    """Pixels of planes of ``shape`` under at least one candidate's window,
    origins clamped as K4 clamps them: +-1 at the windows' corners, summed
    down and across."""
    p, h, w = shape
    plane = cand[:, 0].long().clamp(0, p - 1)
    y0, x0 = cand[:, 1].long().clamp(0, h - wh), cand[:, 2].long().clamp(0, w - ww)
    corners = torch.zeros((p, h + 1, w + 1), dtype=torch.int32, device=cand.device)
    one = torch.ones_like(y0, dtype=torch.int32)
    for dy, dx, sign in ((0, 0, 1), (wh, 0, -1), (0, ww, -1), (wh, ww, 1)):
        corners.index_put_((plane, y0 + dy, x0 + dx), sign * one, accumulate=True)
    return int((corners.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32) > 0).sum())


def _passes_to_rest(keys: torch.Tensor, mask: torch.Tensor, big: int,
                    passes: int) -> torch.Tensor:
    """Per plane, the passes of K5 that these keys need: every pass that
    changes a key of the plane and the one that finds none changed, a fixed
    point, at most ``passes``; from the plain version pass by pass."""
    from opencv_traffic_sign_detector_tpu_torch.ops.prop_cuda import propagate_rolls_plain

    k = torch.where(mask, keys, big)
    need = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    live = torch.ones_like(need, dtype=torch.bool)
    for _ in range(passes):
        new = propagate_rolls_plain(k, mask, big, 1)
        need += live
        live &= (new != k).flatten(1).any(1)
        k = new
        if not live.any():
            break
    return need


def _bound(name: str, args: tuple, out: torch.Tensor,
           need: torch.Tensor | None = None) -> tuple[float, str, int, int]:
    """(least time in ms, "bytes" or "operations", bytes, operations) of one
    call: each input byte read once, each output byte written once, and the
    operations its inputs need, the integer ones no faster than the integer
    pipe and all no faster than an SM starts them, over the published peaks.
    ``need``: K5's passes per plane where the call may stop at a fixed point
    (:func:`_passes_to_rest`); without it every plane counts all passes."""
    from opencv_traffic_sign_detector_tpu_torch.ops.mser_cuda import SweepParams
    from opencv_traffic_sign_detector_tpu_torch.ops.prop_cuda import candidate_windows

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += out.numel() * out.element_size()
    x = tensors[0]
    f32_ops = 0
    if name == "tile_histograms":
        int_ops = x.numel()
    elif name == "tile_luts":
        int_ops = x.numel() + LUT_OPS * out.numel()
    elif name == "clahe_apply":
        int_ops, f32_ops = 0, K2_OPS * x.numel()
    elif name in ("level_sweep", "level_sweep_full"):
        if name == "level_sweep":
            _, params, _, _, nl, _ = args
        else:
            _, cfg, d_idx, nl = args
            params = SweepParams.from_config(cfg, d_idx)
        px = _mask_pixel_levels(x, params.step, nl)
        emit = EXTENT_EMIT_OPS if params.extent_only else SWEEP_OPS["emit"]
        sp = params.scan_passes
        prop = ([(2 * sp + 1) * v for v in SWEEP_SCAN_OPS] if sp
                else [params.num_passes * v for v in SWEEP_OPS["pass"]])
        int_ops, f32_ops = (px * sum(v) for v in zip(SWEEP_OPS["init"], prop, emit))
    elif name.startswith("flood_bbox"):
        # the plane bytes under the windows whose seed is on its mask, each
        # once (the windows overlap), and any other window's seed byte:
        # the windows, not the planes
        planes, cand, win_h, win_w, passes, _ = args
        mask, seed = candidate_windows(planes, cand, win_h, win_w)
        on = (mask & seed).flatten(1).any(1)
        seeded = int(on.sum())
        px = seeded * win_h * win_w
        covered = _window_union(planes.shape, cand[on], win_h, win_w)
        nbytes += covered + cand.shape[0] - seeded - planes.numel()
        f = FLOOD_OPS
        per_word = f["pack"] + (passes + 1) * f["row"] + passes * f["col"] + f["reduce"]
        int_ops = px * f["mask"] + seeded * win_h * -(-win_w // 32) * per_word
    elif name.startswith("propagate_rolls"):
        per_plane = x[0].numel()
        total = x.shape[0] * args[3] if need is None else int(need.sum())
        int_ops = x.numel() + ROLLS_OPS * per_plane * total
    elif name == "propagate_scan":
        int_ops = x.numel() * (1 + SCAN_OPS * (2 * args[3] + 1))
    else:
        raise KeyError(name)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(int_ops / INT_OPS_S, (int_ops + f32_ops) / LANE_OPS_S) * 1e3
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes,
            int_ops + f32_ops)


# A plain version this slow is timed on its one checking call, not as the
# median of 10 (the sweeps' plain versions take 0.5-5 s a call)
PLAIN_ONCE_MS = 300.0

# Kernels without a PyTorch call that computes the same function
NO_LIBRARY = {
    "tile_luts": "no call clips, sums and scales per-tile histograms",
    "propagate_rolls_pixel_area": "as at the recall config's call",
    "clahe_apply": "no call applies four per-tile LUTs and blends them bilinearly",
    "level_sweep": "no call runs the level sweep's warm starts, truncated Jacobi "
                   "passes and ring emits",
    "flood_bbox": "no call floods a seed's component and reduces its bbox",
    "propagate_rolls": "no call iterates a masked 4-neighbour min (max_pool2d "
                       "takes square windows)",
    "propagate_rolls_refine": "as at the sweep site",
    "propagate_scan": "no call runs segmented run-min scans",
    "level_sweep_full": "as K3",
    "flood_bbox_recognition": "as at the detection path",
    "propagate_rolls_recognition": "as at the recall config's call",
    "propagate_rolls_lda": "as at the recall config's call",
}


def _k1_library(x: torch.Tensor, tiles: int = 8):
    """``torch.bincount`` over a precomputed (frame, tile, value) index: the
    same histograms as K1 in one library call."""
    b, h, w = x.shape
    tile_y = torch.arange(h, device=x.device) // (h // tiles)
    tile_x = torch.arange(w, device=x.device) // (w // tiles)
    tile = (tile_y[:, None] * tiles + tile_x[None, :])[None]
    frame = torch.arange(b, device=x.device)[:, None, None]
    idx = ((frame * tiles * tiles + tile) * 256 + x.long()).reshape(-1)
    return lambda: torch.bincount(idx, minlength=b * tiles * tiles * 256)


def _measure(name: str, kern, plain, a: tuple, kw: dict, src: str, replaces: str,
             smi: str, kind: str | None = None) -> dict:
    """Phase 3 for one kernel at one call's inputs: the kernel against its
    plain version (exact), its single-call and queued ms, the plain ms, the
    bound and the library call where there is one; -> its table row (0
    launches until its path has run).  ``kind``: the kernel's launch
    counter, where ``name`` labels one more call site or shape of it."""
    from opencv_traffic_sign_detector_tpu_torch.ops import prop_cuda

    kind = kind or name
    got = kern(*a, **kw)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*a, **kw)
    end.record()
    torch.cuda.synchronize()
    plain_once = start.elapsed_time(end)
    _require(got.shape == want.shape and got.dtype == want.dtype,
             f"{name}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    # K5's one-launch forms stop at their fixed points: the bound counts the
    # passes these keys need
    form = prop_cuda.rolls_form(*a[0].shape[1:]) if kind.startswith("propagate_rolls") else None
    need = _passes_to_rest(*a) if form not in (None, "tiled") else None
    bound_ms, bound_by, nbytes, ops = _bound(kind, a, got, need)
    library_ms = None
    if kind == "tile_histograms":
        lib = _k1_library(*a)
        _require(torch.equal(lib().to(torch.int32).reshape(got.shape), got),
                 "K1: torch.bincount differs")
        library_ms = _time_ms(lib)
    del got, want
    shapes = [tuple(x.shape) for x in a if isinstance(x, torch.Tensor)]
    ms = _time_ms(lambda: kern(*a, **kw))
    queued_ms = _queued_ms(lambda: kern(*a, **kw))
    # a plain version of 300 ms a call or more (the sweeps') is timed on its
    # one checking call
    slow = plain_once >= PLAIN_ONCE_MS
    plain_ms = plain_once if slow else _time_ms(lambda: plain(*a, **kw))
    library = (f"library {library_ms:.3f} ms (torch.bincount)" if library_ms is not None
               else f"library none ({NO_LIBRARY.get(name) or NO_LIBRARY[kind]})")
    old = OLD_DESIGN.get(name)
    if form == "tiled":
        # ceil(passes / span) CUDA launches a call
        spans = prop_cuda.rolls_spans(a[3])
        core = prop_cuda.rolls_tiles(*a[0].shape[1:], spans[0])
        shapes.append(f"tiled form, {a[3]} passes in {len(spans)} CUDA launch(es) of spans "
                      f"{spans}, core {core[0]}x{core[1]}")
    elif form is not None:
        shapes.append(f"{form} form, one CUDA launch")
    if need is not None:
        shapes.append(_need_note(need, a[3]))
    print(f"[kernel] {name}: inputs {shapes} -> exact required, max_abs_err {err}; "
          f"kernel {ms:.4f} ms (queued behind a spin {queued_ms:.4f} ms)"
          + (f" ({old[0]} {old[1]:.3f} ms, recorded)" if old else "")
          + f" plain {plain_ms:.3f} ms{' (one call)' if slow else ''}; "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes} bytes, {ops} operations); {library}; {smi}")
    _require(err == 0, f"{name}: kernel differs from its plain version")
    _require(min(ms, queued_ms) >= bound_ms, f"{name}: {min(ms, queued_ms):.4f} ms reads "
             f"under its bound of {bound_ms:.4f} ms: the bound's count is at fault")
    return {"name": name, "route": "cuda",
            "source": f"opencv_traffic_sign_detector_tpu_torch/{src}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "queued_ms": queued_ms}


def _device_phase() -> tuple[str, str]:
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
    return name, smi.splitlines()[0]


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


def _stage_sum(ms: dict[str, float]) -> float:
    """A stage timer's ms a batch over its outer stages: a ``classify.*``
    stage lies inside ``classify``."""
    return sum(v for k, v in ms.items() if "." not in k)


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


def _queued_ms(fn, runs: int = 10) -> float:
    """Ms of one call of ``fn`` with the host's launch overhead left out:
    the median of ``runs`` runs of 10 calls (1 where a call takes 2 ms or
    more), queued behind a spin of the card that outlasts their enqueueing."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = 10 if time.perf_counter() - t0 < 2e-3 else 1
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin = int((time.perf_counter() - t0) * 4e9) + 200_000  # cycles, > the enqueue time
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def _recording(calls, mod, attr, key):
    """Context: wrap ``mod.attr`` so that every call's arguments are kept
    in ``calls[key(args, kwargs)]``."""
    orig = getattr(mod, attr)

    def wrapped(*a, **kw):
        calls[key(a, kw)].append((a, kw))
        return orig(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        setattr(mod, attr, wrapped)
        try:
            yield
        finally:
            setattr(mod, attr, orig)

    return ctx()


def _run_path(rt, label, fn):
    """Run one path with every launch count set to 0 just before it; return
    its result and the counts read just after."""
    rt.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = rt.launch_counts()
    print(f"[launches] {label}: {counts}")
    return out, counts


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _cuda_trace(fn, want=None, tries: int = 3) -> list:
    """The CUDA events (kernels and copies) of one call of ``fn`` under
    ``torch.profiler``.  On the H100 the profiler drops records of a trace,
    more of them the longer the process has run under load (a trace of one
    ``tile_luts`` call here reads its one kernel or none), and never adds
    one.  So up to ``tries`` calls are traced: the first whose events satisfy
    ``want`` is returned, else the fullest.  A count that must be exact is
    taken from the wrappers' launch counts, not from a trace."""
    from torch.profiler import ProfilerActivity, profile

    best: list = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if want is not None and want(ev):
            return ev
        best = max(best, ev, key=len)
    return best


def _need_note(need: torch.Tensor, passes: int) -> str:
    return (f"passes the data needs, a plane: mean {need.float().mean().item():.2f}, min "
            f"{int(need.min())}, max {int(need.max())} of {passes}; "
            f"{int((need <= 1).sum())} planes at rest after one")


def _edge_mask(shape, density: float, gen) -> torch.Tensor:
    """A random mask with every other pixel of all four edges on: the
    wraparound then carries keys across."""
    mask = torch.rand(shape, generator=gen, device=gen.device) < density
    mask[:, 0, ::2] = mask[:, -1, ::2] = mask[:, ::2, 0] = mask[:, ::2, -1] = True
    return mask


def _distinct_keys(shape, gen) -> torch.Tensor:
    """Random int32 keys, a permutation of 0 .. H*W-1 a plane: the flood of
    a plane's one least key is the last to come to rest."""
    order = torch.rand(shape, generator=gen, device=gen.device).flatten(1).argsort(1)
    return order.to(torch.int32).reshape(shape)


def _serpentine(n: int, dev) -> torch.Tensor:
    """A one-pixel path through every other row of an n x n plane, joined at
    alternating ends: a flood from its head needs its length in passes."""
    snake = torch.zeros((n, n), dtype=torch.bool, device=dev)
    snake[1:-1:2, 1:-1] = True
    for i, r in enumerate(range(2, n - 2, 2)):
        snake[r, n - 2 if i % 2 == 0 else 1] = True
    return snake


def _k5_all_passes(pc, refine_args: tuple, label: str, smi: str, gen) -> None:
    """Phase 3, a register form of K5 where no early stop fires: the refine
    call's shape and passes on distinct random keys.  At 128 px a mask of
    density 0.9 that wraps: a plane's least key is still on its way, up to
    128 pixels round the torus, when the passes are up.  At 64 px the torus
    is too small for that, so the mask is a serpentine: the path's least key
    is hundreds of pixels from one of its ends."""
    keys0, _, big, passes = refine_args
    keys = _distinct_keys(keys0.shape, gen)
    p, side = keys0.shape[0], keys0.shape[-1]
    if side == 128:
        mask, what = _edge_mask(keys0.shape, 0.9, gen), "mask density 0.9 on all four edges"
    else:
        mask, what = _serpentine(side, keys.device).expand(p, side, side).contiguous(), "serpentine"
    got = pc.propagate_rolls(keys, mask, big, passes)
    same = torch.equal(got, pc.propagate_rolls_plain(keys, mask, big, passes))
    need = _passes_to_rest(keys, mask, big, passes)
    bound_ms, bound_by, nbytes, ops = _bound("propagate_rolls_refine", (keys, mask, big, passes),
                                             got, need)
    del got
    ms = _time_ms(lambda: pc.propagate_rolls(keys, mask, big, passes))
    queued_ms = _queued_ms(lambda: pc.propagate_rolls(keys, mask, big, passes))
    print(f"[kernel] {label}, no plane at rest: inputs {tuple(keys.shape)} distinct random keys, "
          f"{what}, {_need_note(need, passes)} -> equals plain {same}; kernel {ms:.4f} ms "
          f"(queued behind a spin {queued_ms:.4f} ms); bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes} bytes, {ops} operations); {smi}")
    _require(same, f"{label}: K5 on random keys differs from its plain version")
    _require(int(need.min()) == passes, f"{label}: K5 all-passes call, a plane came to rest")
    _require(min(ms, queued_ms) >= bound_ms, f"{label}: K5 all-passes call reads under its bound")


def _schedule(cfg) -> tuple[int, int]:
    """(d_idx, num_levels) of a config's level sweep (ops/mser.py)."""
    s = cfg.level_step if cfg.level_step > 0 else cfg.delta
    d_idx = max(1, round(cfg.delta / s))
    return d_idx, len(range(0, 256 + (d_idx + 1) * s + 1, s))


def _sweep_shapes(mc, captured: tuple, cfg) -> None:
    """Phase 4, K3 and K7 beyond the main path's shapes, on planes cut from
    the tuned path's windows: K7 byte for byte against its plain version,
    K3 against its plain version and against K7 folded (the two outputs of
    one kernel).  A width that is no multiple of the tile width, a plane
    smaller than one tile, a small ``max_area`` (dead marks), the
    ``ring3_step5`` config (6 passes a level, pool 2, 55 levels),
    ``ccl_iters`` 5 (10 passes a level: spans end inside levels), a plane of
    3 rows, and a strip halo (K3 only: K7 has no strips); then both
    kernels' refusal of planes too wide for their int16 bbox planes, and the
    scan-pass body's of rows wider than a block's shared memory holds and of
    windows with more bands than can be resident."""
    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig

    windows, params, _, _, nl, lbits = captured
    span = mc.SWEEP_SPAN
    side = mc.TILE_REGION - 2 * span
    ring3 = MSERConfig(delta=10, min_area=30, max_area=600, max_variation=0.8, level_step=5,
                       ccl_iters=3, ccl_jumps=0, topk_pool=2)
    cases = [  # label, windows, config, strip halo, what the tile plan must show
        ("ragged width", windows[:4, :, :101], cfg, 0, lambda r, w, th, tw: w % tw != 0),
        ("smaller than a tile", windows[:4, 150:150 + side // 2, 300:300 + side // 3], cfg, 0,
         lambda r, w, th, tw: r < side and w < side),
        ("dead marks (max_area 30)", windows[:4], dataclasses.replace(cfg, min_area=5, max_area=30),
         0, None),
        ("ring3_step5", windows[:4], ring3, 0, None),
        ("ccl_iters 5", windows[:4], dataclasses.replace(cfg, ccl_iters=5), 0, None),
        ("3 rows", windows[:4, 200:203], cfg, 0, lambda r, w, th, tw: th == 3),
        ("strip halo 8", windows[:4], cfg, 8, None),
    ]
    for label, win, c, halo, shows in cases:
        win = win.contiguous()
        r, w = win.shape[1:]
        d_idx, levels = _schedule(c)
        p = mc.SweepParams.from_config(c, d_idx)
        bits = mc.packing_bits(c.topk_pool, levels)[1]
        th, tw = mc.sweep_tiles(r, w)
        _require(shows is None or shows(r, w, th, tw), f"sweep {label}: tile {th}x{tw} on {r}x{w}")
        core = r - 2 * halo
        got = mc.level_sweep_windows(win, p, core, halo, levels, bits)
        checks = {"K3 equals plain": torch.equal(
            got, mc.level_sweep_windows_plain(win, p, core, halo, levels, bits))}
        if halo == 0:
            k7 = mc.fused_level_sweep_full(win, c, d_idx, levels)
            checks["K7 equals plain"] = torch.equal(
                k7, mc.fused_level_sweep_full_plain(win, c, d_idx, levels))
            fold = torch.zeros_like(got)
            for t in range(levels):
                fold = torch.maximum(fold, k7[:, t].to(torch.int32) * (1 << bits) + t)
            checks["K7 folded equals K3"] = torch.equal(fold, got)
        print(f"[kernel K3/K7 {label}] windows {tuple(win.shape)}, {levels} levels of "
              f"{p.num_passes} passes, span {span}, tile {th}x{tw}, max_area {p.max_area:g}: "
              + ", ".join(f"{k} {v}" for k, v in checks.items())
              + f"{' (K7 has no strips)' if halo else ''}; candidate pixels "
              f"{int((got >> bits > 0).sum())}")
        _require(all(checks.values()),
                 f"sweep {label}: K3 or K7 differs from its plain version, or K7 folded from K3")
    wide = torch.zeros((1, 4, 1 << 15), dtype=torch.uint8, device=windows.device)
    refused = []
    for name, call in (("K3", lambda: mc.level_sweep_windows(wide, params, 4, 0, nl, lbits)),
                       ("K7", lambda: mc.fused_level_sweep_full(wide, cfg, params.d, nl))):
        try:
            call()
        except ValueError:
            refused.append(name)
    print(f"[kernel K3/K7 int16] windows {tuple(wide.shape)} refused by {refused}")
    _require(refused == ["K3", "K7"], "K3 or K7 took windows wider than its int16 bbox planes")
    # the scan-pass body: a window row must fit one block's shared memory,
    # and a window's bands must all be resident (ops/mser_cuda.py: scan_plan)
    sms, smem = mc.scan_device(windows.device)
    widest = (smem - mc.SCAN_ROW_EXTRA) // mc.SCAN_ROW_BYTES
    tallest = sms * (smem // (mc.SCAN_ROW_BYTES * 684 + mc.SCAN_ROW_EXTRA))
    scan_cfg = dataclasses.replace(cfg, scan_passes=2)
    scan_params = dataclasses.replace(params, scan_passes=2)
    for label, shape in (("width", (1, 4, widest + 1)), ("height", (1, tallest + 1, 684))):
        big = torch.zeros(shape, dtype=torch.uint8, device=windows.device)
        refused = []
        for name, call in (("K3", lambda: mc.level_sweep_windows(big, scan_params, shape[1], 0,
                                                                 nl, lbits)),
                           ("K7", lambda: mc.fused_level_sweep_full(big, scan_cfg, params.d, nl))):
            try:
                call()
            except ValueError:
                refused.append(name)
        print(f"[kernel K3/K7 scan {label}] windows {shape} refused by {refused} (the plan "
              f"holds rows of up to {widest} columns, windows of up to {tallest} rows of 684 "
              f"on {sms} SMs of {smem} bytes)")
        _require(refused == ["K3", "K7"], f"the scan-pass body took windows past its plan's "
                                          f"{label}")


# The sweep's other two bodies, K3's and K7's forms of each
SWEEP_BODIES = {"extent": {"extent_only": True}, "scan": {"scan_passes": 2},
                "combined": {"extent_only": True, "scan_passes": 2}}
MSER_PALLAS = "opencv_traffic_sign_detector_tpu/ops/mser_pallas.py"


def _body_config(cfg, change: dict):
    """An MSER config with one of :data:`SWEEP_BODIES`' changes."""
    return dataclasses.replace(cfg, sweep_extent_only=change.get("extent_only", False),
                               scan_passes=change.get("scan_passes", 0))


def _sweep_bodies(mc, k3_args: tuple, k7_args: tuple, smi: str) -> list[dict]:
    """Phase 3 for the extent-only, scan-pass (2 passes) and combined bodies
    of K3 and K7 at the tuned path's shapes (its [64, 408, 684] windows and
    [64, 402, 682] planes): each exact against its plain version, timed
    (one call and queued) and bounded, and one scan-pass K3 call in a
    profiler trace with its plan and timed by passes (:func:`_scan_split`).
    -> the table rows
    of the first two (the combined form's line is printed only)."""
    windows, params, core, halo, nl, lbits = k3_args
    im2, cfg, d_idx, nl7 = k7_args
    rows = []
    for tag, change in SWEEP_BODIES.items():
        k3 = _measure(f"level_sweep_{tag}", mc.level_sweep_windows, mc.level_sweep_windows_plain,
                      (windows, dataclasses.replace(params, **change), core, halo, nl, lbits),
                      {}, "csrc/mser_sweep.cu", f"{MSER_PALLAS}:507", smi, kind="level_sweep")
        k7 = _measure(f"level_sweep_full_{tag}", mc.fused_level_sweep_full,
                      mc.fused_level_sweep_full_plain, (im2, _body_config(cfg, change), d_idx, nl7),
                      {}, "csrc/mser_sweep.cu", f"{MSER_PALLAS}:569", smi,
                      kind="level_sweep_full")
        if tag == "scan":
            p = dataclasses.replace(params, **change)
            _scan_split(mc, k3_args, p, "level_sweep_scan", smi)
        if tag != "combined":
            rows += [k3, k7]
    return rows


def _scan_split(mc, k3_args: tuple, p, label: str, smi: str) -> None:
    """One call of the scan-pass body in a profiler trace (torch.profiler):
    its device time by kernel (the band kernel, one cooperative launch; the
    counters' memset) and the plan's waves, bands, shared memory and
    barriers; then the call timed at 1, 2 and 3 passes (CUDA events, median
    of 5), whose steps are a pass's cost: a row and a column resolve a
    level, with the column resolve's barrier."""
    windows, _, core, halo, nl, lbits = k3_args

    def call(passes=p.scan_passes):
        q = dataclasses.replace(p, scan_passes=passes)
        return mc.level_sweep_windows(windows, q, core, halo, nl, lbits)

    n, r, w = windows.shape
    plan = mc.scan_plan(n, r, w, *mc.scan_device(windows.device))
    call()
    torch.cuda.synchronize()
    split = defaultdict(lambda: [0.0, 0])
    for e in _cuda_trace(call, lambda ev: any("scan_band_kernel" in e.name for e in ev)):
        kind = "scan_band_kernel" if "scan_band_kernel" in e.name else e.name[:40]
        split[kind][0] += e.device_time / 1e3
        split[kind][1] += 1
    launches = split["scan_band_kernel"][1]
    print(f"[kernel] {label}, one call's device time (torch.profiler): "
          + ", ".join(f"{k} {ms:.3f} ms in {n_} launch(es)"
                      for k, (ms, n_) in sorted(split.items()))
          + f"; plan: bands of {plan.rows} rows, {plan.bands} a window, {plan.slots} windows a "
          f"wave, {plan.waves} waves, {plan.grid} blocks of {mc.SCAN_THREADS} threads, "
          f"{plan.smem_bytes} bytes of shared memory a block, {plan.summary_bytes} bytes of "
          f"counters and summaries, {plan.waves * nl * p.scan_passes} barriers a "
          f"window slot a call; {smi}")
    _require(launches == 1, f"{label}: {launches} band kernel launches in one call, not 1")
    ms = {k: _time_ms(lambda k=k: call(k), runs=5) for k in (1, 2, 3)}
    print(f"[kernel] {label} by passes: "
          + ", ".join(f"{k} pass(es) {t:.4f} ms" for k, t in ms.items())
          + f"; a pass (a row and a column resolve a level, {plan.waves * nl} barriers a slot) "
          f"{ms[2] - ms[1]:.4f} and {ms[3] - ms[2]:.4f} ms; at {p.scan_passes} passes the rest "
          f"(warm starts, last row resolves, emits) "
          f"{ms[2] - (ms[3] - ms[1]):.4f} ms; {smi}")


def _scan_bands(mc, captured: tuple, cfg) -> None:
    """Phase 4, the scan-pass body under plans forced by a smaller card
    (``scan_device`` patched): bands of 1, 2 and 7 rows, one window a wave,
    and bands of 3 rows two windows a wave over several waves, on planes of
    dark blobs of 8x8 over noise with a 255 border (runs across bands, the
    border joining the mask at the top levels) and on one without a border
    whose dark band crosses columns w - 1 -> 0.  K3 (with a strip halo too)
    and K7 against their plain versions, 2 passes, with and without
    extent-only, at areas of 5 to 200: candidates and dead marks on planes
    this small, and every case must have candidates."""
    import numpy as np

    windows, params, _, _, nl, lbits = captured
    dev = windows.device
    rng = np.random.default_rng(14)
    noise = rng.integers(0, 256, (3, 37, 70))
    blobs = np.kron(rng.integers(0, 256, (3, 5, 9)), np.ones((1, 8, 8), np.int64))[:, :37, :70]
    blobs = np.pad(np.minimum(noise, blobs), ((0, 0), (1, 1), (1, 1)), constant_values=255)
    seam = rng.integers(100, 256, (2, 41, 53))
    seam[:, 5:30, 45:] = 10
    seam[:, 5:30, :6] = 12
    seam[:, 1] = 3
    seam[:, -2] = 4
    seam[:, :, 20] = 30
    planes = {name: torch.from_numpy(a.astype(np.uint8)).to(dev)
              for name, a in (("blobs", blobs), ("seam", seam))}
    small = dataclasses.replace(cfg, min_area=5, max_area=200)
    real = mc.scan_device
    try:
        for label, win in planes.items():
            n, r, w = win.shape
            row_bytes = mc.SCAN_ROW_BYTES * w + mc.SCAN_ROW_EXTRA
            forced = [(-(-r // k), k * row_bytes) for k in (1, 2, 7)]
            forced.append((2 * -(-r // 3), 3 * row_bytes))
            for body in ({"scan_passes": 2}, {"scan_passes": 2, "extent_only": True}):
                k7_cfg = _body_config(small, body)
                p = mc.SweepParams.from_config(k7_cfg, params.d)
                want = {halo: mc.level_sweep_windows_plain(win, p, r - 2 * halo, halo, nl, lbits)
                        for halo in (0, 4)}
                want7 = mc.fused_level_sweep_full_plain(win, k7_cfg, params.d, nl)
                cands = int((want7 > 0).sum())
                _require(cands > 0, f"scan bands {label}: no candidates to compare")
                for lim in forced:
                    mc.scan_device = lambda device, lim=lim: lim
                    plan = mc.scan_plan(n, r, w, *lim)
                    ok = all(torch.equal(mc.level_sweep_windows(win, p, r - 2 * halo, halo, nl,
                                                                lbits), want[halo])
                             for halo in (0, 4))
                    ok7 = torch.equal(mc.fused_level_sweep_full(win, k7_cfg, params.d, nl), want7)
                    print(f"[kernel K3/K7 scan bands] {label} {tuple(win.shape)}, "
                          f"extent_only {p.extent_only}: bands of {plan.rows} rows, "
                          f"{plan.bands} a window, {plan.slots} a wave, {plan.waves} waves: "
                          f"K3 equals plain {ok}, K7 equals plain {ok7}; candidate pixel-levels "
                          f"{cands}")
                    _require(ok and ok7, f"scan bands {label}: K3 or K7 differs from its "
                                         f"plain version under plan {plan}")
    finally:
        mc.scan_device = real


def _body_fold(mc, k3_args: tuple, k7_cfg, d_idx: int, tag: str) -> None:
    """Phase 4: K7 folded equals K3 on the tuned windows in one body."""
    windows, params, core, halo, nl, lbits = k3_args
    change = SWEEP_BODIES[tag]
    k3 = mc.level_sweep_windows(windows, dataclasses.replace(params, **change), core, halo, nl,
                                lbits)
    k7 = mc.fused_level_sweep_full(windows, _body_config(k7_cfg, change), d_idx, nl)
    fold = torch.zeros_like(k3)
    for t in range(nl):
        fold = torch.maximum(fold, k7[:, t].to(torch.int32) * (1 << lbits) + t)
    ok = torch.equal(fold, k3)
    print(f"[identity] K7 fold == K3, {tag} body, on {tuple(windows.shape)} windows, "
          f"{nl} levels: {ok}; candidate pixels {int((k3 >> lbits > 0).sum())}")
    _require(ok, f"K7 folded differs from K3 in the {tag} body")


def _scan_strips(mc, mser, enhance_contrast, make_frames_with_boxes, base, dev, seed: int,
                 smi: str) -> None:
    """Phase 4, the scan-pass body (2 passes) on a 2-strip ``--downscale 1``
    window set: 4 frames of 1024x1360 at native resolution, whose padded
    1026 rows take 2 strips of 808 rows (core 616, halo 96) at 1364 columns.
    K3 against its plain version, timed and bounded; a run reduce must not
    see the next strip."""
    frames, _ = make_frames_with_boxes(4, 1024, 1360, seed=seed + 9)
    im2 = mser.pad_pol(enhance_contrast(torch.from_numpy(frames).to(dev)))
    im2 = im2.reshape(8, 1026, 1362).contiguous()
    cfg = dataclasses.replace(base, downscale=1, ccl_iters=2, level_step=9, ccl_jumps=0,
                              scan_passes=2)
    d_idx, nl = _schedule(cfg)
    calls = defaultdict(list)
    with _recording(calls, mc, "level_sweep_windows", lambda a, kw: "k3"):
        mc.fused_level_sweep(im2, cfg, d_idx, nl)
    a = calls["k3"][0][0]
    windows, _, core, halo, _, _ = a
    _require(windows.shape[0] == 16 and halo > 0 and windows.shape[2] == 1364,
             f"the downscale-1 set is not 2 strips of 1364 columns: {tuple(windows.shape)}, "
             f"core {core}, halo {halo}")
    _measure("level_sweep_scan_strips", mc.level_sweep_windows, mc.level_sweep_windows_plain,
             a, {}, "csrc/mser_sweep.cu", f"{MSER_PALLAS}:507", smi, kind="level_sweep")


def _ptxas_kernels(report: str, kernel: str) -> dict[str, str]:
    """Registers and spills of each entry function whose name holds
    ``kernel``, from nvcc's ``-Xptxas -v`` report."""
    found, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
        elif name and ("spill" in line or "registers" in line):
            found[name] = f"{found.get(name, '')} {line.split(':', 1)[-1].strip()}".strip()
    return found


def _sass_minmax(lib, kernel: str) -> dict[str, dict[str, int]]:
    """The integer minimum and maximum instructions (``VIMNMX`` and the
    3-input ``VIMNMX3``, with their 16x2 forms) in the SASS of each entry
    function whose name holds ``kernel``, from ``cuobjdump -sass`` of the
    built library: what ``SWEEP_OPS`` and ``ROLLS_OPS`` count a pass."""
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import find_nvcc

    sass = subprocess.run([os.path.join(os.path.dirname(find_nvcc()), "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name, code = body.split("\n", 1)
        if kernel in name:
            ops = re.findall(r"\bVIMNMX3?(?:\.S16x2)?\b", code)
            found[name.strip()] = {op: ops.count(op) for op in sorted(set(ops))}
    return found


def _k4_candidates(planes: torch.Tensor, wh: int, ww: int, n: int, gen) -> torch.Tensor:
    """Random [n, 6] candidates on ``planes``: origins up to 20 pixels past
    every edge (clamped by the kernel), levels 0-59 above the seed's pixel;
    every 16th seed on the unmasked ring, every 16th above its level, and
    every 16th with level 255 (the whole inner window)."""
    p, h, w = planes.shape

    def r(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=planes.device)

    plane, y0, x0 = r(0, p), r(-20, h - wh + 21), r(-20, w - ww + 21)
    sy, sx = r(1, wh - 1), r(1, ww - 1)
    pix = planes[plane, y0.clamp(0, h - wh) + sy, x0.clamp(0, w - ww) + sx].int()
    level = pix + r(0, 60)
    sy[0::16] = 0
    level[1::16] = pix[1::16] - 1
    level[2::16] = 255
    return torch.stack([plane, y0, x0, sy, sx, level], 1).to(torch.int32).contiguous()


def _k4_shapes(pc, planes: torch.Tensor, cand: torch.Tensor, big: int, gen) -> None:
    """Phase 4, K4 beyond the main path's shapes, each exact against its
    plain version and against bbox(K6 == 0): the main windows at passes 0,
    1 and 3; 37x100 windows (neither a multiple of 32) on small planes with
    clamped origins, empty and whole-window components; the main windows
    with their origins pushed past each of the four plane edges."""
    small = planes[:, 200:260, 300:450].contiguous()
    edge = cand.clone()
    edge[0::4, 1], edge[1::4, 1], edge[2::4, 2], edge[3::4, 2] = -50, 1 << 20, -50, 1 << 20
    cases = [(f"main windows, passes {p}", planes, cand, 128, 128, p) for p in (0, 1, 3)]
    k4_small = _k4_candidates(small, 37, 100, 1024, gen)
    cases += [(f"37x100 windows, passes {p}", small, k4_small, 37, 100, p) for p in (1, 2)]
    cases += [("origins past the four edges", planes, edge, 128, 128, 2)]
    for label, pl, cd, wh, ww, passes in cases:
        b = wh * ww + 1 if pl is small else big
        got = pc.flood_bbox(pl, cd, wh, ww, passes, b)
        same = torch.equal(got, pc.flood_bbox_plain(pl, cd, wh, ww, passes, b))
        mask, seed = pc.candidate_windows(pl, cd, wh, ww)
        k6 = pc.propagate_scan(torch.where(seed, 0, b).to(torch.int32), mask, b, passes)
        k6_ok = torch.equal(pc.bbox_area(k6 == 0, b), got)
        area = got[:, 4]
        cross = sum(int(((got[:, 2] < e) & (got[:, 3] >= e)).sum()) for e in (32, 64, 96))
        full = int((area == (wh - 2) * (ww - 2)).sum())
        print(f"[kernel K4 {label}] {cd.shape[0]} windows of {wh}x{ww} on {tuple(pl.shape)}: "
              f"equals plain {same}, bbox(K6 == 0) {k6_ok}; empty {int((area == 0).sum())}, "
              f"whole inner window {full}, components across a 32-px word edge {cross}, "
              f"mean area {area.float().mean().item():.1f}")
        _require(same and k6_ok, f"K4 {label}: differs from its plain version or K6")
        if pl is small:
            _require(full > 0 and int((area == 0).sum()) > 0 and cross > 0,
                     f"K4 {label}: the candidates miss a case")


def _k2_shapes(cc, clahe_equalize, x: torch.Tensor, gen) -> None:
    """Phase 4, K2 beyond the main path's shapes, exact against its plain
    version on random frames and LUTs: odd tile heights (808 rows at 8
    tiles, 804 at 4) and a width whose rows are not 16-byte aligned
    (1352); then CLAHE of a cut of the main path's frames that needs the
    reflect pad, against the port's CPU path."""
    for h, w, tiles in [(808, 1352, 8), (808, 1352, 4), (804, 1352, 4)]:
        frames = torch.randint(0, 256, (4, h, w), generator=gen, device=x.device,
                               dtype=torch.uint8)
        luts = torch.randint(0, 256, (4, tiles, tiles, 256), generator=gen, device=x.device,
                             dtype=torch.uint8)
        same = torch.equal(cc.clahe_apply(frames, luts, tiles),
                           cc.clahe_apply_plain(frames, luts, tiles))
        pieces = cc.apply_plan(h, w, tiles)[0]
        print(f"[kernel K2 {h}x{w}, {tiles} tiles] tile {h // tiles}x{w // tiles}, "
              f"{len(pieces)} row pieces: equals plain {same}")
        _require(same, f"K2 {h}x{w} at {tiles} tiles differs from its plain version")
    cut = x[:4, :797, :1355].contiguous()
    same = torch.equal(clahe_equalize(cut).cpu(), clahe_equalize(cut.cpu()))
    print(f"[kernel K2 reflect pad] clahe_equalize of {tuple(cut.shape)} (padded to 800x1360) "
          f"equals the CPU path: {same}")
    _require(same, "K2 on a reflect-padded frame differs from the CPU path")


def _k5_shapes(pc, rt, gen) -> None:
    """Phase 4, K5 beyond its paths' shapes, each exact against its plain
    version on random keys under masks of density 0.1 and 0.9 that touch
    all four edges (the wraparound then carries keys across).  The tiled
    form: a plane narrower and a plane shorter than one region (the plane
    repeats inside it), sizes that are no multiple of a tile, 1 and 130
    planes (more than the card has SMs), at 0, 1, S-1, S, S+1 and 2S+3
    passes.  The register forms: 1, 133 and 300 planes of 128x128 and 1, 3,
    4 and 4097 planes of 64x64 at 0, 1, 2, 95 and 96 passes; per side, a seed flood along a serpentine, which needs
    more passes than it is given, so that a stop would show as a difference,
    and a sparse mask at rest after a few passes, which must take less than
    half the time of a dense one that needs many.  The resident form: planes
    smaller than a window, the LDA step's 98x98 among them, and the largest
    it takes, 160x161, beside the smallest tiled one, 161x161.  Each shape's
    form is :func:`rolls_form`'s and the library's."""
    dev = gen.device
    span = pc.ROLLS_SPAN
    big = 1 << 21
    form_of = rt.library().tsd_propagate_rolls_form
    tiled = (0, 1, span - 1, span, span + 1, 2 * span + 3)
    windows = (0, 1, 2, 95, 96)
    cases = [("tiled, narrower than a region", (2, 300, 100), tiled),
             ("tiled, shorter than a region", (2, 40, 700), tiled),
             ("tiled, ragged", (3, 131, 307), tiled), ("tiled, one plane", (1, 203, 202), tiled),
             ("tiled, 130 planes", (130, 170, 160), tiled),
             ("tiled, the smallest", (2, 161, 161), tiled)]
    cases += [("window", (planes, 128, 128), windows) for planes in (1, 133, 300)]
    cases += [("window64", (planes, 64, 64), windows) for planes in (1, 3, 4, 4097)]
    cases += [("resident", shape, (0, 1, 7, 96))
              for shape in ((64, 100, 128), (64, 37, 100), (8, 98, 98), (2, 160, 161))]
    for label, shape, passes_list in cases:
        _, h, w = shape
        form = pc.rolls_form(h, w)
        _require(label.split(",")[0] == form, f"K5 {label}: a {h}x{w} plane takes the {form} form")
        _require(pc.ROLLS_FORMS[form_of(h, w)] == form,
                 f"K5 {label}: rolls_form and the library disagree")
        results = []
        for i, passes in enumerate(passes_list):
            density = (0.1, 0.9)[i % 2]
            keys = torch.randint(-5, 1 << 20, shape, generator=gen, device=dev,
                                 dtype=torch.int32)
            mask = _edge_mask(shape, density, gen)
            got = pc.propagate_rolls(keys, mask, big, passes)
            want = pc.propagate_rolls_plain(keys, mask, big, passes)
            moved = int((want != torch.where(mask, keys, big)).sum())
            results.append((passes, density, torch.equal(got, want), moved))
        tiles = ""
        if form == "tiled":
            core = pc.rolls_tiles(h, w, span)
            tiles = (f", span {span}, core {core[0]}x{core[1]} of a "
                     f"{pc.ROLLS_REGION_H}x{pc.ROLLS_REGION_W} region")
        print(f"[kernel K5 {label}] planes {shape}{tiles}: equals plain at (passes, density, "
              f"equal, keys moved) {results}")
        _require(all(ok for _, _, ok, _ in results), f"K5 {label}: differs from its plain version")
        _require(all(moved > 0 for p_, _, _, moved in results if p_ > 0),
                 f"K5 {label}: a case moved no key")

    for side in (128, 64):
        form = pc.rolls_form(side, side)
        snake = _serpentine(side, dev)
        mask = snake.expand(133, side, side).contiguous()
        keys = torch.full((133, side, side), big, dtype=torch.int32, device=dev)
        keys[:, 1, 1] = 0
        same = torch.equal(pc.propagate_rolls(keys, mask, big, 96),
                           pc.propagate_rolls_plain(keys, mask, big, 96))
        need = _passes_to_rest(keys, mask, big, 96)
        print(f"[kernel K5 {form} form, serpentine] planes {tuple(keys.shape)}, a seed at the "
              f"head of a path of {int(snake.sum())} pixels, 96 passes: equals plain {same}; "
              f"{_need_note(need, 96)}")
        _require(same and int(need.min()) == 96, f"K5 {form} form: the serpentine flood stopped "
                 "early or differs from its plain version")

        # 8 blocks an SM at 128 px, one after the other; the refine's count at 64
        shape = (1056, 128, 128) if side == 128 else (4096, 64, 64)
        timed = {}
        for density in (0.1, 0.9):
            keys = _distinct_keys(shape, gen)
            mask = _edge_mask(shape, density, gen)
            same = torch.equal(pc.propagate_rolls(keys, mask, big, 96),
                               pc.propagate_rolls_plain(keys, mask, big, 96))
            need = _passes_to_rest(keys, mask, big, 96)
            ms = _queued_ms(lambda: pc.propagate_rolls(keys, mask, big, 96))
            timed[density] = (ms, int(need.max()), int(need.min()))
            print(f"[kernel K5 {form} form, early stop] planes {shape}, density {density}, 96 "
                  f"passes: equals plain {same}; {_need_note(need, 96)}; queued {ms:.4f} ms")
            _require(same, f"K5 {form} form differs from its plain version")
        # a dense 64-px torus is at rest within ~its 64-pixel radius, plus
        # detours: it needs many passes, not all 96
        _require(timed[0.1][1] < 96 and timed[0.9][2] >= (96 if side == 128 else 48),
                 f"K5 {form} form: the stop cases need other passes than meant: {timed}")
        _require(timed[0.1][0] < 0.5 * timed[0.9][0],
                 f"K5 {form} form: planes at rest took {timed[0.1][0]:.4f} ms, those that are "
                 f"not {timed[0.9][0]:.4f} ms: the early stop did not fire")


def _k6_shapes(pc, gen) -> None:
    """Phase 4, K6 beyond the refine windows' seed maps, each exact against
    its plain version: random int32 keys of both signs (a seed map's 0 and
    ``big`` would hide a scan that merges only equal keys) under masks of
    density 0.1, 0.5 and 0.9 with the border off, at passes 0 to 3, on
    planes of 128x128, 37x100, 3 rows, 3 columns and a width that is no
    multiple of a lane's 4 columns; and a mask of one run along a whole
    inner row and one along a whole inner column, the least key at the
    column's foot."""
    dev = gen.device
    big = (1 << 30) + 5
    for shape in ((133, 128, 128), (300, 37, 100), (64, 3, 128), (64, 128, 3), (64, 21, 67)):
        results = []
        for density in (0.1, 0.5, 0.9):
            keys = torch.randint(-(1 << 30), 1 << 30, shape, generator=gen, device=dev,
                                 dtype=torch.int32)
            mask = torch.rand(shape, generator=gen, device=dev) < density
            mask[:, 0] = mask[:, -1] = mask[:, :, 0] = mask[:, :, -1] = False
            for passes in range(4):
                got = pc.propagate_scan(keys, mask, big, passes)
                want = pc.propagate_scan_plain(keys, mask, big, passes)
                moved = int((want != torch.where(mask, keys, big)).sum())
                results.append((density, passes, torch.equal(got, want), moved))
        print(f"[kernel K6] planes {shape}, keys in +-2^30: equals plain at (density, passes, "
              f"equal, keys moved) {results}")
        _require(all(ok for *_, ok, _ in results), f"K6 {shape}: differs from its plain version")
        _require(any(moved > 0 for *_, moved in results), f"K6 {shape}: no case moved a key")
    shape = (8, 128, 128)
    mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    mask[:, 40, 1:-1] = mask[:, 1:-1, 77] = True
    keys = torch.randint(-(1 << 20), 1 << 20, shape, generator=gen, device=dev, dtype=torch.int32)
    keys[:, 126, 77] = -(1 << 21)
    results = []
    for passes in (0, 1):
        got = pc.propagate_scan(keys, mask, big, passes)
        same = torch.equal(got, pc.propagate_scan_plain(keys, mask, big, passes))
        results.append((passes, same, bool((got[mask] == -(1 << 21)).all())))
    print(f"[kernel K6 single runs] planes {shape}, one run along row 40 and one along column 77: "
          f"(passes, equals plain, the least key everywhere) {results}")
    _require(results == [(0, True, False), (1, True, True)], "K6 on single runs is wrong")


def _k1_shapes(cc, x: torch.Tensor, gen) -> None:
    """Phase 4, K1 and its LUT tail beyond the main path's frames, each exact
    against its plain version (K1 against ``torch.bincount`` too): 1, 4 and
    8 tiles; tile widths 170, 20 and 12 (a 16-pixel word across one and
    several tile columns); widths and a base address that are not 16-byte
    aligned; one and several pieces a tile row; a flat and a two-valued
    frame (every add on one or two addresses).  The LUT tail also at the
    clip rule's corners: flat tiles (excess near the tile's area), no
    excess (clip at the tile's area) and clip 1."""
    dev = x.device

    def rand(b, h, w):
        return torch.randint(0, 256, (b, h, w), generator=gen, device=dev, dtype=torch.uint8)

    flat = torch.full_like(x, 97)
    two = torch.where(torch.rand(x.shape, generator=gen, device=dev) < 0.5, 31, 200).to(torch.uint8)
    off = torch.empty(3 * 96 * 176 + 1, dtype=torch.uint8, device=dev)[1:]
    off.copy_(rand(3, 96, 176).reshape(-1))
    cases = [("main frames", x, 8), ("flat frame", flat, 8), ("two-valued frame", two, 8),
             ("4 tiles", rand(4, 800, 1360), 4), ("1 tile", rand(3, 100, 170), 1),
             ("tile width 20", rand(5, 64, 160), 8), ("tile width 12", rand(5, 48, 96), 8),
             ("width 1352, rows unaligned", rand(3, 808, 1352), 8),
             ("width 100, 4 tiles", rand(2, 40, 100), 4),
             ("width 184, a block a tile row", rand(32, 16, 184), 8),
             ("base address off by 1", off.view(3, 96, 176), 8)]
    for label, f, tiles in cases:
        b, h, w = f.shape
        area = (h // tiles) * (w // tiles)
        got = cc.tile_histograms(f, tiles)
        same = torch.equal(got, cc.tile_histograms_plain(f, tiles))
        lib = torch.equal(_k1_library(f, tiles)().to(torch.int32).reshape(got.shape), got)
        clips = [max(int(2.0 * area / 256.0), 1), area, 1]
        luts = [torch.equal(cc.tile_luts(f, c, area, tiles), cc.tile_luts_plain(f, c, area, tiles))
                for c in clips]
        excess = int((got - clips[0]).clamp(min=0).sum(-1).max())
        print(f"[kernel K1 {label}] frames {tuple(f.shape)}, {tiles} tiles of {h // tiles}x"
              f"{w // tiles}, {cc.hist_pieces(b, tiles, h // tiles)} piece(s) a tile row, base % 16 "
              f"= {f.data_ptr() % 16}: equals plain {same}, torch.bincount {lib}; LUTs equal "
              f"plain at clips {clips}: {luts} (largest excess {excess} of area {area})")
        _require(same and lib and all(luts), f"K1 {label}: differs from its plain version")


# the CNN detector's routes (phases 8-9 and the graph memory phase): label,
# checkpoint, --upscale, input, route function, what the route must show (the
# fused plan's t/a, or the resize pass), timed batches
CNN_ROUTES = [
    ("float bgr", "params.npz", 1.0, "bgr", "_detect", None, 3),
    ("float patches8", "params.npz", 1.0, "patches8", "_detect", None, 3),
    ("float yuv420", "params.npz", 1.0, "yuv420", "_detect", None, 3),
    ("float yuv420p", "params.npz", 1.0, "yuv420p", "_detect_yuv_patches", None, 3),
    ("float up1.6", "params.npz", 1.6, "bgr", "_detect_fused_upscaled", (8, 5), 3),
    ("float up1.412", "params.npz", 1.412, "bgr", "_detect_fused_upscaled", (24, 17), 3),
    ("float up1.3", "params.npz", 1.3, "bgr", "_detect_upscaled", "_upscale_axis", 3),
    ("float up0.9", "params.npz", 0.9, "bgr", "_detect_upscaled", "_dense_axis", 3),
    ("int8 bgr", "params_int8.npz", 1.0, "bgr", "_detect", None, 3),
    ("int8 up1.6", "params_int8.npz", 1.6, "bgr", "_detect_fused_upscaled", (8, 5), 3),
    ("slim bgr", "params_slim.npz", 1.0, "bgr", "_detect", None, 1),
    ("v3 params_v3 bgr", "params_v3.npz", 1.0, "bgr", "_detect", None, 1),
]


def _cnn_inputs(frames: "np.ndarray") -> dict:
    """BGR frames as each CNN route's input: bgr, patches8, tight yuv420
    planes and patchified yuv420p planes, made with numpy."""
    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import bgr_to_yuv420
    from opencv_traffic_sign_detector_tpu_torch.ops import yuv as tyuv

    b, h, w, _ = frames.shape
    patches = frames.reshape(b, h // 8, 8, w // 8, 24).transpose(0, 1, 3, 2, 4)
    inputs = {"bgr": frames, "patches8": np.ascontiguousarray(patches.reshape(
        b, h // 8, w // 8, 192)), "yuv420": bgr_to_yuv420(frames)}
    inputs["yuv420p"] = tyuv.patchify_yuv_planes(*inputs["yuv420"])
    return inputs


def _cnn_phases(rt, dev, frames: "np.ndarray", names: list[str], smi: str) -> None:
    """Phases 8-9: the CNN detector's routes on the card, each captured into
    a CUDA graph at its warm-up batch and replayed after it, then each
    against the port's CPU path."""
    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_quant as cq
    from opencv_traffic_sign_detector_tpu_torch.ops import upscale as ups
    from opencv_traffic_sign_detector_tpu_torch.ops.fused_upscale import find_plan
    from opencv_traffic_sign_detector_tpu_torch.ops import yuv as tyuv

    ck = "artifacts/cnn_detector/"
    b, h, w, _ = frames.shape
    inputs = _cnn_inputs(frames)
    routes = CNN_ROUTES
    route_fns = ("_detect", "_detect_upscaled", "_detect_fused_upscaled", "_detect_yuv_patches")

    def run(det, x, n=None):
        x = tuple(p[:n] for p in x) if isinstance(x, tuple) else x[:n]
        out = _cnn_run(det, x)
        return out, det.collect(out, names[:len(out[0])], (h, w))

    def spied(calls):
        stack = contextlib.ExitStack()
        for mod, attr in [*((cd, f) for f in route_fns), (cd, "yuv420_to_bgr"),
                          (ups, "_upscale_axis"), (ups, "_dense_axis")]:
            stack.enter_context(_recording(calls, mod, attr, lambda a, kw, k=attr: k))
        return stack

    # --- 8. every route on the card --------------------------------------
    card, outs = {}, {}
    for label, ckpt, upscale, fmt, fn, shows, timed in routes:
        det = cq.load_detector(ck + ckpt, upscale=upscale, device=dev)
        # the warm-up batch captures the route's graph: its route functions
        # run at the capture, and a replay runs none of them
        calls = defaultdict(list)
        with spied(calls), _dumped_graphs(), _graph_calls() as made:
            run(det, inputs[fmt])
        torch.cuda.synchronize()
        _require(len(made["captures"]) == 1 and not made["replays"],
                 f"{label}: the warm-up made {made}, not one capture")
        _cnn_graph_report(f"slice3 {label}", det.graphs)

        def timed_run():
            batch_s = []
            for _ in range(timed):
                t0 = time.perf_counter()
                out, dets = run(det, inputs[fmt])
                batch_s.append(time.perf_counter() - t0)
            return out, dets, batch_s

        replay_calls = defaultdict(list)
        with spied(replay_calls), _graph_calls() as made:
            (out, dets, batch_s), _ = _run_path(rt, f"slice3 {label}", timed_run)
        _require(made["replays"] == timed and not made["captures"]
                 and not any(replay_calls.values()),
                 f"{label}: {timed} timed batches made {made}, route calls "
                 f"{ {k: len(v) for k, v in replay_calls.items() if v} }; not {timed} replays")
        took = [f for f in route_fns if calls[f]]
        _require(fn in took and not set(took) - {fn, "_detect"},
                 f"{label}: took {took} at the capture, expected {fn}")
        _require(bool(calls["yuv420_to_bgr"]) == (fmt == "yuv420"),
                 f"{label}: yuv420_to_bgr calls {len(calls['yuv420_to_bgr'])}")
        if isinstance(shows, tuple):
            plan = calls[fn][-1][0][-1]
            _require((plan.t, plan.a) == shows, f"{label}: plan {plan}")
            shows = f"plan {plan.t}/{plan.a}, h_pad {plan.h_pad}, sb {plan.sb}"
        elif shows:
            passes = [k for k in ("_upscale_axis", "_dense_axis") if calls[k]]
            _require(passes == [shows], f"{label}: resize passes {passes}")
        del calls, replay_calls
        finite = all(torch.isfinite(t).all().item() for t in (out[0], out[2]))
        _require(finite and tuple(out[0].shape) == (b, det.cfg.max_detections, 4),
                 f"{label}: non-finite or misshapen outputs {tuple(out[0].shape)}")
        _require(all(1 <= d.class_id <= 6 and np.isfinite(d.score) and 0 <= d.x1 < d.x2 <= w - 1
                     and 0 <= d.y1 < d.y2 <= h - 1 for d in dets),
                 f"{label}: malformed detection records")
        fps = b / statistics.median(batch_s)
        print(f"[slice3 {label}] batch {b} of {w}x{h}: {fps:.2f} frames/s replayed (batch s "
              f"{', '.join(f'{s:.4f}' for s in batch_s)}); route {fn} at the capture"
              f"{f' ({shows})' if shows else ''}; detections {len(dets)}")
        card[label] = dets
        if label in ("float bgr", "float patches8"):
            outs[label] = tuple(t.clone() for t in out)   # kept past later dispatches
        _cnn_replay_vs_eager(f"slice3 {label}", det, inputs[fmt])
        _require_no_sync(f"slice3 {label}", lambda: _cnn_run(det, inputs[fmt]), iters=4)
        del det, out
    same = all(torch.equal(a, c) for a, c in zip(outs["float bgr"], outs["float patches8"]))
    planes = [torch.from_numpy(p).to(dev) for p in inputs["yuv420"]]
    planes_p = [torch.from_numpy(p).to(dev) for p in inputs["yuv420p"]]
    yuv_same = torch.equal(tyuv.yuv420_patches_to_bgr_patches8(*planes_p),
                           cd.patchify(tyuv.yuv420_to_bgr(*planes)))
    print(f"[slice3 identities] patches8 outputs == bgr outputs: {same}; yuv420p BGR "
          f"patches == patchified tight yuv420_to_bgr on {tuple(planes[0].shape)}: {yuv_same}")
    _require(same and yuv_same, "an identity between the CNN routes failed")
    del outs

    # --- 8b. replayed against eager in turns: float bgr at batch 32 and at
    # the server's batch 8, int8 at --upscale 1.6
    for label, ckpt, upscale, n in [("float bgr", "params.npz", 1.0, b),
                                    ("float bgr", "params.npz", 1.0, 8),
                                    ("int8 up1.6", "params_int8.npz", 1.6, b)]:
        _cnn_turns(label, cq.load_detector(ck + ckpt, upscale=upscale, device=dev),
                   frames[:n], names[:n], smi)

    # --- 9. each route against the port's CPU path -----------------------
    for label, ckpt, upscale, fmt, *_ in routes:
        n = 2 if label == "float bgr" else 1
        t0 = time.perf_counter()
        det = cq.load_detector(ck + ckpt, upscale=upscale, device="cpu")
        _, cpu = run(det, inputs[fmt], n)
        want = [d for d in card[label] if d.filename in names[:n]]
        bad = cd.unmatched_detections(want, cpu, 0.05, det.cfg.score_threshold)
        print(f"[slice3 {label} vs cpu] {n} frame(s) in {time.perf_counter() - t0:.1f} s: "
              f"card {len(want)} cpu {len(cpu)} detections, unmatched {len(bad)} "
              "(bound: class, 1 px, score 0.05)")
        _require(not bad, f"{label}: card and CPU detections differ: {bad}")
    q_card, _ = cq.load_quant_params(ck + "params_int8.npz", dev)
    q_cpu, _ = cq.load_quant_params(ck + "params_int8.npz", "cpu")
    one = torch.from_numpy(frames[:1])
    plan = find_plan(h, w, 1.6)
    for label, stem, bound in [
            ("int8 stem", lambda q, x: cq.requant(cq.stem_int8_acc(q, x), q["q0_mult"],
                                                 q["q0_bias"], q["a0_inv"]), 0.001),
            ("int8 fused 1.6 stem", lambda q, x: cq.fused_stem_int8(q, x, plan), 0.02)]:
        diff = (stem(q_card, one.to(dev)).cpu().to(torch.int16)
                - stem(q_cpu, one).to(torch.int16)).abs()
        share = (diff > 0).float().mean().item()
        print(f"[slice3 {label} vs cpu] activations {tuple(diff.shape)}: max |diff| "
              f"{diff.max().item()}, share differing {share:.6f} (bound: +-1 on <= {bound})")
        _require(diff.max().item() <= 1 and share <= bound, f"{label}: card vs CPU")
    yuv_card = tyuv.yuv420_to_bgr(*(p[:1] for p in planes)).cpu()
    yuv_cpu = tyuv.yuv420_to_bgr(*(torch.from_numpy(p[:1]) for p in inputs["yuv420"]))
    yp_card = tyuv.yuv420_patches_to_bgr_patches8(*(p[:1] for p in planes_p)).cpu()
    yp_cpu = tyuv.yuv420_patches_to_bgr_patches8(
        *(torch.from_numpy(p[:1]) for p in inputs["yuv420p"]))
    ok = torch.equal(yuv_card, yuv_cpu) and torch.equal(yp_card, yp_cpu)
    print(f"[slice3 yuv vs cpu] tight and patchified BGR bit-identical: {ok}")
    _require(ok, "the card's yuv BGR differs from the CPU's")


def _record_nth(mod, attr: str, n: int, kept: dict, key: str):
    """Context: wrap ``mod.attr`` so that the arguments of its ``n``-th call
    (0-based; the last one when there are fewer) are kept in ``kept[key]``,
    and no other call's."""
    orig = getattr(mod, attr)
    seen = [0]

    def wrapped(*a, **kw):
        if seen[0] <= n:
            kept[key] = (a, kw)
        seen[0] += 1
        return orig(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        setattr(mod, attr, wrapped)
        try:
            yield
        finally:
            setattr(mod, attr, orig)

    return ctx()


def _percentiles(lat: list[float]) -> str:
    """p50/p95/p99 with the server's own rule (serve_detection_torch.py)."""
    import serve_detection_torch as serve

    s = sorted(lat)
    return ", ".join(f"p{p} {serve._percentile(s, p):.1f}" for p in (50, 95, 99))


def _serve(rt, label: str, watch, out, argv: list[str]):
    """One ``serve_detection_torch.py --once`` drain of ``watch`` with every
    launch count set to 0 just before it; -> (JSONL records, the server's
    report line, counts, wall s)."""
    import serve_detection_torch as serve

    if out.exists():
        out.unlink()
    buf = io.StringIO()

    def go():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["--watch_dir", str(watch), "--once", "--out", str(out), *argv])
        return rc, time.perf_counter() - t0

    (rc, wall), counts = _run_path(rt, label, go)
    report = buf.getvalue().strip().splitlines()[-1]
    _require(rc == 0, f"{label}: exit code {rc}: {buf.getvalue()}")
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    return lines, report, counts, wall


def _jsonl_records(lines):
    from opencv_traffic_sign_detector_tpu_torch.data.gt import GroundTruthBox

    return [GroundTruthBox(filename=r["file"], x1=d["box"][0], y1=d["box"][1],
                           x2=d["box"][2], y2=d["box"][3], class_id=d["type"],
                           score=d["score"]) for r in lines for d in r["detections"]]


def _serve_phases(rt, dev, frames, work, smi: str) -> dict:
    """Phases 10-11: ``serve_detection_torch.py --once`` on 64 JPEG frames of
    1360x800 at its defaults (batch 8): MSER at the tuned ``--downscale 2``
    point with templates the port trained (K1 through its LUT tail, K2, K3
    and K4 must launch), then the CNN detector on bgr and yuv420 ingest;
    one well-formed JSONL line a frame, boxes inside the frame; frames/s
    and latency percentiles; then each against the port's CPU server on 2
    of the frames.  -> {path: (launch counts, batches)}."""
    import shutil

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.data.images import load_frames_batch
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import (
        write_frames,
        write_train_dir,
    )
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import (
        saved_meta,
        unmatched_detections,
    )
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import train_mean_masks
    from opencv_traffic_sign_detector_tpu_torch.runtime import loader

    t0 = time.perf_counter()
    watch, few = work / "serve", work / "serve_cpu"
    names = write_frames(str(watch), np.concatenate([frames, frames]))
    few.mkdir()
    for n in names[:2]:
        shutil.copy(watch / n, few / n)
    templates = work / "templates.npz"
    train_mean_masks(write_train_dir(str(work / "train_jpg"), seed=1), dev).save(str(templates))
    b, h, w, _ = frames.shape
    print(f"[serve] wrote {len(names)} JPEG frames of {w}x{h} and trained the templates "
          f"in {time.perf_counter() - t0:.1f} s")
    decode_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        load_frames_batch(str(watch), names[:8])
        decode_s.append(time.perf_counter() - t0)
    print(f"[serve decode] one batch of 8 JPEGs of {w}x{h} decoded on the host in "
          f"{statistics.median(decode_s) * 1e3:.1f} ms (median of 3; native loader "
          f"{'built' if loader.available() else 'unavailable, PIL'})")
    cnn = "artifacts/cnn_detector/params.npz"
    runs = [("serve MSER", ["--templates", str(templates)]),
            ("serve CNN bgr", ["--detector", "CNN", "--cnn_params", cnn]),
            ("serve CNN yuv420", ["--detector", "CNN", "--cnn_params", cnn,
                                  "--input_format", "yuv420"])]
    paths = {}
    for label, argv in runs:
        with _graph_calls() as made:
            lines, report, counts, wall = _serve(rt, label, watch, work / "card.jsonl", argv)
        _require([r["file"] for r in lines] == names,
                 f"{label}: {len(lines)} JSONL lines for {len(names)} frames")
        dets = _jsonl_records(lines)
        _require(all(set(r) == {"file", "latency_ms", "detections"} for r in lines)
                 and all(set(d) == {"box", "type", "score"} for r in lines
                         for d in r["detections"]), f"{label}: malformed JSONL")
        _require(all(1 <= d.class_id <= 6 and np.isfinite(d.score) and 0 <= d.x1 < d.x2 <= w - 1
                     and 0 <= d.y1 < d.y2 <= h - 1 for d in dets),
                 f"{label}: a detection outside the frame or malformed")
        batches = -(-len(names) // 8) + 1  # with the warm-up batch
        paths[label] = (counts, batches)
        print(f"[{label}] {len(names)} frames of {w}x{h} at batch 8, drained once: the "
              f"server's report: {report}; from the JSONL: latency ms "
              f"{_percentiles([r['latency_ms'] for r in lines])}; {len(dets)} detections; "
              f"{wall:.2f} s with start-up and warm-up; kernel launches a batch "
              f"{ {k: v / batches for k, v in counts.items() if v} }; {smi}")
        if label == "serve MSER":
            for name in ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox"):
                _require(counts[name] > 0, f"{label}: {name} never launched")
        else:
            _require(not any(counts.values()), f"{label} launched {counts}")
        # every batch replays a graph: the warm-up's bgr batch captures one,
        # the CNN's yuv420 ingest's first batch another (without the native
        # loader the yuv420 ingest decodes to bgr frames)
        planes = "yuv420" in argv and loader.available()
        print(f"[{label} graphs] {len(made['captures'])} capture(s) {made['captures']}, "
              f"{made['replays']} replay(s) for {batches} batches")
        _require(len(made["captures"]) + made["replays"] == batches
                 and len(made["captures"]) == (2 if planes else 1),
                 f"{label}: {batches} batches made {made}")
        # --- against the port's CPU server on 2 of the frames
        t0 = time.perf_counter()
        cpu, _, _, _ = _serve(rt, f"{label} on the CPU", few, work / "cpu.jsonl",
                              argv + ["--device", "cpu", "--batch", "2"])
        card = [r for r in lines if r["file"] in names[:2]]
        if label == "serve MSER":
            ok = ([{k: v for k, v in r.items() if k != "latency_ms"} for r in cpu]
                  == [{k: v for k, v in r.items() if k != "latency_ms"} for r in card])
            bound = "JSONL identical apart from latency_ms"
        else:
            thr = saved_meta(cnn)["score_threshold"]
            ok = not unmatched_detections(_jsonl_records(card), _jsonl_records(cpu), 0.05, thr)
            bound = "bound: class, 1 px, score 0.05"
        print(f"[{label} vs cpu] 2 frames in {time.perf_counter() - t0:.1f} s: card "
              f"{len(_jsonl_records(card))} cpu {len(_jsonl_records(cpu))} detections, "
              f"match {ok} ({bound})")
        _require(ok, f"{label}: card and CPU JSONL differ: {card} {cpu}")
    return paths


def _recognition_phases(rt, dev, work, smi: str, seed: int) -> tuple[list[dict], dict]:
    """Phases 12-13: práctica 2 on synthetic GTSDB-style frames of 1360x800.
    ``run_validation`` on a train directory with MSER proposals (the
    recognizer's default config: --downscale 1, pointer jumps, 384 regions)
    and HOG_LDA_BAYES; then ``RecognitionPipeline.run_directory`` over a
    test directory with ``artifacts/sign_classifier_r5_cnn/`` (K1 through
    its LUT tail, K2, K4 and K5 must launch), K4 and K5 held against their
    plain versions at the inputs this path gives them; then the CNN proposal
    source (the CLI's default) for mining, validation and inference; each
    against the port's CPU path on one frame.  -> (the two kernel rows,
    {path: (launch counts, batches)})."""
    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.config import (
        ClassifierConfig,
        MSERConfig,
        PipelineConfig,
    )
    from opencv_traffic_sign_detector_tpu_torch.data.images import (
        list_frame_files,
        load_frames_batch,
    )
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_gt_dir
    from opencv_traffic_sign_detector_tpu_torch.models import rec_pipeline as rp
    from opencv_traffic_sign_detector_tpu_torch.models import recognizer as rec
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import CNNDetector
    from opencv_traffic_sign_detector_tpu_torch.models.detector import upload
    from opencv_traffic_sign_detector_tpu_torch.ops import ccl, mser, prop_cuda

    t0 = time.perf_counter()
    train, test = str(work / "rec_train"), str(work / "rec_test")
    write_gt_dir(train, 12, 800, 1360, seed=seed + 11)
    write_gt_dir(test, 16, 800, 1360, seed=seed + 12)
    files = list_frame_files(test)
    first = load_frames_batch(test, files[:8])
    print(f"[recognition] wrote 12 train and 16 test frames of 1360x800 with gt.txt in "
          f"{time.perf_counter() - t0:.1f} s")
    mcfg = MSERConfig.from_string("MSER_7_200_2000_1")  # main_recognition.py's defaults
    cfg = PipelineConfig(mser=mcfg)
    clf = rec.SignClassifier.load("artifacts/sign_classifier_r5_cnn")
    paths = {}

    def validate(label, **kw):
        t0 = time.perf_counter()
        res, counts = _run_path(rt, label, lambda: rec.run_validation(
            train, mser_cfg=mcfg, clf_cfg=ClassifierConfig.from_string("HOG_LDA_BAYES"),
            device=dev, **kw))
        print(f"[{label}] 12 frames: validation accuracy {res.accuracy:.4f} on "
              f"{len(res.y_true)} held-out crops, confusion rows {res.confusion.tolist()}; "
              f"{time.perf_counter() - t0:.2f} s")
        return counts

    def infer(label, pipe):
        pipe.recognize_frames(first, files[:8])  # warm-up batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets, counts = _run_path(rt, label, lambda: pipe.run_directory(test))
        dt = time.perf_counter() - t0
        batches = -(-len(files) // cfg.batch_size)
        on_card = torch.from_numpy(first).to(dev)
        batch_ms = _time_ms(lambda: pipe.collect(pipe.dispatch(on_card), files[:8]), runs=5)
        _require(all(1 <= d.class_id <= 6 and np.isfinite(d.score) and 0 <= d.x1 < d.x2 <= 1360
                     and 0 <= d.y1 < d.y2 <= 800 for d in dets), f"{label}: malformed records")
        print(f"[{label}] {len(files)} frames of 1360x800 at batch {cfg.batch_size}: "
              f"{len(files) / dt:.2f} frames/s on the host's clock ({dt:.3f} s, decode "
              f"included); a batch from frames already on the card to records "
              f"{batch_ms:.2f} ms (median of 5); {len(dets)} recognitions; kernel launches a batch "
              f"{ {k: v / batches for k, v in counts.items() if v} }; {smi}")
        paths[label] = (counts, batches)
        _require_no_sync(label, lambda: pipe.dispatch(first))
        return dets, counts

    def vs_cpu(label, card_dets, pipe_cpu):
        t0 = time.perf_counter()
        cpu = pipe_cpu.recognize_frames(first[:1], files[:1])
        card = [d for d in card_dets if d.filename == files[0]]
        same = [(d.x1, d.y1, d.x2, d.y2, d.class_id) for d in cpu] == [
            (d.x1, d.y1, d.x2, d.y2, d.class_id) for d in card]
        err = max((abs(a.score - b.score) for a, b in zip(cpu, card)), default=0.0)
        print(f"[{label} vs cpu] 1 frame in {time.perf_counter() - t0:.1f} s: card {len(card)} "
              f"cpu {len(cpu)} recognitions, boxes and labels identical {same}, max score "
              f"difference {err:.2e} (bound 1e-4)")
        _require(same and err <= 1e-4, f"{label}: card and CPU differ: {card} {cpu}")

    # --- 12. MSER proposals ------------------------------------------------
    counts = validate("recognition validation, MSER proposals")
    for name in ("tile_luts", "clahe_apply", "flood_bbox", "propagate_rolls"):
        _require(counts[name] > 0, f"recognition validation: {name} never launched")
    pipe = rp.RecognitionPipeline(cfg=cfg, classifier=clf, device=dev)
    kept = {}
    # the first batch is the eager warm-up that captures the graph: the kept
    # calls are that run's
    with _record_nth(mser, "flood_bbox", 0, kept, "flood_bbox"), \
            _record_nth(ccl, "propagate_rolls", 40, kept, "propagate_rolls"), _dumped_graphs():
        pipe.recognize_frames(first, files[:8])
    torch.cuda.synchronize()
    want = ("tile_luts", "clahe_apply", "flood_bbox", "propagate_rolls")
    _graph_report("recognition MSER", pipe._recognize, want)
    _graph_kernel_names("recognition MSER", pipe._recognize, want)
    dets, counts = infer("recognition MSER", pipe)
    for name in want:
        _require(counts[name] > 0, f"recognition MSER: {name} never launched")
    _require(counts["level_sweep"] == 0, "recognition MSER launched the fused sweep K3")

    def eager(frames):
        with torch.inference_mode():
            return rp._pack(*rp.recognize_batch(upload(frames, dev), pipe._arrays,
                                                *pipe._spec())).cpu().numpy()

    _replay_vs_eager("recognition MSER", pipe.dispatch, eager, first)
    on_card = torch.from_numpy(first).to(dev)
    replay_ms = _time_ms(lambda: pipe.collect(pipe.dispatch(on_card), files[:8]), runs=5)
    eager_ms = _time_ms(lambda: eager(on_card), runs=5)
    print(f"[recognition MSER batch ms] a batch of 8 from frames on the card to its packed result "
          f"on the host, median of 5: graph replay {replay_ms:.2f} ms, eager {eager_ms:.2f} ms; "
          f"{smi}")
    pallas_prop = "opencv_traffic_sign_detector_tpu/ops/pallas_prop.py"
    rows = []
    for name, kern, plain, src, replaces, a in [
            ("flood_bbox_recognition", prop_cuda.flood_bbox, prop_cuda.flood_bbox_plain,
             "csrc/flood.cu", f"{pallas_prop}:234", kept["flood_bbox"][0]),
            ("propagate_rolls_recognition", prop_cuda.propagate_rolls,
             prop_cuda.propagate_rolls_plain, "csrc/prop_rolls.cu", f"{pallas_prop}:69",
             kept["propagate_rolls"][0][:4])]:
        row = _measure(name, kern, plain, a, {}, src, replaces, smi)
        row["launches"] = counts[name.rsplit("_", 1)[0]]
        rows.append(row)
    del kept
    t0 = time.perf_counter()
    on_card = [t.cpu() for t in rec.propose_batch(torch.from_numpy(first[:1]).to(dev), mcfg)]
    on_cpu = rec.propose_batch(torch.from_numpy(first[:1]), mcfg)
    same = all(torch.equal(a, b) for a, b in zip(on_card, on_cpu))
    print(f"[recognition MSER proposals vs cpu] 1 frame in {time.perf_counter() - t0:.1f} s: "
          f"boxes, crops and valid identical {same} ({int(on_cpu[2].sum())} valid)")
    _require(same, "recognition: MSER proposals on the card differ from the CPU path")
    vs_cpu("recognition MSER", dets,
           rp.RecognitionPipeline(cfg=cfg, classifier=clf, device="cpu"))

    # --- 13. CNN proposals (the CLI's default source) -----------------------
    def detector(device):
        d = CNNDetector.load("artifacts/cnn_detector/params.npz", device=device)
        d.cfg = dataclasses.replace(d.cfg, score_threshold=0.10)
        return d

    cnn = detector(dev)
    t0 = time.perf_counter()
    with _graph_calls() as made:
        props = rec.extract_train_proposals_cnn(train, cnn)
    print(f"[recognition CNN mining] {sum(len(b) for b, _ in props.values())} proposals over "
          f"12 frames in {time.perf_counter() - t0:.2f} s; the detector's dispatch at batch 8 "
          f"(the last batch padded to 8): {len(made['captures'])} graph capture(s) "
          f"{made['captures']}, {made['replays']} replay(s)")
    _require(len(made["captures"]) == 1 and made["replays"] == 1,
             f"CNN mining of 2 batches of one shape made {made}")
    validate("recognition validation, CNN proposals", proposals=props, proposal_positives=True)
    pipe = rp.RecognitionPipeline(cfg=cfg, classifier=clf, cnn=cnn)
    held = len(cnn.graphs.entries())
    # the first batch captures recognize_batch_cnn whole: one graph, and the
    # detector's route runs inside that capture, not as a graph of its own
    with _dumped_graphs(), _graph_calls() as made:
        pipe.recognize_frames(first, files[:8])
    torch.cuda.synchronize()
    _require(len(made["captures"]) == 1 and len(cnn.graphs.entries()) == held
             and len(pipe._recognize_cnn.entries()) == 1 and not pipe._recognize.entries(),
             f"recognition CNN: the first batch made {made}, detector graphs "
             f"{len(cnn.graphs.entries())} (held {held})")
    _cnn_graph_report("recognition CNN", pipe._recognize_cnn)
    dets, counts = infer("recognition CNN", pipe)
    _require(not any(counts.values()), f"recognition CNN launched {counts}")

    def eager_cnn(frames):
        with torch.inference_mode():
            return rp._pack(*rp.recognize_batch_cnn(upload(frames, dev), cnn, pipe._arrays,
                                                    *pipe._spec())).cpu().numpy()

    _replay_vs_eager("recognition CNN", pipe.dispatch, eager_cnn, first, control=True)
    on_card = torch.from_numpy(first).to(dev)
    replay_ms = _time_ms(lambda: pipe.collect(pipe.dispatch(on_card), files[:8]), runs=5)
    eager_ms = _time_ms(lambda: eager_cnn(on_card), runs=5)
    print(f"[recognition CNN batch ms] a batch of 8 from frames on the card to its packed result "
          f"on the host, median of 5: graph replay {replay_ms:.2f} ms, eager {eager_ms:.2f} ms; "
          f"{smi}")
    vs_cpu("recognition CNN", dets,
           rp.RecognitionPipeline(cfg=cfg, classifier=clf, cnn=detector("cpu")))
    return rows, paths


def _well_formed(dets, h: int, w: int) -> bool:
    return all(1 <= d.class_id <= 6 and 0 <= d.score <= 1 and 0 <= d.x1 < d.x2 <= w - 1
               and 0 <= d.y1 < d.y2 <= h - 1 for d in dets)


def _f32_step_vs_cpu(ct, cd, arch: str, data: dict, dev, seed: int) -> None:
    """Two f32 steps of ``arch`` (draws of steps 7 and 3, the optimizer's
    counts 0 and 1) from the same weights on the card and on the CPU, on the
    CPU's crops.  Held: the loss within 1e-5 relative; each gradient within
    1e-3 of its largest magnitude, not the CPU tests' 1e-4: the card sums
    the norms' fast variance ``E[x^2] - E[x]^2`` in another order, and where
    a channel's variance is small beside its mean the f32 cancellation
    reaches the gradients (7.3e-5 on slim's GroupNorm bias at step 7,
    3.67e-4 on v3's BatchNorm bias at step 3, H100, PERF.md); the running
    statistics within 1e-5; the parameters after the count-0 update (a
    learning rate of 0) equal; the card's crops of the same draws within
    +-1 on 0.1% of pixels, boxes within 1e-3 px, classes equal.  The
    parameters after the count-1 update are printed, not held: Adam divides
    each gradient by its own size, so an element whose gradient lies within
    that rounding moves by up to the learning rate on either side."""
    import copy

    cfg = ct.TrainConfig(batch_size=8, steps=10, warmup_steps=2, lr=1e-3, seed=seed)
    mcfg = cd.CNNDetectorConfig(arch=arch, dtype="float32")
    make = ct.SignCenterNetV3Train if arch == "v3" else cd.SignCenterNet
    cpu_model = cd.init_params(make(mcfg), seed)
    card_model = copy.deepcopy(cpu_model).to(dev)
    cpu_step, card_step = ct.TrainStep(cpu_model, cfg), ct.TrainStep(card_model, cfg)
    cpu_data = {k: torch.from_numpy(v) for k, v in data.items()}
    card_data = {k: v.to(dev) for k, v in cpu_data.items()}
    for step in (7, 3):
        t0 = time.perf_counter()
        count = int(cpu_step.count)
        draws = ct.sample_draws(ct.step_generator(seed, step, "cpu"), cfg.batch_size,
                                len(data["frames"]), len(data["pos"]), cfg)
        crops = ct.crops_from_draws(draws, cpu_data, cfg)
        card_crops = ct.crops_from_draws({k: v.to(dev) for k, v in draws.items()}, card_data, cfg)
        pix = (card_crops[0].cpu().to(torch.int16) - crops[0].to(torch.int16)).abs()
        pix_share = (pix > 0).float().mean().item()
        box_err = (card_crops[1].cpu() - crops[1]).abs().max().item()
        cls_same = torch.equal(card_crops[2].cpu(), crops[2])
        before = [p.detach().clone() for p in cpu_model.parameters()]
        got_cpu = cpu_step.update(*crops)
        got_card = card_step.update(*(c.to(dev) for c in crops))
        loss_cpu = got_cpu["loss"].item()
        loss_rel = abs(got_card["loss"].item() - loss_cpu) / abs(loss_cpu)
        grad_rel = {name: (pc.grad.cpu() - pg.grad).abs().max().item()
                    / max(pg.grad.abs().max().item(), 1e-30)
                    for (name, pg), pc in zip(cpu_model.named_parameters(),
                                              card_model.parameters())}
        worst = max(grad_rel, key=grad_rel.get)
        param_err = max((c.cpu() - a).abs().max().item()
                        for a, c in zip(cpu_model.parameters(), card_model.parameters()))
        moved = max((a - b).abs().max().item() for a, b in zip(cpu_model.parameters(), before))
        stats_err = max([(c.cpu() - a).abs().max().item()
                         for a, c in zip(cpu_model.buffers(), card_model.buffers())], default=0.0)
        print(f"[train f32 card vs cpu] {arch}, step {step} (count {count}), batch "
              f"{cfg.batch_size}: loss card {got_card['loss'].item():.6f} cpu "
              f"{got_cpu['loss'].item():.6f} (rel {loss_rel:.3g}, bound 1e-5); grads max |diff| / "
              f"max |grad| {grad_rel[worst]:.3g} at {worst} (bound 1e-3); parameters after the "
              f"update max |diff| {param_err:.3g} (moved up to {moved:.3g}; held equal at count 0 "
              f"only), running statistics max |diff| {stats_err:.3g} (bound 1e-5); crops of the "
              f"same draws: max |pixel diff| {pix.max().item()}, share {pix_share:.6f} (bound +-1 "
              f"on 0.001), boxes {box_err:.3g} px, classes equal {cls_same}; "
              f"{time.perf_counter() - t0:.1f} s")
        _require(loss_rel <= 1e-5 and grad_rel[worst] <= 1e-3 and stats_err <= 1e-5
                 and (count > 0 or param_err == 0),
                 f"{arch}: the card's f32 train step differs from the CPU's")
        _require(pix.max().item() <= 1 and pix_share <= 1e-3 and box_err <= 1e-3 and cls_same,
                 f"{arch}: the card's crops differ from the CPU's")


def _copy_train_state(dst, src) -> None:
    """Make ``dst``'s parameters, running statistics, AdamW state and count
    ``src``'s, in place (two ``TrainStep`` of one model config)."""
    with torch.no_grad():
        for a, b in zip(dst.model.parameters(), src.model.parameters()):
            a.copy_(b)
            for k, v in src.opt.state[b].items():
                dst.opt.state[a][k].copy_(v)
        for a, b in zip(dst.model.buffers(), src.model.buffers()):
            a.copy_(b)
        dst.count.copy_(src.count)


def _step_gaps(r: dict, e: dict, with_grads: bool) -> tuple[dict, bool]:
    """The gaps of one step's snapshot ``r`` against ``e``
    (:func:`_train_replay_vs_eager`): the loss and parts' largest relative
    difference, the gradients' largest difference over their tensor's
    largest magnitude (``with_grads``: a capture computes none), the
    parameters' and statistics' largest differences; and whether every
    value was equal."""
    gaps = {"loss": max(abs(r["metrics"][k] - v) / abs(v) for k, v in e["metrics"].items()),
            "params": max(_gap(a, b) for a, b in zip(r["params"], e["params"])),
            "stats": max([0.0] + [_gap(a, b) for a, b in zip(r["stats"], e["stats"])])}
    keys = ("params", "stats")
    if with_grads:
        gaps["grads"] = max(_gap(a, b) / max(b.abs().max().item(), 1e-30)
                            for a, b in zip(r["grads"], e["grads"]))
        keys += ("grads",)
    equal = r["metrics"] == e["metrics"] and all(
        torch.equal(a, b) for key in keys for a, b in zip(r[key], e[key]))
    return gaps, equal


def _train_replay_vs_eager(ct, cd, arch: str, data: dict, dev, seed: int) -> None:
    """Five f32 steps of ``arch`` at :func:`_f32_step_vs_cpu`'s config (draws
    of steps 7, 3, 5, 9, 1: counts 0-4, over the warm-up of 2 and into the
    decay) from the same weights and data on the card, eager (a stage timer)
    and replayed from one CUDA graph (its first step the capture's eager
    warm-up), and a second eager side as a control.  Before each step after
    the first the eager sides take the replayed side's parameters,
    statistics and AdamW state, so that every step starts from one state:
    f32 convolutions on the card need not sum in one order from run to run,
    and Adam turns such a gradient's rounding into an update up to the
    learning rate apart, which the next steps carry.  Held: each step's
    draws and crops equal bit for bit (read through a spy on
    ``crops_from_draws``: a replay rewrites the tensors the capture made);
    the loss and its parts within 1e-5 relative, each gradient within 1e-3
    of its largest magnitude (from the first replay on), the running
    statistics within 1e-5 and the parameters after the count-0 update
    equal, :func:`_f32_step_vs_cpu`'s bounds.  The largest differences are
    printed, and the steps at which every value was equal, replay against
    eager and eager against eager."""
    import copy

    cfg = ct.TrainConfig(batch_size=8, steps=10, warmup_steps=2, lr=1e-3, seed=seed)
    make = ct.SignCenterNetV3Train if arch == "v3" else cd.SignCenterNet
    model = cd.init_params(make(cd.CNNDetectorConfig(arch=arch, dtype="float32")), seed).to(dev)
    card = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    # a dict each, the same tensors: the spy tells the sides apart by it
    sides = {"eager": (ct.TrainStep(copy.deepcopy(model), cfg, timer=_eager_timer), dict(card)),
             "control": (ct.TrainStep(copy.deepcopy(model), cfg, timer=_eager_timer), dict(card)),
             "replay": (ct.TrainStep(model, cfg), dict(card))}
    seen = defaultdict(list)
    orig = ct.crops_from_draws

    def spy(draws, d, c):
        out = orig(draws, d, c)
        seen[id(d)].append({**draws, "images": out[0], "boxes": out[1], "cls": out[2]})
        return out

    def snapshot(mode, metrics, first):
        step_fn, d = sides[mode]
        return {"metrics": {k: v.item() for k, v in metrics.items()},
                "sampled": {k: v.cpu() for k, v in seen[id(d)][0 if first else -1].items()},
                "grads": [p.grad.cpu() for p in step_fn.model.parameters()],
                "params": [p.detach().cpu() for p in step_fn.model.parameters()],
                "stats": [b.cpu() for b in step_fn.model.buffers()]}

    t0 = time.perf_counter()
    worst = defaultdict(float)
    equal = {"replay": [], "control": []}
    ct.crops_from_draws = spy
    try:
        for i, step in enumerate((7, 3, 5, 9, 1)):
            if i:
                for mode in ("eager", "control"):
                    _copy_train_state(sides[mode][0], sides["replay"][0])
            got = {mode: snapshot(mode, step_fn(d, step), mode == "replay" and i == 0)
                   for mode, (step_fn, d) in sides.items()}
            e = got["eager"]
            _require(all(torch.equal(got["replay"]["sampled"][k], v)
                         for k, v in e["sampled"].items()),
                     f"{arch}: the replayed step's draws or crops of step {step} differ from the "
                     "eager step's")
            for mode in equal:
                gaps, same = _step_gaps(got[mode], e, i > 0)
                if same:
                    equal[mode].append(step)
                if mode == "replay":
                    if i == 0:
                        worst["params at count 0"] = gaps["params"]
                    for k, v in gaps.items():
                        worst[k] = max(worst[k], v)
    finally:
        ct.crops_from_draws = orig
    print(f"[train replay vs eager] {arch} f32, batch {cfg.batch_size}, steps 7, 3, 5, 9, 1 "
          f"(counts 0-4, warm-up {cfg.warmup_steps}), each step from one state, the replayed "
          f"step against the eager one: draws and crops equal bit for bit; loss and parts max "
          f"rel {worst['loss']:.3g} (bound 1e-5); grads max |diff| / max |grad| "
          f"{worst['grads']:.3g} (bound 1e-3, replays only); parameters after the update max "
          f"|diff| {worst['params']:.3g} (count 0: {worst['params at count 0']:.3g}, held "
          f"equal); running statistics {worst['stats']:.3g} (bound 1e-5); the steps where every "
          f"value was equal: replay against eager {equal['replay']}, eager against eager "
          f"{equal['control']}; {time.perf_counter() - t0:.1f} s")
    _require(worst["loss"] <= 1e-5 and worst["grads"] <= 1e-3 and worst["stats"] <= 1e-5
             and worst["params at count 0"] == 0,
             f"{arch}: the replayed f32 train step differs from the eager one")


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, infinite where either holds a NaN."""
    d = (a - b).abs().max().item() if a.numel() else 0.0
    return d if d == d else float("inf")


def _adamw_card_vs_cpu(ct, graphs, dev, seed: int, smi: str) -> None:
    """The card's AdamW as the training step runs it (``capturable_optimizer``
    and ``adamw_update``, replayed from one CUDA graph) against the CPU's
    ``make_optimizer`` (its rate ``learning_rate`` as a number), on the same
    gradients made on the CPU from ``seed``: 48 counts of a 40-step schedule
    with a warm-up of 10 (the warm-up, the cosine decay, and 8 counts past
    its end, where the table clamps), at ``test_adamw_updates_equal_optax``'s
    lr 0.5 and weight decay 0.1.  Both sides set the parameters back to
    their small start values before each count, so that no update is lost in
    its parameter's rounding as the parameters grow.  Held: count 0's update
    0 on both sides, every later update within 2e-5 relative (1e-8
    absolute) of the CPU's: the card forms ``1 - b**t`` in f32, as optax
    does (up to 1.3e-5 from the float64 formula)."""
    import numpy as np

    cfg = ct.TrainConfig(lr=0.5, warmup_steps=10, steps=40, weight_decay=0.1)
    counts = 48
    rng = np.random.default_rng(seed + 18)
    shapes = [(64,), (16, 3, 3, 8), (6,)]
    start = [rng.normal(0, 0.01, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes] for _ in range(counts)]
    t0 = time.perf_counter()
    card = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(dev)) for p in start]
    card_start = [p.detach().clone() for p in card]
    card_grads = [[torch.from_numpy(g).to(dev) for g in gs] for gs in grads]
    table = ct.lr_table(cfg, dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    lr = ct.lr_at(table, count)
    opt = ct.capturable_optimizer(card, cfg, lr)
    for p, g in zip(card, card_grads[0]):
        p.grad = g.clone()

    def update():
        ct.adamw_update(opt, lr, table, count)

    got = []
    for c in range(counts):
        if c == 0:
            _, entry = graphs.capture_call(update, dev, (), "as the AdamW update")  # count 0
        else:
            with torch.no_grad():
                for p, s, g in zip(card, card_start, card_grads[c]):
                    p.copy_(s)
                    p.grad.copy_(g)
            entry.replay()
        got.append([(p.detach() - s).cpu().numpy() for p, s in zip(card, card_start)])
    cpu = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in start]
    cpu_opt = ct.make_optimizer(cpu, cfg)
    used, gap, held = 0.0, 0.0, True
    for c in range(counts):
        with torch.no_grad():
            for p, s in zip(cpu, start):
                p.copy_(torch.from_numpy(s))
        for p, g in zip(cpu, grads[c]):
            p.grad = torch.from_numpy(g)
        cpu_opt.param_groups[0]["lr"] = ct.learning_rate(c, cfg)
        cpu_opt.step()
        for p, s, a in zip(cpu, start, got[c]):
            want = (p.detach() - torch.from_numpy(s)).numpy()
            if c == 0:
                held &= not a.any() and not want.any()
                continue
            diff, size = np.abs(a - want), np.abs(want)
            held &= bool(np.all(diff <= 2e-5 * size + 1e-8))
            used = max(used, float(np.max(diff / (2e-5 * size + 1e-8))))
            gap = max(gap, float(np.max(diff / np.maximum(size, 1e-2))))
    print(f"[train adamw card vs cpu] the card's captured AdamW (capturable, its rate read from "
          f"the device table, replayed) against the CPU's make_optimizer on the same gradients: "
          f"{counts} counts of a {cfg.steps}-step schedule with a warm-up of {cfg.warmup_steps}, "
          f"lr {table.max().item():g} down to {table[-1].item():.3g}, {len(shapes)} parameters "
          f"({sum(int(np.prod(s)) for s in shapes)} values) set back to their start each count: "
          f"count 0 updates 0 on both sides and every later update within 2e-5 relative (1e-8 "
          f"absolute) {held}, the largest gap {used:.3g} of its bound; largest relative gap "
          f"where an update is 1e-2 or more {gap:.3g}; count read back "
          f"{int(count)}; {time.perf_counter() - t0:.1f} s; {smi}")
    _require(held and int(count) == counts,
             "the card's captured AdamW differs from the CPU's past count 0")


# the CUDA driver's graph node types (CUgraphNodeType)
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
               6: "wait event", 7: "event record", 10: "mem alloc", 11: "mem free"}


def _graph_nodes(graph) -> dict[str, int]:
    """The nodes of a graph captured with ``keep_graph=True``
    (:func:`_dumped_graphs`) by type, read through the CUDA driver
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _require(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    _require(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kinds: dict[str, int] = defaultdict(int)
    for node in nodes:
        kind = ctypes.c_int(-1)
        _require(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
                 "cuGraphNodeGetType failed")
        kinds[_NODE_TYPES.get(kind.value, str(kind.value))] += 1
    return dict(kinds)


def _train_turns(ct, cd, data: dict, dev, smi: str) -> None:
    """The bf16 v3 step at the default ``TrainConfig``, eager (a stage timer
    that records nothing) and replayed from one CUDA graph, each from the
    same initial weights: steps/s on the host's clock and the host's ms a
    step (the call's own time, no sync) in turns, eager, replay, replay,
    eager, 20 steps each after a warm-up; the device busy time and launches
    a step by ``torch.profiler`` (5 steps each) and the card's idle share
    beside the steps' time; the graph's nodes (read through the CUDA driver)
    beside the eager launch count, and the bytes its capture reserved for
    its own pool; then a window of replays in which the host never waits
    for the card."""
    from torch.profiler import ProfilerActivity, profile

    cfg = ct.TrainConfig(warmup_steps=3, steps=100)
    steps = {mode: ct.TrainStep(cd.init_params(ct.SignCenterNetV3Train(), 0).to(dev), cfg,
                                timer=_eager_timer if mode == "eager" else None)
             for mode in ("eager", "replay")}
    taken = dict.fromkeys(steps, 0)

    def run(mode):
        taken[mode] += 1
        return steps[mode](data, taken[mode] - 1)

    t0 = time.perf_counter()
    with _dumped_graphs():
        run("replay")                      # the capture
    capture_s = time.perf_counter() - t0
    for mode in steps:
        while taken[mode] < 5:
            run(mode)
    wall, host = defaultdict(list), defaultdict(list)
    for mode in ("eager", "replay", "replay", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            t = time.perf_counter()
            run(mode)
            host[mode].append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall[mode].append((time.perf_counter() - t0) / 20 * 1e3)
    busy, launches, top = {}, {}, {}
    for mode in steps:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run(mode)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy[mode] = sum(e.device_time for e in ev) / 5 / 1e3
        launches[mode] = len(ev) / 5
        top[mode] = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:4]
    entry = steps["replay"].captured
    nodes = _graph_nodes(entry.graph)
    for mode in steps:
        ms = statistics.median(wall[mode])
        print(f"[train {mode}] v3 bf16, batch {cfg.batch_size}, {len(wall[mode])} runs of 20 "
              f"steps in turns (eager, replay, replay, eager): {1e3 / ms:.2f} steps/s (runs "
              + ", ".join(f"{1e3 / w:.2f}" for w in wall[mode])
              + f"); the host's ms a step {statistics.median(host[mode]):.3f} (min "
              f"{min(host[mode]):.3f}, max {max(host[mode]):.3f}); busy {busy[mode]:.3f} ms a step "
              f"(torch.profiler, 5 steps), {launches[mode]:.0f} CUDA kernels and copies a step: the "
              f"card idles {1 - busy[mode] / ms:.1%} of {ms:.3f} ms; most device time: "
              + ", ".join(f"{e.key[:40]} {e.device_time_total / 5 / 1e3:.3f}" for e in top[mode])
              + f" ms; {smi}")
    print(f"[train graph] the step's CUDA graph: nodes by type {nodes} "
          f"({sum(nodes.values())} in all) beside {launches['eager']:.0f} eager CUDA kernels and "
          f"copies a step; its capture reserved {entry.pool_bytes / 2**30:.3f} GiB for its own "
          f"pool ({torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved on the card); "
          f"warm-up and capture {capture_s:.2f} s; replayed steps/s "
          f"{statistics.median(wall['eager']) / statistics.median(wall['replay']):.2f}x the "
          f"eager in this call")
    _require(nodes.get("kernel", 0) > 0, "the training step's graph holds no kernel node")
    _require_no_sync("train replay", lambda: run("replay"), iters=4)


def _train_phases(rt, dev, smi: str, seed: int) -> dict:
    """Phases 14-15: training and calibration.  -> {path: (launch counts,
    steps)}."""
    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_quant as cq
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_train as ct
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    # --- 14. training ------------------------------------------------------
    t0 = t_phase = time.perf_counter()
    frames, found = make_labelled_frames(64, 800, 1360, seed=seed + 14)
    data = ct.pack_dataset(frames, found)
    h, w = frames.shape[1:3]
    print(f"[train] synthetic train set {frames.shape} uint8 ({frames.nbytes / 1e6:.1f} MB), "
          f"{len(data['pos'])} sign boxes, made in {time.perf_counter() - t0:.1f} s")
    cfg = ct.TrainConfig(warmup_steps=3, steps=31, seed=seed)
    b = cfg.batch_size
    runs = {}
    for mode in ("eager", "replay"):
        # the stage timer makes the steps eager; without it a step replays
        timer = CudaStageTimer() if mode == "eager" else None
        stamps, losses = [], []

        def log(line: str) -> None:
            # train() logs "step i: loss=..." after a synchronising read of the
            # step's loss: with log_every=1 the stamps bracket whole steps
            stamps.append(time.perf_counter())
            losses.append(float(line.split("loss=")[1].split()[0]))

        def run():
            return ct.train(data, cd.CNNDetectorConfig(arch="v3"), cfg, log_every=1, log_fn=log,
                            device=dev, timer=timer)

        live = torch.cuda.memory_allocated(dev)        # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats(dev)
        label = "training" if mode == "replay" else "training, eager (the stage timer)"
        (net, _), counts = _run_path(rt, label, run)
        peak = torch.cuda.max_memory_allocated(dev)
        step_s = np.diff(stamps)                    # steps 1..30: the first is a warm-up
        runs[mode] = (net if mode == "replay" else None, losses, counts)
        stages = ""
        if timer is not None:
            split = {k: sum(s.elapsed_time(e) for s, e in v[1:]) / (len(v) - 1)
                     for k, v in timer.events.items()}
            stages = (f"; device ms a step by CUDA events: {sum(split.values()):.3f} = "
                      + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        print(f"[train] {mode}: v3 twin, TrainConfig batch {b}, crop {ct.CROP}, bf16 convs, "
              f"BatchNorm f32, warm-up {cfg.warmup_steps} of {cfg.steps} steps"
              + (" replayed from one CUDA graph a step" if timer is None else
                 " eager with the stage timer")
              + f": {1 / np.median(step_s):.2f} steps/s, {b / np.median(step_s):.1f} crops/s on "
              f"the host's clock (median of {len(step_s)} steps after the first, the capture's "
              f"in a replay; min {1 / step_s.max():.2f}, max {1 / step_s.min():.2f} steps/s; a "
              f"synchronised loss read a step){stages}; peak memory allocated "
              f"{peak / 2**20:.1f} MiB, {(peak - live) / 2**20:.1f} MiB above the "
              f"{live / 2**20:.1f} MiB live before training; {smi}")
        print(f"[train] {mode}: loss, first 5 steps: {', '.join(f'{v:.4f}' for v in losses[:5])};"
              f" last 5: {', '.join(f'{v:.4f}' for v in losses[-5:])}")
        _require(len(losses) == cfg.steps and np.isfinite(losses).all(),
                 f"non-finite training loss ({mode})")
        _require(np.mean(losses[-5:]) < np.mean(losses[:5]),
                 f"the loss did not fall over the run's steps ({mode})")
        del net
    net, losses, counts = runs["replay"]
    eager_losses = np.asarray(runs["eager"][1])
    curve = float(np.max(np.abs(np.asarray(losses) - eager_losses) / np.abs(eager_losses)))
    print(f"[train] the replayed run's 31 losses against the eager run's: max relative "
          f"difference {curve:.3g} (bound 1e-2), equal {losses == runs['eager'][1]}")
    _require(curve <= 1e-2, "the replayed training run's losses differ from the eager run's")
    # a threshold under the heatmap's 0.01 prior, so that records come out
    # of a net 31 steps old
    det = cd.CNNDetector(net, cd.CNNDetectorConfig(arch="v3", score_threshold=0.005))
    names = [f"{i:05d}.jpg" for i in range(8)]
    dets = det.detect_frames(frames[:8], names, (h, w))
    print(f"[train] the replayed run's folded net through CNNDetector on 8 train frames at "
          f"threshold 0.005: {len(dets)} detections")
    _require(_well_formed(dets, h, w), "the trained detector's records are malformed")
    del net, det, runs
    torch.cuda.empty_cache()
    _train_turns(ct, cd, ct.upload_dataset(data, dev), dev, smi)
    torch.cuda.empty_cache()
    _adamw_card_vs_cpu(ct, graphs, dev, seed, smi)
    sub = {k: v[:4] for k, v in data.items() if k != "pos"}
    sub["pos"] = data["pos"][data["pos"][:, 0] < 4]
    for arch in ("v3", "slim"):
        _f32_step_vs_cpu(ct, cd, arch, sub, dev, seed)
        _train_replay_vs_eager(ct, cd, arch, sub, dev, seed)
    print(f"[train] phase 14 in {time.perf_counter() - t_phase:.1f} s")

    # --- 15. calibration ---------------------------------------------------
    ck = "artifacts/cnn_detector/params.npz"
    qcfg = cd.CNNDetectorConfig(**cd.saved_meta(ck))
    float_net = cd.load_params(ck, cd.SignCenterNet(qcfg))
    t0 = time.perf_counter()
    q_card = cq.quantize_v3(float_net.to(dev), frames[:8])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_cpu = cq.quantize_v3(float_net.to("cpu"), frames[:8])
    cpu_s = time.perf_counter() - t0
    kernels_same = all(np.array_equal(q_card[k], q_cpu[k]) for k in q_cpu if k.endswith("_kernel"))
    rel = max(float(np.max(np.abs(q_card[k].astype(np.float64) - q_cpu[k])
                           / np.maximum(np.abs(q_cpu[k]), 1e-30)))
              for k in q_cpu if not k.endswith("_kernel"))
    qdet = cq.QuantCNNDetector(
        {k: torch.from_numpy(np.array(v)).to(dev) for k, v in q_card.items()}, qcfg)
    qdets = qdet.detect_frames(frames[:8], names, (h, w))
    print(f"[calibrate] quantize_v3 of {ck} on 8 synthetic {w}x{h} frames: card {card_s:.2f} s, "
          f"cpu {cpu_s:.2f} s; int8 kernels identical {kernels_same}; other arrays max relative "
          f"diff {rel:.3g} (bound 1e-5); the card's artifact through QuantCNNDetector on the "
          f"card: {len(qdets)} detections")
    _require(set(q_card) == set(q_cpu) and kernels_same and rel <= 1e-5,
             "the card's calibration differs from the CPU's")
    _require(_well_formed(qdets, h, w), "the quantized detector's records are malformed")
    return {"training": (counts, cfg.steps)}


def _planted(n: int, seed: int):
    """The dry run's planted frames and GT (``__graft_entry__.py:
    dryrun_multichip``), rebuilt here: a dark 24x24 square a 96x96 frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.integers(90, 140, (n, 96, 96, 3), np.uint8)
    gt_boxes = np.zeros((n, 2, 4), np.int32)
    gt_types = np.zeros((n, 2), np.int32)
    for i in range(n):
        x, y = 20 + (i % 3) * 10, 30
        frames[i, y:y + 24, x:x + 24] = 25
        gt_boxes[i, 0] = (x, y, x + 24, y + 24)
        gt_types[i, 0] = 1 + (i % 6)
    return frames, gt_boxes, gt_types


def _red_sign_frames(n: int):
    """The dry run's detection frames: a red 24x24 sign at (30, 30) of a
    96x96 frame of gray 160, and its template, the sign's own red mask
    through the pipeline's crop geometry."""
    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.constants import DETECT_CROP, DETECT_GROW
    from opencv_traffic_sign_detector_tpu_torch.ops.color import color_mask
    from opencv_traffic_sign_detector_tpu_torch.ops.geometry import filter_and_grow_boxes
    from opencv_traffic_sign_detector_tpu_torch.ops.resize import crop_and_resize

    frames = np.full((n, 96, 96, 3), 160, np.uint8)
    frames[:, 30:54, 30:54] = (40, 40, 230)
    box, keep = filter_and_grow_boxes(torch.tensor([[[30, 30, 24, 24]]]), torch.tensor([[True]]),
                                      DETECT_GROW)
    _require(bool(keep[0, 0]), "the planted sign fails the aspect filter")
    crop = crop_and_resize(torch.from_numpy(frames[:1]), box, DETECT_CROP)[0, 0]
    red = (color_mask(crop, "r") > 0).to(torch.float32).reshape(1, -1).repeat(6, 1)
    return frames, red


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|."""
    want = want.detach().cpu().double()
    return ((got.detach().cpu().double() - want).abs().max()
            / max(want.abs().max().item(), 1e-30)).item()


def _lda_backward_error(coef, intercept, stats) -> tuple[float, float]:
    """How far a fit (coef, intercept) is from solving the LDA system of
    ``stats`` (counts, sums, second moments), in f64 on the CPU: the
    normwise backward error of ``cov @ coef.T = means.T`` and the
    intercept's largest difference to ``-means . coef / 2 + log prior``,
    over its largest.  The dry run's 324-dim covariance of a few dozen
    proposals is near singular, so two fits of equal statistics differ by
    tens of percent a coefficient; both stay within ~1e-6 of solving them."""
    counts, sums, sq = (t.detach().cpu().double() for t in stats)
    coef, intercept = coef.detach().cpu().double(), intercept.detach().cpu().double()
    n, (c, d) = counts.sum(), sums.shape
    means = sums / counts.clamp(min=1.0)[:, None]
    cov = ((sq.sum(0) - torch.einsum("c,cd,ce->de", counts, means, means))
           / (n - c).clamp(min=1.0) + 1e-6 * torch.eye(d, dtype=torch.float64))
    eta = (torch.linalg.norm(cov @ coef.T - means.T)
           / (torch.linalg.norm(cov) * torch.linalg.norm(coef) + torch.linalg.norm(means)))
    want = -0.5 * (means * coef).sum(1) + torch.log(counts.clamp(min=1e-6) / n.clamp(min=1.0))
    return eta.item(), ((intercept - want).abs().max() / want.abs().max()).item()


def _enqueue_ms(pipe, host, names: list[str], batches: int = 5) -> dict:
    """Host ms a dispatch spends on each shard (``perf_counter`` around the
    graph helper's call: the copy of the shard's frames into its graph's
    input and the replay; with the eager timer set, the upload and the eager
    ``detect_batch``) and on the whole dispatch (the pinned copy of the
    batch, every shard, the copies back), replay and eager in turns over
    ``batches`` batches each, each collected before the next: {mode:
    {device or "dispatch": "median (min, max)"}}."""
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    spent = defaultdict(list)
    orig = graphs.CapturedFn.__call__

    def timed(self, device, x, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, device, x, *a, **kw)
        spent["eager" if kw.get("eager") else "replay", str(device)].append(
            (time.perf_counter() - t0) * 1e3)
        return out

    graphs.CapturedFn.__call__ = timed
    try:
        for _ in range(batches):
            for mode, timer in (("replay", None), ("eager", _eager_timer)):
                pipe.timer = timer
                t0 = time.perf_counter()
                pending = pipe.dispatch(host)
                spent[mode, "dispatch"].append((time.perf_counter() - t0) * 1e3)
                pipe.collect(pending, names)
    finally:
        graphs.CapturedFn.__call__ = orig
        pipe.timer = None
    out = defaultdict(dict)
    for (mode, dev), v in sorted(spent.items()):
        out[mode][dev] = f"{statistics.median(v):.3f} ({min(v):.3f}, {max(v):.3f})"
    return dict(out)


def _eager_packed(pipe):
    """-> ``eager(frames)``: ``pipe``'s dispatch run eagerly (the timer that
    records nothing), its packed output."""
    def eager(frames):
        pipe.timer = _eager_timer
        try:
            return _packed(pipe.dispatch(frames))
        finally:
            pipe.timer = None

    return eager


def _scale_out_detection(rt, dev, smi: str, frames, templates, mcfg):
    """Phase 16a: the tuned slice through ``DetectionPipeline(mesh=
    data_mesh())`` over every visible card, records equal to the unsharded
    pipeline's, K1 with its tail and K2-K4 launched, no host sync in a window
    of dispatches; device-side ms and frames/s of 3 batches with the stage
    timer, then one batch at a time against two in flight, beside one card
    in the same call where the mesh has more, and the host's enqueue ms a
    shard.  -> (launch counts of the 3 batches, their records, the
    pipeline)."""
    from opencv_traffic_sign_detector_tpu_torch.config import PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as pm

    cards = pm.data_mesh()                     # every visible card
    batch = 32
    host = frames[:batch]
    names = [f"{i:05d}.jpg" for i in range(batch)]
    pcfg = PipelineConfig(mser=mcfg, batch_size=batch)
    one = det.DetectionPipeline(cfg=pcfg, templates=templates, device=dev)
    want = one.detect_frames(host, names)
    pipe = det.DetectionPipeline(cfg=pcfg, templates=templates, mesh=cards)
    with _dumped_graphs():
        pipe.detect_frames(host, names)  # warm-up batch: each card's graph captured
    torch.cuda.synchronize()
    want_kernels = ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox")
    _graph_report("scale-out detection", pipe._detect.graphs, want_kernels)
    _graph_kernel_names("scale-out detection", pipe._detect.graphs, want_kernels)
    _eager_packed(pipe)(host)  # an eager batch first: the capture emptied the cache

    def timed():
        timer = CudaStageTimer()
        pipe.timer = timer
        batch_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            dets = pipe.detect_frames(host, names)
            batch_s.append(time.perf_counter() - t0)
        return dets, batch_s, timer.per_batch_ms(3)

    (dets, batch_s, stage_ms), counts = _run_path(rt, "scale-out detection", timed)
    pipe.timer = None
    print(f"[scale-out detection] DetectionPipeline(mesh=data_mesh()) over {cards.size} card "
          f"shard(s), batch {batch} of {frames.shape[2]}x{frames.shape[1]}, tuned "
          f"MSER_7_200_2000_1: device side "
          f"{_stage_sum(stage_ms):.3f} ms a batch summed over its shards (CUDA events on "
          "each shard's card, mean of 3 after a warm-up; "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"), {batch / statistics.median(batch_s):.2f} frames/s on the host's clock (median; "
          f"min {batch / max(batch_s):.2f}, max {batch / min(batch_s):.2f}); {len(dets)} "
          f"detections, records equal to the unsharded pipeline's {dets == want}; {smi}")
    _require(dets == want, "sharded detection records differ from the unsharded pipeline's")
    for name in want_kernels:
        _require(counts[name] > 0, f"scale-out detection: {name} never launched")
    # the main path: each card's graph replayed, launches added at each replay
    rdets, rcounts = _run_path(rt, "scale-out detection replay",
                               lambda: [pipe.detect_frames(host, names) for _ in range(3)][-1])
    _require(rdets == want, "replayed sharded detection records differ from the unsharded "
             "pipeline's")
    _require(rcounts == counts, f"scale-out detection: 3 replays launched {rcounts}, 3 eager "
             f"batches {counts}")
    _replay_vs_eager("scale-out detection", pipe.dispatch, _eager_packed(pipe), host)
    _require_no_sync("scale-out detection", lambda: pipe.dispatch(host))
    pipes = {f"{cards.size} card(s)": pipe,
             f"{cards.size} card(s) eager": det.DetectionPipeline(
                 cfg=pcfg, templates=templates, mesh=cards, timer=_eager_timer)}
    if cards.size > 1:
        pipes["1 card"] = one
        pipes["1 card eager"] = det.DetectionPipeline(cfg=pcfg, templates=templates, device=dev,
                                                      timer=_eager_timer)
    gaps = _in_turns(pipes, host, names)
    print(f"[scale-out in flight] batch {batch}, 24 batches each way in turns, host frames to "
          "records on the host's clock, graph replays against eager dispatches: "
          + "; ".join(f"{label}: one at a time {_fps(batch, gaps[label, False])}, two in flight "
                      f"{_fps(batch, gaps[label, True])}" for label in pipes) + f"; {smi}")
    print(f"[scale-out enqueue] host ms a shard a dispatch, median (min, max) of 5, graph "
          f"replay against eager: {_enqueue_ms(pipe, host, names)}; {smi}")
    return rcounts, dets, pipe


def _scale_out_phases(rt, dev, smi: str, frames, signs, templates, mcfg,
                      seed: int) -> tuple[dict, dict]:
    """Phase 16: scale-out on the card.  -> ({path: (launch counts, batches)},
    the table row of K5 at the LDA step's sweep planes)."""
    import copy

    import numpy as np
    import torch.distributed as dist

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.data.gt import GroundTruthBox
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
    from opencv_traffic_sign_detector_tpu_torch.eval.device_stats import distributed_statistics
    from opencv_traffic_sign_detector_tpu_torch.eval.stats import compute_detection_statistics
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_train as ct
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline import recognize_batch
    from opencv_traffic_sign_detector_tpu_torch.ops import ccl, prop_cuda
    from opencv_traffic_sign_detector_tpu_torch.parallel import cnn as pcnn
    from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as pm
    from opencv_traffic_sign_detector_tpu_torch.parallel import train as ptrain
    from opencv_traffic_sign_detector_tpu_torch.utils.profiling import profiler_trace

    t_phase = time.perf_counter()
    cards = pm.data_mesh()                     # every visible card
    two = pm.data_mesh(devices=[cards.devices[i % cards.size] for i in range(2)])
    cpu2 = pm.data_mesh(2, device="cpu")
    print(f"[scale-out] meshes: {cards.size} card shard(s) {[str(d) for d in cards.devices]}; "
          f"2 shards {[str(d) for d in two.devices]}; 2 CPU shards")

    # --- 16a. the tuned slice over the cards' mesh --------------------------
    batch = 32
    names = [f"{i:05d}.jpg" for i in range(batch)]
    counts, dets, pipe = _scale_out_detection(rt, dev, smi, frames, templates, mcfg)
    paths = {"scale-out detection": (counts, 3)}

    # --- 16b. the SPMD LDA train step --------------------------------------
    dry = MSERConfig(min_area=60, max_area=1200, max_variation=1.0, max_regions=32)
    planted = _planted(8, seed + 16)
    det.full_f32_matmuls()

    def train_step(m):
        return ptrain.distributed_train_step(m, dry)(*(pm.shard_batch(m, a) for a in planted))

    kept = {}  # K5's resident form at the step's sweep planes, 8 passes a call
    with _record_nth(ccl, "propagate_rolls", 38, kept, "propagate_rolls"):
        (coef, intercept, class_counts), counts = _run_path(rt, "scale-out train step",
                                                            lambda: train_step(two))
    ccoef, cint, ccounts = train_step(cpu2)

    def statistics_on(device):
        f, lab, w = ptrain._propose_and_label(*(torch.from_numpy(a).to(device) for a in planted),
                                              dry, 1.15, 32)
        d = f.shape[-1]
        return f.reshape(-1, d), ptrain._class_statistics(f.reshape(-1, d), lab.reshape(-1),
                                                          w.reshape(-1))

    _, st_cpu = statistics_on("cpu")
    _, st_card = statistics_on(dev)
    stat_err = max(_max_rel(a, b) for a, b in zip(st_card[1:], st_cpu[1:]))
    fits = {"card": _lda_backward_error(coef, intercept, st_cpu),
            "cpu": _lda_backward_error(ccoef, cint, st_cpu)}
    print(f"[scale-out train step] distributed_train_step over 2 shards on the card, 8 planted "
          f"96x96 frames: class counts {class_counts.cpu().int().tolist()} (2 CPU shards "
          f"{ccounts.int().tolist()}), coef finite {bool(torch.isfinite(coef).all())}; feature "
          f"sums and second moments card vs CPU max |diff| / max {stat_err:.3g} (bound 1e-5); "
          "each fit against the CPU's statistics, normwise backward error and intercept error: "
          + ", ".join(f"{k} {e:.3g}, {i:.3g}" for k, (e, i) in fits.items()) + " (bounds 1e-5)")
    _require(torch.equal(class_counts.cpu(), ccounts) and class_counts.sum() > 0
             and bool(torch.isfinite(coef).all()) and bool(torch.isfinite(intercept).all())
             and torch.equal(st_card[0].cpu(), st_cpu[0]) and stat_err <= 1e-5
             and all(e <= 1e-5 and i <= 1e-5 for e, i in fits.values()),
             "the card's SPMD train step differs from the CPU mesh's")
    paths["scale-out train step"] = (counts, 1)
    lda = kept.pop("propagate_rolls")[0][:4]
    row = _measure("propagate_rolls_lda", prop_cuda.propagate_rolls,
                   prop_cuda.propagate_rolls_plain, lda, {}, "csrc/prop_rolls.cu",
                   "opencv_traffic_sign_detector_tpu/ops/pallas_prop.py:69", smi,
                   kind="propagate_rolls")
    row["launches"] = counts["propagate_rolls"]
    _require(row["launches"] > 0, "scale-out train step: K5 never launched")
    del kept, lda

    # --- 16c. sharded recognition with (b)'s heads -------------------------
    det_frames, red = _red_sign_frames(8)
    heads = (torch.stack([torch.stack([coef[0], coef[k]]) for k in range(1, 7)]),
             torch.stack([torch.stack([intercept[0], intercept[k]]) for k in range(1, 7)]))
    rcfg = PipelineConfig(mser=dry, max_detections=16, batch_size=8)
    got = pm.unshard(pm.sharded_recognize_fn(two, rcfg, "HOG", "LDABAYES")(
        pm.shard_batch(two, det_frames), heads))
    single = recognize_batch(torch.from_numpy(det_frames).to(dev), heads, rcfg, "HOG", "LDABAYES")
    same = all(torch.equal(got[k], single[k]) for k in (0, 1, 3))
    print(f"[scale-out recognition] sharded_recognize_fn over 2 shards, 8 red-sign frames, the "
          f"heads of (b): {int(got[3].sum())} labelled detections; boxes, labels and valid equal "
          f"to the unsharded recognize_batch {same}; scores max |diff| "
          f"{(got[2] - single[2]).abs().max().item():.3g}")
    _require(same and bool(torch.isfinite(got[2]).all()),
             "sharded recognition differs from the unsharded recognize_batch")

    # --- 16d. the SPMD CNN step ---------------------------------------------
    tiny = cd.CNNDetectorConfig(stem_features=16, mid_features=24, deep_features=32,
                                head_features=24)
    hw = ct.SLICE + 32
    rng = np.random.default_rng(seed + 16)
    cnn_frames = rng.integers(0, 255, (2, hw, hw, 3)).astype(np.uint8)
    cnn_boxes = np.zeros((2, ct.MAX_GT, 4), np.float32)
    cnn_cls = np.zeros((2, ct.MAX_GT), np.int32)
    for i in range(2):
        cnn_boxes[i, 0] = (200, 200, 260, 260)
        cnn_cls[i, 0] = 1 + i
    data = pcnn.shard_cnn_dataset({"frames": cnn_frames, "boxes": cnn_boxes, "cls": cnn_cls}, 2)
    tcfg = ct.TrainConfig(batch_size=1, steps=2, warmup_steps=1, pos_fraction=1.0, seed=seed)
    model = cd.init_params(cd.SignCenterNet(tiny), seed).to(two.devices[0])
    before = [p.detach().clone() for p in model.parameters()]
    step = pcnn.make_spmd_cnn_train_step(two, tiny, tcfg)
    sharded = pcnn.put_sharded_cnn_dataset(two, data)
    losses = [step(model, sharded, s)["loss"].item() for s in range(tcfg.steps)]
    moved = max((p - b).abs().max().item() for p, b in zip(model.parameters(), before))
    replica_gap = _replica_gap(step)

    f32 = dataclasses.replace(tiny, dtype="float32")

    def first_step_vs_cpu(step_data):
        """The f32 SPMD step at count 0 over 2 shards on the card and 2 CPU
        shards, from the same weights, on the CPU's crops of step 0: (loss
        relative difference, worst gradient over its largest and its
        parameter, parameters equal after the update)."""
        cpu_model = cd.init_params(cd.SignCenterNet(f32), seed)
        card_model = copy.deepcopy(cpu_model).to(two.devices[0])
        cpu_data = pcnn.put_sharded_cnn_dataset(cpu2, step_data)
        crops = [ct.crops_from_draws(ct.sample_draws(ct.shard_generator(seed, 0, i, "cpu"), 1,
                                                     d["frames"].shape[0], d["pos"].shape[0],
                                                     tcfg), d, tcfg)
                 for i, d in enumerate(cpu_data)]
        got_cpu = pcnn.make_spmd_cnn_train_step(cpu2, f32, tcfg).update(cpu_model, crops)
        got_card = pcnn.make_spmd_cnn_train_step(two, f32, tcfg).update(
            card_model, [tuple(c.to(d) for c in cr) for d, cr in zip(two.devices, crops)])
        loss_rel = (abs(got_card["loss"].item() - got_cpu["loss"].item())
                    / abs(got_cpu["loss"].item()))
        grad_rel = {name: _max_rel(c.grad, a.grad) for (name, a), c in
                    zip(cpu_model.named_parameters(), card_model.parameters())}
        worst = max(grad_rel, key=grad_rel.get)
        same = all(torch.equal(c.cpu(), a)
                   for a, c in zip(cpu_model.parameters(), card_model.parameters()))
        return loss_rel, grad_rel[worst], worst, same

    lab_frames, lab_found = make_labelled_frames(2, 480, 640, seed=seed + 16)
    checks = {"labelled": first_step_vs_cpu(
                  pcnn.shard_cnn_dataset(ct.pack_dataset(lab_frames, lab_found), 2)),
              "noise": first_step_vs_cpu(data)}
    print(f"[scale-out cnn step] the SPMD step over 2 shards, tiny slim at bf16, "
          f"{tcfg.steps} steps on the dry run's noise frames (a capture a shard, then a replay: "
          f"{step.captured is not None}): losses {', '.join(f'{v:.4f}' for v in losses)}, "
          f"parameters moved up to {moved:.3g}, replicas' largest difference {replica_gap:.3g}; the "
          "first step at f32 over 2 shards, card against 2 CPU shards on the CPU's crops: "
          + "; ".join(f"{k} frames: loss rel {lr:.3g}, grads max |diff| / max {g:.3g} at {w}, "
                      f"parameters equal after the count-0 update {same}"
                      for k, (lr, g, w, same) in checks.items())
          + " (held on the labelled frames: loss 1e-5, grads 1e-3, phase 14's bounds; on "
          "noise the norms' f32 fast variance cancels further, printed only)")
    _require(bool(np.isfinite(losses).all()) and moved > 0 and step.captured is not None
             and replica_gap == 0, "the SPMD CNN step did not train, replay or keep its replicas")
    loss_rel, grad_rel, _, param_same = checks["labelled"]
    _require(loss_rel <= 1e-5 and grad_rel <= 1e-3 and param_same,
             "the card's SPMD CNN step differs from the CPU mesh's")

    # --- 16e. sharded v3 inference ------------------------------------------
    v3cfg = cd.CNNDetectorConfig(arch="v3", max_detections=8, score_threshold=0.5)
    flat = cd.flat_params(cd.init_params(cd.SignCenterNet(v3cfg), seed))
    flat["['Conv_4']['bias']"] = flat["['Conv_4']['bias']"] + 8.0      # hm: fire
    flat["['Conv_5']['kernel']"] = flat["['Conv_5']['kernel']"] * 0.0  # size: 16 px
    flat["['Conv_5']['bias']"] = flat["['Conv_5']['bias']"] + 1.0
    net = cd.load_flat_params(cd.SignCenterNet(v3cfg), flat)
    replicas = {d: copy.deepcopy(net).to(d) for d in set(two.devices)}
    inf_frames = rng.integers(0, 255, (8, 64, 64, 3)).astype(np.uint8)
    with torch.inference_mode():
        maps1 = replicas[dev](torch.from_numpy(inf_frames).to(dev))
        single = cd.decode_detections(maps1, v3cfg.max_detections, v3cfg.score_threshold,
                                      v3cfg.stride)
        shard_maps, shard_dets = [], []
        for d, x in zip(two.devices, pm.shard_batch(two, inf_frames)):
            with pm.device_scope(d):
                m = replicas[d](x)
                shard_maps.append(tuple(m[k] for k in ("hm", "size", "off")))
                shard_dets.append(cd.decode_detections(m, v3cfg.max_detections,
                                                       v3cfg.score_threshold, v3cfg.stride))
        maps2, dets2 = pm.unshard(shard_maps), pm.unshard(shard_dets)
    per_frame = dets2[3].sum(dim=1)
    score_err = (dets2[2] - single[2]).abs().max().item()
    map_err = max((a - maps1[k]).abs().max().item() for a, k in zip(maps2, ("hm", "size", "off")))
    print(f"[scale-out cnn inference] v3 with the head-bias surgery over 2 shards, 8 frames of "
          f"64x64: valid detections a frame {per_frame.tolist()}; scores max |diff| to the "
          f"unsharded run {score_err:.3g} (bound 1e-5); raw maps max |diff| {map_err:.3g} (bound "
          f"5e-3); valid equal {torch.equal(dets2[3], single[3])}")
    _require(bool((per_frame >= 1).all()) and score_err <= 1e-5 and map_err <= 5e-3
             and torch.equal(dets2[3], single[3]),
             "sharded CNN inference differs from the unsharded run")

    # --- 16f. device statistics of (a)'s detections -------------------------
    d_cap = max(1, max(sum(d.filename == n for d in dets) for n in names))
    arrays = [np.zeros((batch, d_cap, 4), np.int32), np.zeros((batch, d_cap), np.int32),
              np.zeros((batch, d_cap), bool), np.zeros((batch, 6, 4), np.int32),
              np.zeros((batch, 6), np.int32)]
    gt = []
    for k, n in enumerate(names):
        for j, rec in enumerate(r for r in dets if r.filename == n):
            arrays[0][k, j] = (rec.x1, rec.y1, rec.x2, rec.y2)
            arrays[1][k, j], arrays[2][k, j] = rec.class_id, True
        for j, (x1, y1, x2, y2, st) in enumerate(signs[k]):
            arrays[3][k, j], arrays[4][k, j] = (x1, y1, x2, y2), st
            gt.append(GroundTruthBox(filename=n, x1=x1, y1=y1, x2=x2, y2=y2, class_id=st))
    host = compute_detection_statistics(dets, gt, unmapped_as_type6=False)
    want_counts = [[getattr(host.per_type[t], f) for t in host.per_type]
                   for f in ("correct", "incorrect", "non_detected")]

    def device_counts(m):
        return [c.cpu().tolist() for c in distributed_statistics(m)(
            *(pm.shard_batch(m, a) for a in arrays))]

    stats_cards, stats_two = device_counts(cards), device_counts(two)
    print(f"[scale-out statistics] distributed_statistics of (a)'s {len(dets)} detections "
          f"against the frames' {len(gt)} drawn signs: correct/incorrect/missed by type "
          f"{stats_cards} on the cards' mesh, {stats_two} over 2 shards; host engine "
          f"{want_counts}")
    _require(stats_cards == want_counts and stats_two == want_counts,
             "device statistics differ from the host engine's")

    # --- 16g. the reductions through a one-rank NCCL group -----------------
    with _one_rank_nccl(rt):
        grouped = pm.data_mesh()
        _require(grouped.group is not None and dist.get_backend(grouped.group) == "nccl",
                 "the cards' mesh did not take the NCCL group")
        psum_ok = pm.psum(grouped, [torch.arange(4.0, device=d) for d in grouped.devices]
                          ).tolist() == [float(grouped.shards * i) for i in range(4)]
        stats_nccl = device_counts(grouped)
        gcoef, gint, gcounts = train_step(grouped)
        g_fit = _lda_backward_error(gcoef, gint, st_cpu)
        print(f"[scale-out nccl] one-rank NCCL group ({dist.get_backend(grouped.group)}, "
              f"FileStore under build/): psum {psum_ok}; statistics {stats_nccl}; train step "
              f"class counts {gcounts.cpu().int().tolist()}, its fit against the CPU's "
              f"statistics {g_fit[0]:.3g}, {g_fit[1]:.3g} (bounds 1e-5)")
        _require(psum_ok and stats_nccl == want_counts and torch.equal(gcounts.cpu(), ccounts)
                 and max(g_fit) <= 1e-5, "the NCCL reduction differs")
        _spmd_group_losses(grouped, seed)

    # --- 16h. one MSER batch under profiler_trace ---------------------------
    # the profiler can drop a trace's records (_cuda_trace): up to 3 traces
    trace_dir = rt.BUILD_ROOT.parent / "chip_smoke_trace"
    for _ in range(3):
        shutil.rmtree(trace_dir, ignore_errors=True)
        with profiler_trace(str(trace_dir)):
            pipe.detect_frames(frames[:batch], names)
            torch.cuda.synchronize()
        traces = sorted(trace_dir.glob("*.pt.trace.json"))
        named = bool(traces) and "sweep_tile_kernel" in traces[0].read_text()
        if named:
            break
    print(f"[scale-out trace] profiler_trace of one MSER batch: {[t.name for t in traces]}, "
          f"{sum(t.stat().st_size for t in traces)} bytes, names the tiled sweep kernel {named}")
    _require(len(traces) == 1 and named, "the profiler trace is missing or misses the sweep")
    shutil.rmtree(trace_dir, ignore_errors=True)

    # --- 16i. the SPMD CNN step at the reference's training width -----------
    del pipe
    torch.cuda.empty_cache()
    _scale_out_training(dev, smi, seed)
    print(f"[scale-out] phase 16 in {time.perf_counter() - t_phase:.1f} s; {smi}")
    return paths, row


@contextlib.contextmanager
def _one_rank_nccl(rt):
    """Context: a one-rank NCCL process group (a ``FileStore`` under
    ``build/``), so that a mesh of the cards all-reduces on the card."""
    import torch.distributed as dist

    store_path = rt.BUILD_ROOT.parent / "chip_smoke_nccl_store"
    store_path.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)


def _spmd_group_losses(grouped, seed: int) -> None:
    """Phase 16g's SPMD CNN step: the dry run's tiny slim at bf16, batch 2 a
    shard, 3 steps (the capture's warm-up and 2 replays) over ``grouped``,
    the cards' mesh in a one-rank NCCL group, whose mean all-reduces over
    NCCL between the shards' replays, against the same shards without a
    group: the losses equal bit for bit."""
    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_train as ct
    from opencv_traffic_sign_detector_tpu_torch.parallel import cnn as pcnn
    from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as pm

    tiny = cd.CNNDetectorConfig(arch="slim", stem_features=16, mid_features=24,
                                deep_features=32, head_features=24)
    cfg = ct.TrainConfig(batch_size=2, steps=3, warmup_steps=1, seed=seed)
    frames, found = make_labelled_frames(2 * grouped.shards, 480, 640, seed=seed + 16)
    data = pcnn.shard_cnn_dataset(ct.pack_dataset(frames, found), grouped.shards)

    def losses(m):
        model = cd.init_params(cd.SignCenterNet(tiny), seed).to(m.devices[0])
        step = pcnn.make_spmd_cnn_train_step(m, tiny, cfg)
        sharded = pcnn.put_sharded_cnn_dataset(m, data)
        out = [step(model, sharded, s)["loss"].item() for s in range(cfg.steps)]
        return out, step.captured is not None, _replica_gap(step)

    got, graphed, gap = losses(grouped)
    want, _, _ = losses(pm.Mesh(grouped.devices))
    print(f"[scale-out nccl cnn step] the SPMD CNN step over the cards' mesh in the one-rank "
          f"NCCL group ({grouped.shards} shard(s)), tiny slim bf16, batch {cfg.batch_size} a "
          f"shard, {cfg.steps} steps (a capture, then replays: {graphed}): losses "
          f"{', '.join(f'{v:.6f}' for v in got)}; without the group "
          f"{', '.join(f'{v:.6f}' for v in want)}; equal {got == want}; replicas' largest "
          f"difference {gap:.3g}")
    _require(graphed and got == want and bool(np.isfinite(got).all()) and gap == 0,
             "the graphed SPMD CNN step through the NCCL group differs from the mesh without it")


def _replica_gap(step) -> float:
    """The largest |difference| between any shard's parameters, AdamW
    moments, AdamW counts and update count and the first shard's, after an
    SPMD step (infinite where one holds a NaN)."""
    def state(s):
        return ([p.detach() for p in s.params]
                + [s.opt.state[p][k] for p in s.params for k in ("exp_avg", "exp_avg_sq", "step")]
                + [s.count])

    first, *rest = step._shards
    want = state(first)
    return max([0.0] + [_gap(a.to(first.device).double(), b.double())
                        for s in rest for a, b in zip(state(s), want)])


def _scale_out_training(dev, smi: str, seed: int) -> None:
    """Phase 16i: the SPMD CNN step at the reference's training width, the
    ``slim`` ``SignCenterNet`` at its published widths (64/96/128/96, bf16)
    with phase 14's ``TrainConfig`` (batch 32 crops a shard, 320x320, lr
    2.5e-4, 31 steps, warm-up 3) on phase 14's 64 synthetic 1360x800 frames
    (seed 14), split by ``shard_cnn_dataset`` over every visible card, then
    over 1 card where there are more, then over 2 shards (two cards, or two
    shards on one).  On each mesh, from one set of weights, the eager body
    (a stage timer that records nothing) and the replayed graphs side by
    side: 8 steps each, their losses equal bit for bit and, after every
    step, every shard's parameters, AdamW moments and counts equal the
    first shard's; the replayed run on to step 31 (finite losses, the last
    5 below the first 5); then in turns (eager, replay, replay, eager, 10
    steps each) steps/s and crops/s over all shards and the host's ms a
    step; the card busy time a step by ``torch.profiler`` and each card's
    idle share; the graphs' nodes and pool bytes a shard; no host sync in a
    window of 4 replays."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_train as ct
    from opencv_traffic_sign_detector_tpu_torch.parallel import cnn as pcnn
    from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    frames, found = make_labelled_frames(64, 800, 1360, seed=seed + 14)
    packed = ct.pack_dataset(frames, found)
    del frames
    mcfg = cd.CNNDetectorConfig(arch="slim")
    cfg = ct.TrainConfig(warmup_steps=3, steps=31, seed=seed)
    cards = pm.data_mesh()
    meshes = [cards] + ([pm.data_mesh(1)] if cards.size > 1 else [])
    meshes.append(pm.data_mesh(devices=[cards.devices[i % cards.size] for i in range(2)]))
    start = cd.init_params(cd.SignCenterNet(mcfg), seed)
    print(f"[spmd train] slim {mcfg.stem_features}/{mcfg.mid_features}/{mcfg.deep_features}/"
          f"{mcfg.head_features} {mcfg.dtype}, {sum(p.numel() for p in start.parameters())} "
          f"parameters; {len(packed['frames'])} frames of 1360x800, {len(packed['pos'])} sign "
          f"boxes, made in {time.perf_counter() - t_phase:.1f} s")
    for mesh in meshes:
        t0 = time.perf_counter()
        label = f"{mesh.shards} shard(s) on {sorted({str(d) for d in mesh.devices})}"
        crops = cfg.batch_size * mesh.shards
        data = pcnn.put_sharded_cnn_dataset(mesh, pcnn.shard_cnn_dataset(packed, mesh.shards))
        sides = {mode: pcnn.SPMDTrainStep(mesh, mcfg, cfg,
                                          timer=_eager_timer if mode == "eager" else None)
                 for mode in ("eager", "replay")}
        models = {mode: copy.deepcopy(start).to(mesh.devices[0]) for mode in sides}
        taken = dict.fromkeys(sides, 0)

        def run(mode):
            taken[mode] += 1
            return sides[mode](models[mode], data, taken[mode] - 1)

        losses, gaps = defaultdict(list), defaultdict(float)
        with _dumped_graphs():
            for _ in range(8):
                for mode in sides:
                    losses[mode].append(run(mode)["loss"].item())
                    gaps[mode] = max(gaps[mode], _replica_gap(sides[mode]))
        same = losses["replay"] == losses["eager"]
        while taken["replay"] < cfg.steps:
            losses["replay"].append(run("replay")["loss"].item())
            gaps["replay"] = max(gaps["replay"], _replica_gap(sides["replay"]))
        curve = losses["replay"]
        print(f"[spmd train {label}] 8 steps eager and replayed side by side from one set of "
              f"weights: bf16 losses equal bit for bit {same} "
              f"({', '.join(f'{v:.6f}' for v in losses['eager'])}); the replayed run to step "
              f"{cfg.steps}: first 5 {', '.join(f'{v:.4f}' for v in curve[:5])}, last 5 "
              f"{', '.join(f'{v:.4f}' for v in curve[-5:])}; replicas' largest difference after "
              f"every step (parameters, AdamW moments and counts against the first shard's): "
              f"eager {gaps['eager']:.3g}, replay {gaps['replay']:.3g}")
        _require(same, f"{label}: the replayed SPMD step's losses differ from the eager body's")
        _require(gaps["eager"] == 0 and gaps["replay"] == 0,
                 f"{label}: a shard's replica or AdamW state differs from the first shard's")
        _require(bool(np.isfinite(curve).all()) and np.mean(curve[-5:]) < np.mean(curve[:5]),
                 f"{label}: the replayed SPMD run's loss did not fall")

        wall, host = defaultdict(list), defaultdict(list)
        for mode in ("eager", "replay", "replay", "eager"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(10):
                t = time.perf_counter()
                run(mode)
                host[mode].append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            wall[mode].append((time.perf_counter() - t1) / 10 * 1e3)
        busy = {}
        for mode in sides:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run(mode)
                torch.cuda.synchronize()
            per_card = defaultdict(float)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    per_card[getattr(e, "device_index", 0)] += e.device_time / 5 / 1e3
            busy[mode] = dict(sorted(per_card.items()))
        local, updates = sides["replay"].captured
        nodes = [(_graph_nodes(a.graph), _graph_nodes(b.graph)) for a, b in zip(local, updates)]
        pools = [(a.pool_bytes, b.pool_bytes) for a, b in zip(local, updates)]
        for mode in sides:
            ms = statistics.median(wall[mode])
            print(f"[spmd train {label}] {mode}: {1e3 / ms:.2f} steps/s, {crops * 1e3 / ms:.1f} "
                  f"crops/s over {mesh.shards} shard(s) of {cfg.batch_size} (median of runs "
                  + ", ".join(f"{1e3 / w:.2f}" for w in wall[mode])
                  + f" steps/s, 10 steps each in turns: eager, replay, replay, eager); the host's "
                  f"ms a step {statistics.median(host[mode]):.3f} (min {min(host[mode]):.3f}, max "
                  f"{max(host[mode]):.3f}); busy ms a step by card (torch.profiler, 5 steps) "
                  + ", ".join(f"cuda:{d} {b:.3f} (idle {1 - b / ms:.1%})"
                              for d, b in busy[mode].items())
                  + f" of {ms:.3f} ms; {smi}")
        print(f"[spmd train {label} graphs] a shard's local and update graphs: nodes by type "
              + "; ".join(f"shard {i} {a} ({sum(a.values())}), {b} ({sum(b.values())})"
                          for i, (a, b) in enumerate(nodes))
              + "; pool bytes reserved by their captures "
              + ", ".join(f"shard {i} {a / 2**30:.3f} + {b / 2**30:.3f} GiB"
                          for i, (a, b) in enumerate(pools))
              + f"; replayed steps/s {statistics.median(wall['eager']) / statistics.median(wall['replay']):.2f}x "
              f"the eager in this call; {time.perf_counter() - t0:.1f} s")
        _require(all(a.get("kernel", 0) > 0 and b.get("kernel", 0) > 0 for a, b in nodes),
                 f"{label}: a shard's graph holds no kernel node")
        _require_no_sync(f"spmd train {label} replay", lambda: run("replay"), iters=4)
        del sides, models, data
        torch.cuda.empty_cache()
    print(f"[spmd train] phase 16i in {time.perf_counter() - t_phase:.1f} s; {smi}")


def _sync_sites(dispatch, iters: int) -> list[str]:
    """Where one window of ``iters`` dispatches makes the host wait for the
    card (``torch.cuda.set_sync_debug_mode("warn")``): the distinct file:line
    of each synchronising call, after a warm-up outside the window."""
    dispatch()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(iters):
                dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                   if "called a synchronizing" in str(w.message)})


def _require_no_sync(label: str, dispatch, iters: int = 2) -> None:
    """Phases 5-6, 12-14 and 16a: a window of ``iters`` dispatches, after a
    warm-up, in which the host never waits for the card: every shape on
    these paths is static, as under the reference's ``jax.jit``."""
    sites = _sync_sites(dispatch, iters)
    print(f"[{label} sync] host syncs in a window of {iters} dispatches (sync debug mode): "
          f"{sites}")
    _require(not sites, f"{label}: the dispatch makes the host wait for the card at {sites}")


def _eager_timer(name: str):
    """A stage timer that records nothing: a ``DetectionPipeline`` or a
    ``TrainStep`` with a timer runs eagerly, not as a graph replay."""
    return contextlib.nullcontext()


def _packed(pending) -> "np.ndarray":
    """A dispatch's packed result (``to_host``'s or ``RecognitionPipeline``'s
    pending handle) once its copies have arrived."""
    out, done = pending[:2]
    for event in done if isinstance(done, list) else [done] if done is not None else []:
        event.synchronize()
    return out.numpy().copy()


def _replay_vs_eager(label: str, dispatch, eager, host, control: bool = False) -> None:
    """The replayed dispatch's packed output against the eager one's, bit for
    bit, on ``host`` and on its frames in reverse order (so that a slot read
    from the wrong batch differs): each batch dispatched and collected in
    turn, then two in flight in both orders (the second dispatched before the
    first is collected).  ``dispatch(frames)`` -> pending handle (the graph
    captured already), ``eager(frames)`` -> packed numpy; ``host`` is an
    array of frames or a tuple of planes.  With ``control`` each batch runs
    eagerly twice: where the two differ (the card does not sum in one order
    run to run), the replay is held to that eager-against-eager gap, which
    is printed, and not to bit equality."""
    import numpy as np

    planes = host if isinstance(host, tuple) else (host,)
    rev = tuple(np.ascontiguousarray(p[::-1]) for p in planes)
    batches = [host, rev if isinstance(host, tuple) else rev[0]]
    n = len(planes[0])
    want = [eager(b) for b in batches]
    _require(want[0].tobytes() != want[1].tobytes() or n == 1,
             f"{label}: the two batches give the same output, so the check cannot see a swap")
    bound = [0.0, 0.0]
    if control:
        bound = [float(np.abs(eager(b) - w).max()) for b, w in zip(batches, want)]
        print(f"[{label} eager vs eager] the largest gap between two eager dispatches of each "
              f"batch, the replay's bound: {bound}")
    got = {"one at a time": [_packed(dispatch(b)) for b in batches]}
    for order, (i, j) in (("two in flight", (0, 1)), ("two in flight, reversed", (1, 0))):
        first, second = dispatch(batches[i]), dispatch(batches[j])
        pair = {i: _packed(first), j: _packed(second)}
        got[order] = [pair[0], pair[1]]
    same = {k: all(g.tobytes() == w.tobytes() if not b else float(np.abs(g - w).max()) <= b
                   for g, w, b in zip(v, want, bound)) for k, v in got.items()}
    print(f"[{label} replay] the graph's packed output against the eager dispatch's, "
          f"{'within the eager control' if any(bound) else 'bit for bit'}, on 2 batches of "
          f"{n}: {same}")
    _require(all(same.values()), f"{label}: the replayed dispatch differs from the eager one: "
             f"{same}")


def _cnn_run(det, x):
    """``det``'s dispatch of frames or patches8, or of a tuple of planes."""
    return det.dispatch_yuv(*x) if isinstance(x, tuple) else det.dispatch(x)


def _cnn_eager(det):
    """A copy of ``det`` that runs its routes eagerly; it shares ``det``'s
    net and graphs and captures nothing."""
    import copy

    eager = copy.copy(det)
    eager.eager = True
    return eager


def _cnn_pending(out):
    """A CNN dispatch's outputs packed as ``models/detector.py: _pack`` packs
    them and copied to pinned host memory on the current stream, before any
    later dispatch can rewrite them: a pending handle for :func:`_packed`."""
    from opencv_traffic_sign_detector_tpu_torch.models.detector import _pack

    packed = _pack(*out)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _cnn_replay_vs_eager(label: str, det, host) -> None:
    """:func:`_replay_vs_eager` of a CNN detector's dispatch, with the
    eager-against-eager control."""
    eager = _cnn_eager(det)
    _replay_vs_eager(label, lambda b: _cnn_pending(_cnn_run(det, b)),
                     lambda b: _packed(_cnn_pending(_cnn_run(eager, b))), host, control=True)


def _graph_calls():
    """Context: counts the graph captures (``graphs.capture_call``) and
    replays (``graphs.Captured.replay``) made inside it, in the dict it
    yields, with each capture's input and reserved bytes."""
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    seen = {"captures": [], "replays": 0}
    capture, replay = graphs.capture_call, graphs.Captured.replay

    def counted_capture(fn, device, args, what, *a, **kw):
        first, entry = capture(fn, device, args, what, *a, **kw)
        seen["captures"].append((what, entry.pool_bytes))
        return first, entry

    def counted_replay(self, *a, **kw):
        seen["replays"] += 1
        return replay(self, *a, **kw)

    @contextlib.contextmanager
    def ctx():
        graphs.capture_call, graphs.Captured.replay = counted_capture, counted_replay
        try:
            yield seen
        finally:
            graphs.capture_call, graphs.Captured.replay = capture, replay

    return ctx()


def _cnn_graph_report(label: str, det_graphs) -> None:
    """Each CNN graph of a ``CapturedFn`` (captured under
    :func:`_dumped_graphs`): its route, input, nodes by type
    (:func:`_graph_nodes`) and the bytes its capture reserved in the card's
    pool."""
    for (dev, shape, _, key, _), entry in det_graphs.entries().items():
        nodes = _graph_nodes(entry.graph)
        route = getattr(key, "name", None) or getattr(key[-1], "name", key)
        print(f"[{label} graph] {dev} route {route}, input {shape}: nodes by type {nodes} "
              f"({sum(nodes.values())} in all); its capture reserved "
              f"{entry.pool_bytes / 2**30:.3f} GiB for the card's graph pool "
              f"({torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved on the card)")
        _require(nodes.get("kernel", 0) > 0, f"{label}: the graph holds no kernel node")


def _cnn_turns(label: str, det, host, names: list[str], smi: str) -> None:
    """One CNN operating point replayed against eager in one call, through
    the server's dispatch/collect (``serve_detection_torch.py: _CNNPipe``,
    whose dispatch copies the outputs out before the next one): frames/s one
    batch at a time and two in flight in turns (:func:`_in_turns`); the
    host's ms a dispatch (``perf_counter`` around ``dispatch``, each batch
    collected before the next), 5 batches each way in turns; and the card's
    busy ms a batch by ``torch.profiler`` over 5 batches one at a time, its
    idle share of those batches' wall time."""
    import serve_detection_torch as serve
    from torch.profiler import ProfilerActivity, profile

    pipes = {"replay": serve._CNNPipe(det), "eager": serve._CNNPipe(_cnn_eager(det))}
    for pipe in pipes.values():
        pipe.collect(pipe.dispatch(host), names)     # the replay's graph captured
    b = len(names)
    gaps = _in_turns(pipes, host, names)
    spent = defaultdict(list)
    for _ in range(5):
        for mode, pipe in pipes.items():
            t0 = time.perf_counter()
            out = pipe.dispatch(host)
            spent[mode].append((time.perf_counter() - t0) * 1e3)
            pipe.collect(out, names)
    idle = {}
    for mode, pipe in pipes.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                pipe.collect(pipe.dispatch(host), names)
            wall = (time.perf_counter() - t0) / 5 * 1e3
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time for e in ev) / 5 / 1e3
        idle[mode] = (f"busy {busy:.3f} ms of {wall:.3f} ms a batch, {len(ev) / 5:.0f} CUDA "
                      f"kernels and copies a batch: idle {1 - busy / wall:.1%}")
    print(f"[cnn turns {label}] batch {b}, host frames to records through the server's "
          f"dispatch/collect, graph replay against eager in turns: "
          + "; ".join(f"{mode}: one batch at a time {_fps(b, gaps[mode, False])}, two in flight "
                      f"{_fps(b, gaps[mode, True])}" for mode in pipes) + f"; {smi}")
    print(f"[cnn enqueue {label}] host ms a dispatch of {b} frames, median (min, max) of 5 in "
          f"turns: " + "; ".join(f"{mode} {statistics.median(v):.3f} ({min(v):.3f}, "
                                 f"{max(v):.3f})" for mode, v in spent.items()) + f"; {smi}")
    print(f"[cnn idle {label}] torch.profiler, 5 batches one at a time: "
          + "; ".join(f"{mode} {v}" for mode, v in idle.items()) + f"; {smi}")


def _graph_report(label: str, captured, want: tuple = ()) -> None:
    """Each graph of a ``CapturedFn``: the launches its capture recorded (a
    replay's), which must hold every kernel of ``want``, and the bytes its
    capture reserved on its card for the card's graph pool."""
    for (dev, shape, *_), entry in captured.entries().items():
        launched = {k: v for k, v in entry.launches.items() if v}
        print(f"[{label} graph] {dev} input {shape}: kernels recorded at capture, a replay's "
              f"launches {launched}; its capture reserved {entry.pool_bytes / 2**30:.3f} GiB "
              f"for the card's graph pool ({torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB "
              "reserved on the card)")
        missing = [k for k in want if not launched.get(k)]
        _require(not missing, f"{label}: the graph on {dev} holds no launch of {missing}")


# the CUDA kernels each launch counter's wrapper launches
_ROLLS = ("rolls_tile_kernel", "rolls_window_kernel", "rolls_resident_kernel",
          "rolls_mask_kernel")
GRAPH_KERNELS = {"tile_luts": ("tile_hist_kernel", "tile_lut_kernel"),
                 "clahe_apply": ("clahe_apply_kernel",),
                 "level_sweep": ("sweep_tile_kernel", "scan_band_kernel"),
                 "flood_bbox": ("flood_bbox_kernel",),
                 "propagate_rolls": _ROLLS, "propagate_rolls_refine": _ROLLS}


@contextlib.contextmanager
def _dumped_graphs():
    """Context: graphs captured inside keep their ``cudaGraph_t``
    (``keep_graph=True``: instantiated at the first replay), so that
    :func:`_graph_kernel_names` can read the kernel nodes from it."""
    orig = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda: orig(keep_graph=True)
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = orig


def _graph_kernel_names(label: str, captured, want: tuple) -> None:
    """The kernel nodes of each graph of ``captured`` (captured under
    :func:`_dumped_graphs`), read from its ``debug_dump``: every counter of
    ``want`` must have one of its kernels in the graph."""
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import BUILD_ROOT

    path = BUILD_ROOT.parent / "chip_smoke_graph.dot"
    for (dev, shape, *_), entry in captured.entries().items():
        entry.graph.debug_dump(str(path))
        dot = path.read_text()
        path.unlink()
        nodes = {k: sum(dot.count(n) for n in names) for k, names in GRAPH_KERNELS.items()}
        print(f"[{label} graph nodes] {dev} input {shape}: the port's kernels in the captured "
              f"graph (debug_dump, {len(dot)} bytes) by counter "
              f"{ {k: v for k, v in nodes.items() if v} }")
        missing = [k for k in want if not nodes[k]]
        _require(not missing, f"{label}: the graph on {dev} holds no kernel node of {missing}")


def _batch_gaps(pipe, host, names: list[str], batches: int, in_flight: bool) -> list[float]:
    """Seconds between successive batches' records on the host's clock, over
    ``batches`` batches of ``host`` frames: each dispatched and collected in
    turn, or (``in_flight``) batch k+1 dispatched before batch k is
    collected, as ``run_directory`` runs them."""
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    pending = pipe.dispatch(host) if in_flight else None
    for k in range(batches):
        if in_flight:
            nxt = pipe.dispatch(host) if k + 1 < batches else None
            pipe.collect(pending, names)
            pending = nxt
        else:
            pipe.collect(pipe.dispatch(host), names)
        t.append(time.perf_counter())
    return [b - a for a, b in zip(t, t[1:])]


def _fps(batch: int, gaps: list[float]) -> str:
    return (f"{batch / statistics.median(gaps):.2f} frames/s (median of {len(gaps)} batches; "
            f"min {batch / max(gaps):.2f}, max {batch / min(gaps):.2f}; "
            f"{len(gaps) * batch / sum(gaps):.2f} over the runs)")


def _in_turns(pipes: dict, host, names: list[str], batches: int = 12) -> dict:
    """Each pipeline one batch at a time and two in flight, ``batches`` a
    run, in turns (A B B A for each): {(label, in_flight): gaps}."""
    gaps = defaultdict(list)
    for in_flight in (False, True, True, False):
        for label in (list(pipes) if in_flight else list(pipes)[::-1]):
            gaps[label, in_flight] += _batch_gaps(pipes[label], host, names, batches, in_flight)
    return gaps


def _same_detections(card, cpu) -> bool:
    """Phase 7's criterion: the same count, files and classes in order,
    boxes at IoU >= 0.99."""
    def iou(a, b):
        ix = max(0, min(a.x2, b.x2) - max(a.x1, b.x1))
        iy = max(0, min(a.y2, b.y2) - max(a.y1, b.y1))
        inter = ix * iy
        union = (a.x2 - a.x1) * (a.y2 - a.y1) + (b.x2 - b.x1) * (b.y2 - b.y1) - inter
        return inter / union if union else 1.0

    return len(card) == len(cpu) and all(
        a.filename == b.filename and a.class_id == b.class_id and iou(a, b) >= 0.99
        for a, b in zip(card, cpu))


# phase 17h: each stage's launches a replay, recorded at its capture (K1 runs
# inside tile_luts' launch)
STAGE_LAUNCHES = {
    "total": ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox"),
    "pre": ("tile_luts", "clahe_apply"),
    "downs_pad": (),
    "sweep": ("level_sweep",),
    "msr": ("level_sweep", "flood_bbox"),
    "post": (),
}


def _nested_equal(a, b) -> bool:
    """Tensors, or nested tuples of them, equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_nested_equal(x, y) for x, y in zip(a, b))


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else tuple(_clone(o) for o in x)


def _stage_replays(sp, dev, frames, red, blue, cfg) -> None:
    """Each stage of ``scripts/stage_profile_torch.py`` captured and replayed
    once on ``frames`` (each input a replayed upstream stage's output, cloned
    before the next replay), against its eager call on that input, bit for
    bit; then ``post(frames, *msr(pre(frames)))``, compacted, against
    ``total``'s replay."""
    from opencv_traffic_sign_detector_tpu_torch.models.detector import compact_first

    g = sp.stage_graphs()
    replayed, same = {}, {}
    with torch.inference_mode():
        for name, x, consts in [("total", frames, (red, blue)), ("pre", frames, ()),
                                ("downs_pad", "pre", ()), ("sweep", "downs_pad", ()),
                                ("msr", "pre", ()), ("post", "msr", (red, blue))]:
            if name == "post":
                x = (frames, *replayed["msr"])
            elif isinstance(x, str):
                x = replayed[x]
            g[name](dev, x, *consts, key=cfg)  # the capture
            replayed[name] = _clone(g[name](dev, x, *consts, key=cfg))
            same[name] = _nested_equal(replayed[name], getattr(sp, name)(cfg, x, *consts))
        boxes, types, scores, valid = replayed["post"]
        composed = _nested_equal(compact_first(valid, cfg.max_detections, boxes, types, scores),
                                 replayed["total"])
    print(f"[stage profile replay] {tuple(frames.shape[1:3])}, batch {len(frames)}: each stage's "
          f"replay against its eager call, bit for bit: {same}; post(frames, *msr(pre(frames))) "
          f"replayed and compacted against total's replay: {composed}")
    _require(all(same.values()) and composed,
             f"stage profile replays: {same}, composed {composed}")


def _run_twin(label: str, main_fn, argv: list[str], smi: str) -> list[str]:
    """``main_fn(argv)`` with its lines printed under ``label``, then its
    wall time beside the card's name and power limit; a non-zero exit
    raises."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"[{label}] {line}")
    print(f"[{label}] {' '.join(argv)}: {time.perf_counter() - t0:.1f} s; {smi}")
    _require(rc == 0, f"{label} {argv} exited {rc}")
    return lines


def _stage_profile_phases(rt, dev, smi: str) -> dict:
    """Phase 17h: ``scripts/stage_profile_torch.py`` at 1360x800 and 1088x1920
    (batch 16), each stage one capture and 20 replays, with its launches; the
    eager stage split on the same frames; each stage's replay against eager
    and the stages composed against ``total``; then the two CNN rate probes,
    ``scripts/mxu_peak_torch.py`` and ``scripts/int8_probe_torch.py``, with
    the probe's int8 conv on the card against an int32 sum on the CPU on one
    output tile.  -> {path: (launch counts, calls of every stage)}."""
    import numpy as np

    import bench_torch
    import int8_probe_torch
    import mxu_peak_torch
    import stage_profile_torch as sp
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        templates_to_torch,
    )
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    stage_of = {getattr(sp, name): name for name in STAGE_LAUNCHES}
    capture, replay, evict = graphs.capture_call, graphs.Captured.replay, graphs._evict
    made = {}  # id(Captured) -> (weak reference, stage)
    counts = defaultdict(lambda: [0, 0, {}])  # stage -> [captures, replays, launches a replay]
    evicted = defaultdict(int)

    def counted_capture(fn, device, args, *a, **kw):
        first, entry = capture(fn, device, args, *a, **kw)
        name = stage_of.get(getattr(fn, "func", None))
        if name is not None:
            made[id(entry)] = (weakref.ref(entry), name)
            counts[name][0] += 1
            counts[name][2] = dict(entry.launches)
        return first, entry

    def counted_replay(self, *a, **kw):
        held = made.get(id(self))
        if held is not None and held[0]() is self:
            counts[held[1]][1] += 1
        return replay(self, *a, **kw)

    def counted_evict(card, record):
        owner = record[0]()  # None: a function that is gone, pruned, not evicted
        if owner is not None:
            evicted[stage_of.get(owner.fn, "another phase's graph")] += 1
        return evict(card, record)

    def twin(label: str, main_fn, argv: list[str]) -> list[str]:
        return _run_twin(label, main_fn, argv, smi)

    t_phase = time.perf_counter()
    paths = {}
    for size, argv in (("gtsdb", []), ("1080p", ["--size", "1080p"])):
        counts.clear()
        made.clear()
        evicted.clear()
        rt.reset_launch_counts()
        graphs.capture_call, graphs.Captured.replay = counted_capture, counted_replay
        graphs._evict = counted_evict
        try:
            twin("stage_profile_torch", sp.main, argv)
        finally:
            graphs.capture_call, graphs.Captured.replay, graphs._evict = capture, replay, evict
        torch.cuda.synchronize()
        launched = rt.launch_counts()
        print(f"[stage profile graphs] {size}: " + "; ".join(
            f"{name} {caps} capture(s), {n} replays, "
            + (", ".join(f"{k} {v}" for k, v in rec.items() if v) or "no kernel") + " a replay"
            for name, (caps, n, rec) in counts.items())
            + f"; evicted at its misses: {dict(evicted) or 'none'}; the run's launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        want_launches = defaultdict(int)
        for name in STAGE_LAUNCHES:
            caps, n, rec = counts[name]
            _require(caps == 1 and n == 20, f"stage profile {size}: {name} made {caps} captures "
                     f"and {n} replays, not 1 and 20")
            _require({k for k, v in rec.items() if v} == set(STAGE_LAUNCHES[name])
                     and all(rec[k] == 1 for k in STAGE_LAUNCHES[name]),
                     f"stage profile {size}: {name} records {rec}, not {STAGE_LAUNCHES[name]} once")
            for k in STAGE_LAUNCHES[name]:
                want_launches[k] += 21  # the warm-up and 20 replays
        _require({k: v for k, v in launched.items() if v} == dict(want_launches),
                 f"stage profile {size}: launches {launched}, not {dict(want_launches)}")
        paths[f"stage profile {size} (the six stages a call)"] = (launched, 21)

        # the eager stage split (CUDA events between the stages) on the same frames
        cfg = sp.stage_config()
        frames = torch.from_numpy(bench_torch._load_frames(cfg.batch_size, size)).to(dev)
        red, blue = templates_to_torch(MeanMaskTemplates.load(
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                         "mean_masks.npz")), dev)
        with torch.inference_mode():
            det.detect_batch(frames, red, blue, cfg)
            timer = CudaStageTimer()
            for _ in range(10):
                det.detect_batch(frames, red, blue, cfg, timer)
            split = timer.per_batch_ms(10)
        print(f"[stage profile eager] {size}, batch {cfg.batch_size}, the same frames, "
              "detect_batch eager with the stage timer, CUDA-event ms a batch, mean of 10: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; sum {_stage_sum(split):.3f}; {smi}")
        if size == "gtsdb":
            _stage_replays(sp, dev, frames, red, blue, cfg)
        del frames
        torch.cuda.empty_cache()

    # the rate probes: no form may fail on the card
    lines = twin("mxu_peak_torch", mxu_peak_torch.main, [])
    _require(len(lines) == 7, f"mxu_peak_torch printed {lines}")
    kept = {}
    draws = int8_probe_torch.draws

    def kept_draws(*a, **kw):
        kept.update(draws(*a, **kw))
        return kept

    int8_probe_torch.draws = kept_draws
    try:
        lines = twin("int8_probe_torch", int8_probe_torch.main, [])
    finally:
        int8_probe_torch.draws = draws
    _require(len(lines) == 6 and not any("FAILED" in ln for ln in lines),
             f"int8_probe_torch printed {lines}")
    # one output tile of the int8 conv, the last frame's bottom-right 8x8
    # corner (the SAME padding on two edges), all 128 channels, against
    # the same sum in int32 numpy on the CPU
    x, k = kept["x_i"], kept["k_i"]
    with torch.inference_mode():
        y = int8_probe_torch.conv_int8(x, k)
    b, h, w, _ = x.shape
    tile = y[b - 1, h - 8:, w - 8:].cpu().numpy()
    xs = np.pad(x[b - 1, h - 9:, w - 9:].cpu().numpy().astype(np.int32), ((0, 1), (0, 1), (0, 0)))
    ks = k.cpu().numpy().astype(np.int32)
    want = sum(xs[ky:ky + 8, kx:kx + 8] @ ks[ky, kx] for ky in range(3) for kx in range(3))
    print(f"[int8_probe_torch tile] conv int8 on the card, output [{b - 1}, {h - 8}:{h}, "
          f"{w - 8}:{w}, :] against int32 numpy: equal {np.array_equal(tile, want)}, "
          f"|sum| up to {int(np.abs(want).max())}")
    _require(np.array_equal(tile, want), "int8_probe_torch: the card's int8 conv differs from "
             "the CPU's int32 sum")
    del kept, x, k, y
    torch.cuda.empty_cache()
    print(f"[stage profile] phase 17h in {time.perf_counter() - t_phase:.1f} s; {smi}")
    return paths


# phase 17i: the archs product mode times, and the CPU tests' bound on a
# variant's heads, card against CPU (a share of the CPU's largest |value|)
PRODUCT_ARCHS = ("base", "slim", "v2wide", "v2s16", "v2s16wide", "v3")
VARIANT_BOUND = 0.03


def _probe_phases(dev, smi: str) -> None:
    """Phase 17i: ``scripts/cnn_variants_torch.py`` for every variant at its
    defaults (batch 16, 1080p, 12 iterations) and at ``--size gtsdb``, each
    one capture and 12 replays, the last replay against the eager forward
    on the card bit for bit; each variant's forward at batch 2 of 128x192
    on the card against the CPU's with the same weights; product mode for
    :data:`PRODUCT_ARCHS` (one capture of ``run_route`` and 12 replays
    each); then ``scripts/tpu_microbench_torch.py`` for every case, one
    capture and its replays, the last replay's result against the case on
    the CPU on the same inputs (top_k: values equal, and ``x[idx]`` equal
    to them), and a replay of each case timed on the card's clock."""
    import numpy as np

    import cnn_variants_torch as cv
    import tpu_microbench_torch as tmb
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models.detector import full_f32_matmuls
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    full_f32_matmuls()
    ours = (cv.forward, tmb.run_case, cd.run_route)
    capture, replay, evict = graphs.capture_call, graphs.Captured.replay, graphs._evict
    made = []  # (the captured function, Captured) of this phase's functions
    replays = defaultdict(int)  # id(Captured) -> replays
    evicted = []

    def counted_capture(fn, device, args, *a, **kw):
        first, entry = capture(fn, device, args, *a, **kw)
        if getattr(fn, "func", None) in ours:
            made.append((fn, entry))
        return first, entry

    def counted_replay(self, *a, **kw):
        replays[id(self)] += 1
        return replay(self, *a, **kw)

    def counted_evict(card, record):
        owner = record[0]()  # None: a function that is gone, pruned, not evicted
        if owner is not None and owner.fn in ours:
            evicted.append(owner.fn.__name__)
        return evict(card, record)

    def run(label: str, main_fn, argv: list[str], want_replays: int):
        """The twin's lines and its one (function, Captured), which replayed
        ``want_replays`` times."""
        made.clear()
        replays.clear()
        lines = _run_twin(label, main_fn, argv, smi)
        _require(len(made) == 1 and replays[id(made[0][1])] == want_replays,
                 f"{label} {argv}: {len(made)} captures, "
                 f"{[replays[id(e)] for _, e in made]} replays, not 1 and {want_replays}")
        return lines, made.pop()

    t_phase = time.perf_counter()
    graphs.capture_call, graphs.Captured.replay, graphs._evict = (
        counted_capture, counted_replay, counted_evict)
    try:
        same = {}
        for size in ("1080p", "gtsdb"):
            for name in cv.VARIANTS:
                _, (fn, entry) = run("cnn_variants_torch", cv.main,
                                     ["--variant", name, "--size", size], 12)
                with torch.inference_mode():
                    eager = fn.args[0](entry.static)  # the variant's module
                same[f"{name} {size}"] = _nested_equal(
                    tuple(entry.outputs[k] for k in eager), tuple(eager.values()))
                del fn, entry, eager
        print(f"[cnn variants graphs] every variant at 1080p and gtsdb, batch 16: one capture "
              f"and 12 replays; the last replay against the eager forward, bit for bit: {same}")
        _require(all(same.values()), f"cnn variants: replays differ from eager: {same}")

        small = np.random.default_rng(0).integers(0, 256, (2, 128, 192, 3), np.uint8)
        gaps = {}
        for name in cv.VARIANTS:
            m = cd.init_params(cv.make_variant(name))
            with torch.inference_mode():
                cpu = m(torch.from_numpy(small))
                card = m.to(dev)(torch.from_numpy(small).to(dev))
            gaps[name] = max((card[k].cpu() - cpu[k]).abs().max().item()
                             / cpu[k].abs().max().item() for k in cpu)
        print(f"[cnn variants card vs cpu] batch 2 of 128x192, the same fresh weights, each "
              f"variant's largest head gap as a share of the CPU's largest |value| (bound "
              f"{VARIANT_BOUND}): " + ", ".join(f"{k} {v:.5f}" for k, v in gaps.items()))
        _require(max(gaps.values()) <= VARIANT_BOUND, f"cnn variants card vs cpu: {gaps}")

        for arch in PRODUCT_ARCHS:
            run("cnn_variants_torch", cv.main, ["--variant", "product", "--arch", arch], 12)

        results, card_ms = {}, {}
        bench = tmb.bench
        for case in tmb.CASES:
            kept = {}

            def kept_bench(fn, *a, **kw):
                t = bench(fn, *a, **kw)
                kept["out"] = _clone(fn(*a))  # one more replay
                return t

            tmb.bench = kept_bench
            try:
                _, (_, entry) = run("tpu_microbench_torch", tmb.main, [case],
                                    (2 if case == "top_k" else 5) + 1)
            finally:
                tmb.bench = bench
            # the card's time of a replay: one between CUDA events, and queued
            # behind a spin (the host's cost a call left out)
            card_ms[case] = (_time_ms(lambda: entry.replay(())),
                             _queued_ms(lambda: entry.replay(())))
            del entry
            x = tmb.inputs(case, "cpu")
            want, got = tmb.CASES[case](*x), kept.pop("out")
            if case == "top_k":
                values, idx = (t.cpu() for t in got)
                results[case] = bool(torch.equal(values, want.values)
                                     and torch.equal(x[0][idx], values))
            else:
                results[case] = bool(np.array_equal(got.cpu().numpy(), want.numpy()))
        print(f"[tpu microbench card vs cpu] every case one capture and its replays, the last "
              f"replay against the CPU on the same inputs, exact (top_k: values, and x[idx] "
              f"against them): {results}")
        _require(all(results.values()), f"tpu microbench card vs cpu: {results}")
        print("[tpu microbench card clock] ms a replay, one between CUDA events (median of 10) "
              "and queued: " + ", ".join(f"{k} {a:.4f} ({b:.4f})" for k, (a, b) in card_ms.items())
              + f"; {smi}")
    finally:
        graphs.capture_call, graphs.Captured.replay, graphs._evict = capture, replay, evict
    _require(not evicted, f"phase 17i: its graphs evicted at a miss: {evicted}")
    torch.cuda.empty_cache()
    print(f"[probes] phase 17i in {time.perf_counter() - t_phase:.1f} s; no graph of the phase "
          f"evicted; {smi}")


def _bench_phases(rt, dev, smi: str, seed: int) -> tuple[list[dict], dict, int, dict]:
    """Phase 17: the bench twin and the tool twins on the card.  -> (the
    kernel rows at the 1080p probe's shapes, {path: (launch counts,
    batches)}, the probe's batches, its float and int8 CNN detectors by
    checkpoint, with graphs of their own)."""
    import copy

    import numpy as np

    import bench_torch
    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import (
        write_gt_dir,
        write_train_dir,
    )
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import CNNDetector
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_quant import QuantCNNDetector
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        templates_to_torch,
    )
    from opencv_traffic_sign_detector_tpu_torch.ops import clahe_cuda, mser, mser_cuda, prop_cuda
    from opencv_traffic_sign_detector_tpu_torch.ops.yuv import patchify_yuv_planes
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import cnn_profile_torch
    import quality_probe_torch

    t_phase = time.perf_counter()
    work = rt.BUILD_ROOT.parent / "chip_smoke_bench"
    shutil.rmtree(work, ignore_errors=True)
    write_gt_dir(str(work / "test_alumnos_jpg"), 16, 800, 1360, seed=seed + 17)
    write_train_dir(str(work / "train_jpg"), seed=seed + 17)
    # the bench and the probe cache templates at the repository root
    cache = os.path.join(os.path.dirname(os.path.abspath(bench_torch.__file__)), "mean_masks.npz")
    had_cache = os.path.exists(cache)
    saved = bench_torch.DET_DATA, quality_probe_torch.DET
    bench_torch.DET_DATA = quality_probe_torch.DET = str(work)
    try:
        # --- 17a. K1 with its tail, K2, K3 and K4 at the 1080p probe's shapes
        cfg = PipelineConfig(mser=MSERConfig(max_variation=1.0, max_regions=128, downscale=2,
                                             ccl_iters=2, ccl_jumps=0, level_step=9,
                                             refine_scan_passes=2), batch_size=32)
        hd = bench_torch._load_frames(2 * cfg.batch_size, "1080p")   # the probe's frames
        hd_dev = torch.from_numpy(hd[:cfg.batch_size]).to(dev)
        red, blue = templates_to_torch(MeanMaskTemplates.load("artifacts/mean_masks.npz"), dev)
        calls = defaultdict(list)
        by_name = lambda name: lambda a, kw: name  # noqa: E731
        with contextlib.ExitStack() as stack:
            for target, attr, key in [(clahe_cuda, "tile_luts", by_name("tile_luts")),
                                      (clahe_cuda, "clahe_apply", by_name("clahe_apply")),
                                      (mser_cuda, "level_sweep_windows", by_name("level_sweep")),
                                      (mser, "flood_bbox", by_name("flood_bbox"))]:
                stack.enter_context(_recording(calls, target, attr, key))
            det.detect_batch(hd_dev, red, blue, cfg)
        torch.cuda.synchronize()
        inputs = {k: v[0] for k, v in calls.items()}
        lut_x, _, _, lut_tiles = inputs["tile_luts"][0]
        inputs["tile_histograms"] = ((lut_x, lut_tiles), {})
        windows, _, core, halo, nl, _ = inputs["level_sweep"][0]
        print(f"[bench kernels] the 1080p probe, batch {cfg.batch_size} of "
              f"{tuple(hd_dev.shape[1:3])}: K1/K2 on {tuple(lut_x.shape)} in {lut_tiles}x"
              f"{lut_tiles} tiles of {lut_x.shape[1] // lut_tiles}x{lut_x.shape[2] // lut_tiles}; "
              f"K3 on windows {tuple(windows.shape)}, {nl} levels, core {core}, halo {halo}; "
              f"K4 on {tuple(inputs['flood_bbox'][0][1].shape)} candidates")
        _require(halo == 0 and core == windows.shape[1],
                 f"the 1080p sweep is not one strip: core {core} halo {halo}")
        del calls, hd_dev
        pallas = "opencv_traffic_sign_detector_tpu/ops/"
        rows = []
        for name, mod, fn, plain_fn, src, replaces in [
            ("tile_histograms", clahe_cuda, "tile_histograms", "tile_histograms_plain",
             "csrc/clahe.cu", f"{pallas}clahe_pallas.py:66"),
            ("tile_luts", clahe_cuda, "tile_luts", "tile_luts_plain", "csrc/clahe.cu",
             f"{pallas}clahe.py:42"),
            ("clahe_apply", clahe_cuda, "clahe_apply", "clahe_apply_plain", "csrc/clahe.cu",
             f"{pallas}clahe_pallas.py:165"),
            ("level_sweep", mser_cuda, "level_sweep_windows", "level_sweep_windows_plain",
             "csrc/mser_sweep.cu", f"{pallas}mser_pallas.py:507"),
            ("flood_bbox", prop_cuda, "flood_bbox", "flood_bbox_plain", "csrc/flood.cu",
             f"{pallas}pallas_prop.py:234"),
        ]:
            a, kw = inputs[name]
            rows.append(_measure(f"{name}_1080p", getattr(mod, fn), getattr(mod, plain_fn), a,
                                 kw, src, replaces, smi, kind=name))
        # the scan-pass body with extent-only at the probe's strip, as the
        # bench's --scan_passes 2 --extent_only 1 runs it: K3, and K7 on the
        # strip's windows as planes, each against its plain version
        a, _ = inputs["level_sweep"]
        body = SWEEP_BODIES["combined"]
        rows.append(_measure("level_sweep_scan_1080p", mser_cuda.level_sweep_windows,
                             mser_cuda.level_sweep_windows_plain,
                             (a[0], dataclasses.replace(a[1], **body), *a[2:]), {},
                             "csrc/mser_sweep.cu", f"{pallas}mser_pallas.py:507", smi,
                             kind="level_sweep"))
        rows.append(_measure("level_sweep_full_scan_1080p", mser_cuda.fused_level_sweep_full,
                             mser_cuda.fused_level_sweep_full_plain,
                             (a[0], _body_config(cfg.mser, body), a[1].d, nl), {},
                             "csrc/mser_sweep.cu", f"{pallas}mser_pallas.py:569", smi,
                             kind="level_sweep_full"))
        del inputs, a, kw, lut_x, windows
        torch.cuda.empty_cache()

        # --- 17b-c. bench_torch.main: every scope, then the MSER one with
        # the 1080p probe; the MSER scopes' graphs counted by frame shape:
        # captures, replays and the launches each replay adds
        per_shape = defaultdict(lambda: [0, 0, defaultdict(int)])  # captures, replays, launches
        cnn_counts, cnn_graphs = {}, []
        bench_cnn = bench_torch._bench_cnn
        capture, replay = graphs.capture_call, graphs.Captured.replay
        eager_devices = graphs.CapturedFn.EAGER_DEVICES
        scope_graphs = {}  # the MSER scopes' graphs: {id: weak reference}

        def counted_capture(fn, device, args, *a, **kw):
            first, entry = capture(fn, device, args, *a, **kw)
            if getattr(fn, "func", None) is bench_torch._detect:
                scope_graphs[id(entry)] = weakref.ref(entry)
                per_shape[tuple(args[0].shape[1:3])][0] += 1
            return first, entry

        def counted_replay(self, *a, **kw):
            ref = scope_graphs.get(id(self))
            if ref is None or ref() is not self:
                return replay(self, *a, **kw)
            before = rt.launch_counts()
            out = replay(self, *a, **kw)
            entry = per_shape[tuple(self.static.shape[1:3])]
            entry[1] += 1
            for k, v in rt.launch_counts().items():
                entry[2][k] += v - before[k]
            return out

        def cnn_scopes(*a):
            rt.reset_launch_counts()
            with _graph_calls() as made:
                bench_cnn(*a)
            torch.cuda.synchronize()
            cnn_counts.update(rt.launch_counts())
            # printed after the bench, whose standard output is its JSON line
            cnn_graphs.append(
                f"[bench graphs] the CNN scopes: {len(made['captures'])} graph captures, each "
                "input and the GiB it reserved in the card's pool: "
                + "; ".join(f"{what.removeprefix('for input ')} {b / 2**30:.3f}"
                            for what, b in made["captures"])
                + f"; {made['replays']} replays; {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
                f"reserved on the card, peak {torch.cuda.max_memory_reserved() / 2**30:.2f}")
            _require(made["captures"] and made["replays"] > len(made["captures"]),
                     f"the CNN scopes made {len(made['captures'])} captures and "
                     f"{made['replays']} replays")

        def bench(argv, eager=False):
            """One run of the bench: its JSON line.  The MSER scopes' graphs
            must be one capture a shape, replayed at every later call (2
            more warm-ups and 2 timed batches at 1360x800, 4 at the probe's
            1088x1920), each replay launching K1 with its tail and K2-K4
            once; ``eager`` runs them eagerly instead (no check)."""
            per_shape.clear()
            scope_graphs.clear()
            out = io.StringIO()
            torch.cuda.reset_peak_memory_stats()
            bench_torch._bench_cnn = cnn_scopes
            graphs.capture_call, graphs.Captured.replay = counted_capture, counted_replay
            if eager:
                graphs.CapturedFn.EAGER_DEVICES = ("cpu", "cuda")
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    rc = bench_torch.main(argv)
            finally:
                bench_torch._bench_cnn = bench_cnn
                graphs.capture_call, graphs.Captured.replay = capture, replay
                graphs.CapturedFn.EAGER_DEVICES = eager_devices
            lines = out.getvalue().splitlines()
            _require(rc == 0 and len(lines) == 1, f"bench_torch.py {argv}: rc {rc}, {lines}")
            print(f"[bench] bench_torch.py {' '.join(argv)}{' eagerly' if eager else ''} in "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
                  f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved of the card's "
                  f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; its line "
                  f"(quality keys are smoke values on 16 synthetic frames): {lines[0]}")
            result = json.loads(lines[0])
            _require(result["device"] == torch.cuda.get_device_name(0),
                     f"bench device {result['device']}")
            if eager:
                _require(not per_shape, f"the eager bench captured or replayed {dict(per_shape)}")
                return result
            want = {(800, 1360): 4, (1088, 1920): 4}
            _require(set(per_shape) <= set(want) and (800, 1360) in per_shape,
                     f"the MSER scopes' graphs by shape: {sorted(per_shape)}")
            for (h, w), (caps, n, counts) in sorted(per_shape.items()):
                print(f"[bench launches] the MSER scope's graph at {h}x{w}: {caps} capture(s), "
                      f"{n} replays, " + ", ".join(f"{k} {v / n:g}" for k, v in counts.items()
                                                   if v) + " a replay")
                _require(caps == 1 and n == want[h, w], f"bench MSER at {h}x{w}: {caps} "
                         f"captures and {n} replays, not 1 and {want[h, w]}")
                for k in ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox"):
                    _require(counts[k] == n, f"bench MSER at {h}x{w}: {k} {counts[k]} launches "
                             f"in {n} replays")
            return result

        argv = ["--frames", "64", "--cnn_iters", "4", "--fed_batches", "2"]
        result = bench(argv)
        print(*cnn_graphs, sep="\n")
        print(f"[bench launches] the CNN scopes: {cnn_counts}")
        _require(cnn_counts and not any(cnn_counts.values()),
                 f"the CNN scopes launched {cnn_counts}")
        quality = [k for k in result if k.startswith(("cnn_f1", "cnn_ap", "mser_f1", "mser_ap"))]
        _require(len(quality) == 12 and all(0 <= result[k] <= 1 for k in quality),
                 f"quality keys {quality}")
        _require(all(result[k] > 0 for k in result if k.endswith("fps") or k == "value"),
                 "a bench rate is not positive")
        paths = {"bench MSER (gtsdb)": (dict(per_shape[(800, 1360)][2]),
                                        per_shape[(800, 1360)][1])}
        # the MSER scope and the probe replayed and eager in turns
        mser_argv = ["--model", "mser", "--frames", "64", "--skip_e2e"]
        rates = defaultdict(list)
        for mode in ("replay", "eager", "eager", "replay"):
            line = bench(mser_argv, eager=mode == "eager")
            rates[mode].append((line["value"], line["fps_1080p"]))
            if mode == "replay":
                _, n_hd, hd_counts = per_shape[(1088, 1920)]
        _require((800, 1360) in per_shape and (1088, 1920) in per_shape,
                 f"the probe's graphs: {sorted(per_shape)}")
        print("[bench mser] bench_torch.py --model mser --frames 64 --skip_e2e, in turns: "
              + "; ".join(f"{mode}: mser_fps {', '.join(str(v[0]) for v in r)}, fps_1080p "
                          f"{', '.join(str(v[1]) for v in r)}" for mode, r in rates.items())
              + f"; {smi}")
        paths["bench 1080p probe"] = (dict(hd_counts), n_hd)
        # the sweep's scan-pass and extent-only bodies together, both shapes
        bench(mser_argv + ["--scan_passes", "2", "--extent_only", "1"])
        _, _, scan_counts = per_shape[(1088, 1920)]
        # the scope's graph replayed against eager, bit for bit, at both shapes
        scope = graphs.CapturedFn(bench_torch._detect, keyed=True)
        for label, host in [("1360x800", bench_torch._load_frames(cfg.batch_size, "gtsdb")),
                            ("1088x1920", hd[:cfg.batch_size])]:
            scope(dev, torch.from_numpy(host).to(dev), red, blue, key=cfg)  # the capture
            _replay_vs_eager(
                f"bench MSER scope {label}",
                lambda b: _cnn_pending(scope(dev, torch.from_numpy(b).to(dev), red, blue,
                                             key=cfg)),
                lambda b: _packed(_cnn_pending(bench_torch._detect(
                    cfg, torch.from_numpy(b).to(dev), red, blue))), host)
        del scope
        for row in rows:
            row["launches"] = hd_counts[row["name"].removesuffix("_1080p")]
        by_row = {row["name"]: row for row in rows}
        by_row["level_sweep_scan_1080p"]["launches"] = scan_counts["level_sweep"]
        by_row["level_sweep_full_scan_1080p"]["launches"] = 0  # an oracle
        rows[0]["launches"] = hd_counts["tile_luts"]  # K1 runs inside tile_luts' launch

        # --- 17d. the probe's records on 2 frames against the CPU path --------
        templates = MeanMaskTemplates.load(cache)
        two = dataclasses.replace(cfg, batch_size=2)
        names = ["a.jpg", "b.jpg"]
        t0 = time.perf_counter()
        card = det.DetectionPipeline(cfg=two, templates=templates, device=dev).detect_frames(
            hd[:2], names)
        cpu = det.DetectionPipeline(cfg=two, templates=templates, device="cpu").detect_frames(
            hd[:2], names)
        same = _same_detections(card, cpu)
        print(f"[bench 1080p vs plain] 2 frames of 1088x1920 on the CPU in "
              f"{time.perf_counter() - t0:.1f} s: card {len(card)} cpu {len(cpu)} detections, "
              f"match {same}, identical {card == cpu}")
        _require(same, f"1080p probe: card {card} cpu {cpu}")

        # --- 17e. no host sync inside the CNN device-queue windows -----------
        fdet = CNNDetector.load(bench_torch.CNN_PARAMS, device=dev)
        qdet = QuantCNNDetector.load(os.path.join(os.path.dirname(bench_torch.CNN_PARAMS),
                                                  "params_int8.npz"), device=dev)
        frames = bench_torch._load_frames(32, "gtsdb")
        bgr = torch.from_numpy(frames).to(dev)
        p8 = torch.from_numpy(np.ascontiguousarray(
            frames.reshape(32, 100, 8, 170, 24).transpose(0, 1, 3, 2, 4)
            .reshape(32, 100, 170, 192))).to(dev)
        yuv = [torch.from_numpy(p).to(dev)
               for p in patchify_yuv_planes(*bench_torch._yuv420_planes(frames))]
        up_f, up_q = copy.copy(fdet), copy.copy(qdet)
        up_f.upscale = up_q.upscale = 1.6
        host = [bench_torch._pinned((frames[i * 16:(i + 1) * 16],), dev) for i in range(2)]
        sites, made = {}, {}
        for label, fn in [
            ("float patches8", lambda: fdet.dispatch(p8)), ("float bgr", lambda: fdet.dispatch(bgr)),
            ("float yuv420p", lambda: fdet.dispatch_yuv(*yuv)),
            ("int8 patches8", lambda: qdet.dispatch(p8)),
            ("int8 bgr 1.6", lambda: up_q.dispatch(bgr)),
            ("float bgr 1.6", lambda: up_f.dispatch(bgr)),
            ("fed bgr", lambda: bench_torch._fed(fdet.dispatch, host, dev)),
        ]:
            # the window's warm-up captures the route's graph (or replays it)
            with _graph_calls() as calls:
                sites[label] = _sync_sites(fn, 4)
            made[label] = (len(calls["captures"]), calls["replays"])
        print(f"[bench sync] host syncs in a window of 4 dispatches (sync debug mode): {sites}; "
              f"graph (captures, replays) with the warm-up: {made}")
        _require(not any(sites.values()), f"the device-queue windows sync the host: {sites}")
        # a window and its warm-up: 5 dispatches, the fed one 10 (2 batches a call)
        _require(all(c <= 1 and c + r == (10 if k == "fed bgr" else 5)
                     for k, (c, r) in made.items()),
                 f"a device-queue window did not replay its graph: {made}")
        del bgr, p8, yuv, up_f, up_q, host

        # the bench's device queue (patches8, batch 128) replayed against
        # eager in turns, and the copy into the graph's input
        frames = bench_torch._load_frames(128, "gtsdb")
        p8 = torch.from_numpy(np.ascontiguousarray(
            frames.reshape(128, 100, 8, 170, 24).transpose(0, 1, 3, 2, 4)
            .reshape(128, 100, 170, 192))).to(dev)
        del frames
        queue = {"replay": fdet, "eager": _cnn_eager(fdet)}
        for d in queue.values():
            d.dispatch(p8)
        rates, host_ms = defaultdict(list), defaultdict(list)
        for mode in ("replay", "eager", "eager", "replay", "replay", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                t = time.perf_counter()
                queue[mode].dispatch(p8)
                host_ms[mode].append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            rates[mode].append(4 * 128 / (time.perf_counter() - t0))
        entry = fdet.graphs.entries()[(dev, tuple(p8.shape), p8.dtype, fdet.route(p8), False)]
        with torch.inference_mode():  # the static input is an inference tensor
            copy_ms = _time_ms(lambda: entry.static.copy_(p8))
        print(f"[bench device queue] patches8 at batch 128, windows of 4 dispatches of one batch "
              f"on the card, in turns: " + "; ".join(
                  f"{mode} {statistics.median(v):.3f} frames/s (windows "
                  f"{', '.join(f'{r:.3f}' for r in v)}), host ms a dispatch "
                  f"{statistics.median(host_ms[mode]):.3f} ({min(host_ms[mode]):.3f}, "
                  f"{max(host_ms[mode]):.3f})" for mode, v in rates.items())
              + f"; the copy of the batch ({p8.numel() / 1e6:.1f} MB) into the graph's input "
              f"{copy_ms:.4f} ms (CUDA events, median of 10); its capture reserved "
              f"{entry.pool_bytes / 2**30:.3f} GiB; {smi}")
        # the detectors' nets for the graph memory phase, with graphs of their own
        detectors = {}
        for ckpt, d in (("params.npz", fdet), ("params_int8.npz", qdet)):
            detectors[ckpt] = copy.copy(d)
            detectors[ckpt].graphs = graphs.CapturedFn(d.graphs.fn, keyed=True)
        del p8, entry, queue, fdet, qdet

        # --- 17f-g. the profile twin and one quality twin -----------------------
        for label, main_fn, argv in [
            ("cnn_profile_torch", cnn_profile_torch.main, ["--size", "gtsdb", "--batch", "16"]),
            ("quality_probe_torch", quality_probe_torch.main, ["--limit", "4", "--tag",
                                                               "chip_smoke"]),
            ("quality_probe_torch", quality_probe_torch.main, ["--limit", "4", "--sweep_res",
                                                               "1", "--tag", "chip_smoke_res"]),
        ]:
            _run_twin(label, main_fn, argv, smi)
        for tag in ("chip_smoke", "chip_smoke_res"):
            os.unlink(os.path.join(tempfile.gettempdir(), f"probe_{tag}.txt"))

        # --- 17h. the stage profile twin and the two CNN rate probes --------------
        torch.cuda.empty_cache()
        paths.update(_stage_profile_phases(rt, dev, smi))

        # --- 17i. the CNN variant timer and the primitive microbench -------------
        _probe_phases(dev, smi)
    finally:
        bench_torch.DET_DATA, quality_probe_torch.DET = saved
        if not had_cache and os.path.exists(cache):
            os.unlink(cache)
        shutil.rmtree(work, ignore_errors=True)
    print(f"[bench] phase 17 in {time.perf_counter() - t_phase:.1f} s; {smi}")
    return rows, paths, n_hd, detectors


# phase 5b: the stages of detect_batch that the tracer stamps, in order of entry
TRACE_STAGES = ("preprocess", "sweep", "topk", "refine", "classify", "classify.crops",
                "classify.dedup", "classify.scores")


def _trace_phase(rt, dev, smi: str, frames, names: list[str], templates, mcfg,
                 batches: int = 8) -> None:
    """Phase 5b: the tracer (``runtime/trace.py``) on the card.  The stamp
    kernel (``csrc/stamp.cu``): four stamps with spins between them rise in
    stream order, fall between the host's reads around them once mapped onto
    the host's clock, and leave the launch counts alone.  Then the tuned
    slice through ``DetectionPipeline`` on ``frames``: its capture, then
    ``batches`` replays with one batch in flight, as the benchmark runs them.
    Every batch's stamps resolve in ``collect`` with every stage of
    ``detect_batch`` (the three ``classify.*`` inside ``classify``), each
    replay's stamps inside its host spans (``h2d`` after its ``replay``
    began, ``end`` before its ``wait`` ended), its outer stages within 3% of
    the graph's stamps and the ``classify.*`` within 3% of ``classify``, and
    its launches the graph's and the counts' own.  The tracer off captures
    anew, records nothing and answers alike.  Under ``torch.profiler`` the
    stamp that opens ``sweep``, mapped onto the host's clock, lies within 0.1
    ms of its stamp kernel and of the first kernel after it in the trace, once
    the profiler's own error at the batch's frames' copy is taken out.
    Then the card's gaps between batches by host span, and the clock's drift
    over the phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opencv_traffic_sign_detector_tpu_torch.config import PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.runtime import trace

    tracer = trace.TRACER
    size = "x".join(map(str, frames.shape[1:3]))
    t_phase = time.perf_counter()
    offset, err = tracer.calibrate(dev)
    before = rt.launch_counts()
    stamps = trace.Stamps(dev)
    t0 = time.perf_counter_ns()
    for slot in range(4):
        stamps.write(slot)
        torch.cuda._sleep(200_000)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter_ns()
    got = [v + offset for v in stamps.buf[:4].tolist()]
    steps = [(b - a) / 1e3 for a, b in zip(got, got[1:])]
    print(f"[trace stamp] clock offset {offset} ns, error {err} ns; four stamps with spins of "
          f"200k cycles between: steps {steps} us, the first {(got[0] - t0) / 1e3:.3f} us after "
          f"the host's read before them, the last {(t1 - got[-1]) / 1e3:.3f} us before its read "
          f"after; {smi}")
    _require(all(x > 0 for x in steps) and t0 - err <= got[0] and got[-1] <= t1 + err,
             f"trace stamp: stamps {got} outside the host's reads {t0}, {t1} (error {err})")
    _require(rt.launch_counts() == before, "trace stamp: the stamp kernel moved the launch counts")

    pipe = det.DetectionPipeline(cfg=PipelineConfig(mser=mcfg, batch_size=len(frames)),
                                 templates=templates, device=dev)
    tracer.reset()
    want = pipe.detect_frames(frames, names)  # the capture, stamped
    rt.reset_launch_counts()
    pending, answers = pipe.dispatch(frames), []
    for k in range(batches):
        nxt = pipe.dispatch(frames) if k + 1 < batches else None
        answers.append(pipe.collect(pending, names))
        pending = nxt
    torch.cuda.synchronize()
    counts = rt.launch_counts()
    ring = list(tracer.batches)
    ((_, (_, entry, entry_stamps)),) = pipe._detect.graphs._entries.items()
    entered = [n for n, kind in entry_stamps.marks if kind == trace.ENTER]
    _require(len(ring) == batches + 1 and ring[0].captured
             and not any(b.captured for b in ring[1:]),
             f"trace {size}: {len(ring)} batches, captured {[b.captured for b in ring]}")
    _require(all(b.devices and not b.pending for b in ring),
             f"trace {size}: a batch's stamps did not resolve in collect")
    _require(all(a == want for a in answers), f"trace {size}: a replay's records differ")
    _require(set(entered) == set(TRACE_STAGES)
             and [n for n in entered if n.startswith("classify")] == list(TRACE_STAGES[4:]),
             f"trace {size}: the graph stamps the stages {entered}")
    _require(all(b.launches == sum(entry.launches.values()) for b in ring)
             and counts == {k: v * batches for k, v in entry.launches.items()},
             f"trace {size}: launches {counts}, a batch's {[b.launches for b in ring]}")
    for b in ring[1:]:
        d = b.devices[0]
        spans = {s.name: s for s in b.spans}
        outer = sum(v for k, v in d.stages_ns.items() if "." not in k)
        inner = sum(v for k, v in d.stages_ns.items() if k.startswith("classify."))
        graph, classify = d.end_ns - d.first_ns, d.stages_ns["classify"]
        _require(spans["replay"].start_ns - err <= d.h2d_ns
                 and d.end_ns <= spans["wait"].end_ns + err,
                 f"trace {size}: batch {b.id}'s stamps fall outside its host spans")
        _require(0.97 * graph <= outer <= graph and 0.97 * classify <= inner <= classify,
                 f"trace {size}: batch {b.id}: stages {outer} of the graph's {graph} ns, "
                 f"classify.* {inner} of {classify}")
    mean = {k: statistics.mean(b.devices[0].stages_ns[k] for b in ring[1:]) / 1e6
            for k in TRACE_STAGES}
    h2d = statistics.mean((b.devices[0].first_ns - b.devices[0].h2d_ns) / 1e6 for b in ring[1:])
    graph = statistics.mean((b.devices[0].end_ns - b.devices[0].first_ns) / 1e6 for b in ring[1:])
    gaps = [(b.devices[0].h2d_ns - a.devices[0].end_ns) / 1e6
            for a, b in zip(ring[1:], ring[2:])]
    print(f"[trace replay] {size}, batch {len(frames)}, {batches} replays one in flight: ms a "
          f"batch by the graph's stamps " + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
          + f"; h2d {h2d:.3f}, graph {graph:.3f}, device gap {statistics.mean(gaps):.3f} (max "
          f"{max(gaps):.3f}); {len(entry_stamps.marks)} stamps a batch, stages entered "
          f"{entered}; launches a replay {sum(entry.launches.values())}; graph bytes held "
          f"{ring[0].held_bytes}; {smi}")

    trace.enable(False)
    try:
        held, kept = len(pipe._detect.graphs.entries()), len(tracer.batches)
        off = [pipe.detect_frames(frames, names) for _ in range(2)]  # a capture, a replay
    finally:
        trace.enable(True)
    _require(len(pipe._detect.graphs.entries()) == held + 1 and len(tracer.batches) == kept
             and all(a == want for a in off),
             f"trace {size}: with the tracer off {len(pipe._detect.graphs.entries())} graphs, "
             f"{len(tracer.batches)} batches recorded (before {held}, {kept})")

    # The profiler places the card's timeline against its host's with an error
    # of its own (24-800 us on an H100), which in some traces moves by tens of
    # microseconds a batch, most over its first batches, and it drops records
    # on the card (see _cuda_trace).  So each batch's error is read from its
    # own frames' copy (the large host-to-card copy that follows its h2d stamp)
    # and taken out, from the fifth batch of the trace on; a batch whose copy's
    # record was dropped is left out; up to 3 traces, the clock calibrated
    # before each.
    loop, settle, rows = 12, 4, []
    for attempt in range(3):
        last = tracer.batches[-1].id
        tracer.calibrate(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pending = pipe.dispatch(frames)
            for k in range(loop):
                nxt = pipe.dispatch(frames) if k + 1 < loop else None
                pipe.collect(pending, names)
                pending = nxt
            torch.cuda.synchronize()
        traced = [b for b in tracer.batches if b.id > last]
        events = prof.events()
        host = sorted((e for e in events if e.name == "tsd.dispatch"
                       and e.device_type != DeviceType.CUDA), key=lambda e: e.time_range.start)
        on_card = [e for e in events if e.device_type == DeviceType.CUDA]
        ranges = [e for e in on_card if e.name.startswith("tsd.")]
        kernels = sorted((e for e in on_card if not e.name.startswith("tsd.")
                          and not getattr(e, "is_user_annotation", False)),
                         key=lambda e: e.time_range.start)
        stamp_ev = [e for e in kernels if "stamp_kernel" in e.name]
        work = [e for e in kernels if "stamp_kernel" not in e.name and "Memcpy" not in e.name]
        copies = [e.time_range.start for e in kernels if "Memcpy HtoD" in e.name
                  and e.time_range.end - e.time_range.start > 500]
        _require(len(host) == len(traced) == loop, f"trace {size}: {len(host)} tsd.dispatch "
                 f"ranges for {len(traced)} batches")
        # the profiler's microseconds against perf_counter_ns, by the dispatch spans
        shift = statistics.median(e.time_range.start * 1e3 - b.start_ns
                                  for e, b in zip(host, traced))
        at = [e.time_range.start for e in stamp_ev]
        starts = [e.time_range.start for e in work]
        for b in traced[settle:]:
            d = b.devices[0]
            h2d = (d.h2d_ns + shift) / 1e3
            skew = min((c - h2d for c in copies), key=abs, default=math.inf)
            if abs(skew) > 5000:
                continue  # the record of its copy was dropped
            p = (d.opened_ns["sweep"] + shift) / 1e3 + skew
            i = min(range(len(at)), key=lambda j: abs(at[j] - p))
            k = bisect.bisect_left(starts, at[i])
            rows.append((p - at[i], starts[k] - p if k < len(work) else math.inf, skew))
        print(f"[trace profiler] {size}, trace {attempt + 1}: {len(host)} tsd.dispatch ranges for "
              f"{len(traced)} batches; {len(ranges)} tsd.* ranges on the card's timeline (user "
              f"annotations: {sum(bool(getattr(e, 'is_user_annotation', None)) for e in ranges)}); "
              f"{len(stamp_ev)} stamp kernels kept of {loop * len(entry_stamps.marks)}; "
              f"{len(rows)} batches from the fifth with their copy's record")
        if rows:
            break
    print(f"[trace clock] {size}: the stamp that opens sweep, on the host's clock, against the "
          f"profiler's trace once the profiler's own error at the batch's copy is taken out, us "
          f"(to its stamp kernel, to the first kernel after it; that error): "
          + "; ".join(f"{a:.1f}, {b:.1f}; {e:.1f}" for a, b, e in rows)
          + f"; the clock's error {tracer.clocks[dev][1]} ns; {smi}")
    _require(rows, f"trace {size}: the profiler dropped every batch's copy in 3 traces")
    _require(all(abs(a) < 100 and abs(b) < 100 for a, b, _ in rows),
             f"trace {size}: the sweep's stamp lies over 0.1 ms from its kernels: {rows}")

    labels = defaultdict(list)
    for label, a, b in trace.label_gaps(ring + traced):
        labels[label].append((b - a) / 1e6)
    again, _ = tracer.calibrate(dev)
    print(f"[trace gaps] {size}: the card's gaps between batches by host span, ms: "
          + "; ".join(f"{k} {len(v)} gaps, {sum(v):.3f} in all, longest {max(v):.3f}"
                      for k, v in labels.items())
          + f"; clock offset moved {again - offset} ns over {time.perf_counter() - t_phase:.1f} s")


# the graph memory phase's MSER frame sizes (height, width), in the order it
# runs them: GTSDB's, then VGA up to the bench's 1080p probe; each a whole
# number of CLAHE tiles and one strip of the fused sweep at --downscale 2
GRAPH_SIZES = ((800, 1360), (480, 640), (600, 800), (720, 1280), (768, 1024), (896, 1600),
               (1024, 1280), (1088, 1920))


def _by_pool(dev) -> dict:
    """Bytes reserved and allocated on ``dev`` by memory pool, from
    ``torch.cuda.memory_snapshot()``'s segments: {pool id: [reserved,
    allocated]}, (0, 0) the general cache, any other a graph's pool."""
    out = defaultdict(lambda: [0, 0])
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] == dev.index:
            pool = tuple(seg.get("segment_pool_id", (0, 0)))
            out[pool][0] += seg["total_size"]
            out[pool][1] += seg["allocated_size"]
    return out


def _graph_memory(dev, smi: str, seed: int, detectors: dict | None = None) -> None:
    """The graph memory phase: one process that meets many shapes and
    routes, as a server or a benchmark of several scopes does.
    ``DetectionPipeline`` at batch 32 over the 8 frame sizes of
    :data:`GRAPH_SIZES` one after another (a capture and a replay each),
    then the 12 CNN routes of :data:`CNN_ROUTES` at batch 32 on 1360x800
    (``detectors``: the float and int8 detectors by checkpoint, loaded when
    not given; every detector kept alive), then the first size again, its
    replay against eager bit for bit.  After each step: the captures it
    made and the bytes each reserved, ``memory_reserved`` and its split by
    pool (:func:`_by_pool`: the general cache, the graphs' pools), and the
    bytes the card's graph account holds against its budget
    (``runtime/graphs.py``).  Requires one capture a new shape or route and
    no eager fallback, ``memory_reserved`` after the eighth size within
    10% of its value after the fourth and at or under the budget plus the
    largest MSER graph after every step, and the first size dropped from
    the account by then and captured again."""
    import copy

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames_with_boxes
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_quant as cq
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import MeanMaskTemplates
    from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

    t_phase = time.perf_counter()
    gib = 2 ** 30
    total = torch.cuda.get_device_properties(dev).total_memory
    budget = graphs.budget_bytes(dev)
    hmax, wmax = max(GRAPH_SIZES)
    base, _ = make_frames_with_boxes(8, hmax, wmax, seed=seed + 21)

    def batch(h, w):
        return np.ascontiguousarray(np.tile(base[:, :h, :w], (4, 1, 1, 1)))

    cfg = PipelineConfig(mser=_tuned(MSERConfig.from_string("MSER_7_200_2000_1")), batch_size=32)
    pipe = det.DetectionPipeline(cfg=cfg, templates=MeanMaskTemplates.load(
        "artifacts/mean_masks.npz"), device=dev)
    names = [f"{i:05d}.jpg" for i in range(32)]
    gc.collect()  # the graphs of earlier phases' dropped pipelines and detectors
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[graph memory] start: {torch.cuda.memory_reserved(dev) / gib:.3f} GiB reserved of "
          f"the card's {total / gib:.2f}; the graph budget {budget / gib:.3f} GiB "
          f"({graphs.GRAPH_MEMORY_SHARE:g} of the card); {smi}")
    curve = []  # (label, GiB reserved after the step, each capture's GiB)

    def step(label, run):
        with _graph_calls() as made:
            try:
                run()
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                print(f"[graph memory] {label}: out of memory after {len(curve)} steps, "
                      f"{torch.cuda.memory_reserved(dev) / gib:.3f} GiB reserved; {smi}")
                raise
        caps = [b / gib for _, b in made["captures"]]
        reserved = torch.cuda.memory_reserved(dev) / gib
        free, _ = torch.cuda.mem_get_info(dev)
        pools = _by_pool(dev)
        general = pools.pop((0, 0), [0, 0])
        print(f"[graph memory] {len(curve) + 1:2d} {label}: {len(caps)} capture(s) reserving "
              f"{', '.join(f'{c:.3f}' for c in caps) or '-'} GiB, {made['replays']} replay(s); "
              f"reserved {reserved:.3f} GiB (peak {torch.cuda.max_memory_reserved(dev) / gib:.3f}):"
              f" general cache {general[0] / gib:.3f} ({general[1] / gib:.3f} allocated), "
              f"{len(pools)} graph pool(s) {sum(p[0] for p in pools.values()) / gib:.3f} "
              f"({sum(p[1] for p in pools.values()) / gib:.3f} allocated); mem_get_info "
              f"{(total - free) / gib:.3f} GiB in use; the account holds "
              f"{graphs.held_bytes(dev) / gib:.3f} GiB of {budget / gib:.3f}")
        # two calls: a capture (where the key is new) and a replay, never eager
        _require(len(caps) + made["replays"] == 2 and len(caps) <= 1,
                 f"graph memory {label}: {len(caps)} captures and {made['replays']} replays "
                 "in 2 calls")
        curve.append((label, reserved, caps))
        return caps

    for h, w in GRAPH_SIZES:
        host = batch(h, w)
        caps = step(f"MSER {w}x{h}", lambda: [pipe.detect_frames(host, names) for _ in range(2)])
        _require(len(caps) == 1, f"graph memory: {len(caps)} captures at {w}x{h}, not 1")
    inputs = _cnn_inputs(batch(800, 1360))
    loaded = dict(detectors or {})
    kept = []
    for label, ckpt, upscale, fmt, *_ in CNN_ROUTES:
        if ckpt not in loaded:
            loaded[ckpt] = cq.load_detector("artifacts/cnn_detector/" + ckpt, device=dev)
        d = copy.copy(loaded[ckpt])  # a copy shares its detector's graphs
        d.upscale = upscale
        kept.append(d)
        x = inputs[fmt]
        caps = step(f"CNN {label}", lambda: [_cnn_run(d, x) for _ in range(2)])
        _require(len(caps) == 1, f"graph memory: {len(caps)} captures for CNN {label}, not 1")
    h, w = GRAPH_SIZES[0]
    host = batch(h, w)
    again = step(f"MSER {w}x{h} again", lambda: [pipe.detect_frames(host, names)
                                               for _ in range(2)])
    _replay_vs_eager(f"graph memory {w}x{h} again", pipe.dispatch, _eager_packed(pipe), host)
    mser = [r for _, r, _ in curve[:len(GRAPH_SIZES)]]
    graph = max(c for _, _, caps in curve[:len(GRAPH_SIZES)] for c in caps)
    top = max(r for _, r, _ in curve)
    print(f"[graph memory] reserved after the 4th size {mser[3]:.3f} GiB, after the 8th "
          f"{mser[7]:.3f} ({mser[7] / mser[3]:.3f}x); the most after a step {top:.3f}, peak "
          f"{torch.cuda.max_memory_reserved(dev) / gib:.3f}; the largest MSER graph "
          f"{graph:.3f}; the first size captured again: {len(again) == 1}; "
          f"{time.perf_counter() - t_phase:.1f} s; {smi}")
    del kept, loaded, pipe
    _require(mser[7] <= 1.1 * mser[3], f"graph memory: {mser[7]:.3f} GiB reserved after the 8th "
             f"size against {mser[3]:.3f} after the 4th")
    _require(top <= budget / gib + graph, f"graph memory: {top:.3f} GiB reserved, over the "
             f"budget {budget / gib:.3f} plus one MSER graph {graph:.3f}")
    _require(len(again) == 1, "graph memory: the first size was never evicted")


def graph_memory(seed: int = 0) -> int:
    """The graph memory phase alone::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.graph_memory())"

    builds the kernels and runs :func:`_graph_memory`; a failed check
    raises."""
    _, smi = _device_phase()
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    rt.library()
    _graph_memory(dev, smi, seed)
    return 0


def stage_profile(seed: int = 0) -> int:
    """Phase 17h alone::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.stage_profile())"

    builds the kernels and runs :func:`_stage_profile_phases` on phase 17's
    synthetic frames; a failed check raises."""
    _, smi = _device_phase()
    import bench_torch
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_gt_dir
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    rt.library()
    work = rt.BUILD_ROOT.parent / "chip_smoke_bench"
    shutil.rmtree(work, ignore_errors=True)
    write_gt_dir(str(work / "test_alumnos_jpg"), 16, 800, 1360, seed=seed + 17)
    saved, bench_torch.DET_DATA = bench_torch.DET_DATA, str(work)
    try:
        paths = _stage_profile_phases(rt, dev, smi)
    finally:
        bench_torch.DET_DATA = saved
        shutil.rmtree(work, ignore_errors=True)
    for label, (counts, n) in paths.items():
        print(f"[launches a batch] {label}: "
              + ", ".join(f"{k} {v / n:g}" for k, v in counts.items() if v) + f" ({n} batches)")
    return 0


def tool_probes() -> int:
    """Phase 17i alone (the CNN variants and the microbench run none of the
    port's kernels, so nothing is built)::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.tool_probes())"

    a failed check raises."""
    _, smi = _device_phase()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _probe_phases(dev, smi)
    return 0


def _tuned(base):
    """``main_detection.py``'s defaults: MSER_7_200_2000_1 at the tuned
    ``--downscale 2`` point."""
    return dataclasses.replace(base, downscale=2, ccl_iters=2, level_step=9, ccl_jumps=0,
                               max_regions=128)


def trace_phase(seed: int = 0) -> int:
    """Phase 5b alone::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.trace_phase())"

    builds the kernels and runs :func:`_trace_phase` on phase 5's 32 frames
    and on 32 frames of 1088x1920; a failed check raises."""
    _, smi = _device_phase()
    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames_with_boxes
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import MeanMaskTemplates
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    rt.library()
    templates = MeanMaskTemplates.load("artifacts/mean_masks.npz")
    mcfg = _tuned(MSERConfig.from_string("MSER_7_200_2000_1"))
    for h, w in ((800, 1360), (1088, 1920)):
        frames, _ = make_frames_with_boxes(32, h, w, seed=seed)
        _trace_phase(rt, dev, smi, frames, [f"{i:05d}.jpg" for i in range(32)], templates, mcfg)
    return 0


def scale_out_detection(seed: int = 0) -> int:
    """Phase 16a alone, for a machine of several cards::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.scale_out_detection())"

    builds the kernels and runs :func:`_scale_out_detection` on the 32
    frames of phase 5; a failed check raises."""
    _, smi = _device_phase()
    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames_with_boxes
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import MeanMaskTemplates
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    rt.library()
    frames, _ = make_frames_with_boxes(32, 800, 1360, seed=seed)
    _scale_out_detection(rt, dev, smi, frames, MeanMaskTemplates.load("artifacts/mean_masks.npz"),
                         _tuned(MSERConfig.from_string("MSER_7_200_2000_1")))
    return 0


def scale_out_training(seed: int = 0) -> int:
    """Phase 16i and 16g's SPMD CNN step through a one-rank NCCL group,
    alone, for a machine of several cards (training runs none of the port's
    kernels, so nothing is built)::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.scale_out_training())"

    a failed check raises."""
    _, smi = _device_phase()
    from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as pm
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _scale_out_training(dev, smi, seed)
    with _one_rank_nccl(rt):
        _spmd_group_losses(pm.data_mesh(), seed)
    return 0


def train_phases(seed: int = 0) -> int:
    """Phases 14-15 alone (training and calibration run none of the port's
    kernels, so nothing is built)::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.train_phases())"

    a failed check raises."""
    _, smi = _device_phase()
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _train_phases(rt, dev, smi, seed)
    return 0


def cnn_phases(seed: int = 0) -> int:
    """Phases 8-9 alone (the CNN routes run none of the port's kernels, so
    nothing is built)::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.cnn_phases())"

    on phase 5's 32 frames; a failed check raises."""
    _, smi = _device_phase()
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames_with_boxes
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    frames, _ = make_frames_with_boxes(32, 800, 1360, seed=seed)
    _cnn_phases(rt, dev, frames, [f"{i:05d}.jpg" for i in range(len(frames))], smi)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's per-kernel register/shared-memory report")
    args = ap.parse_args()

    kind, smi = _device_phase()

    import numpy as np

    from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames_with_boxes
    from opencv_traffic_sign_detector_tpu_torch.models import detector as det
    from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
        MeanMaskTemplates,
        templates_to_torch,
    )
    from opencv_traffic_sign_detector_tpu_torch.ops import (
        ccl,
        clahe_cuda,
        mser,
        mser_cuda,
        prop_cuda,
    )
    from opencv_traffic_sign_detector_tpu_torch.ops.clahe import clahe_equalize
    from opencv_traffic_sign_detector_tpu_torch.ops.preprocess import enhance_contrast
    from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # --- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        rt.build(verbose=True)
    if args.ptxas:
        print(report.getvalue())
    rt.library()
    print(f"[build] {rt.build().relative_to(rt.BUILD_ROOT.parents[1])} "
          f"built and loaded in {time.perf_counter() - t0:.2f} s")
    # the tiled sweep's two outputs, K3 (kFull false) and K7 (kFull true)
    sweep_kernels = _ptxas_kernels(report.getvalue(), "sweep_tile_kernel")
    for name, props in sweep_kernels.items():
        mode = "K7, full map" if "ILb1E" in name else "K3, collapsed"
        print(f"[build] ptxas {name} ({mode}): {props}")
    if len(sweep_kernels) != 2:
        print(f"[build] ptxas: {len(sweep_kernels)} sweep_tile_kernel entries in the report")
    # the scan-pass body's band kernel, K3 (kFull false) and K7 (kFull true)
    for name, props in _ptxas_kernels(report.getvalue(), "scan_band_kernel").items():
        mode = "K7, full map" if "ILb1E" in name else "K3, collapsed"
        print(f"[build] ptxas {name} ({mode}): {props}")
    # K5's register forms, one template: rolls_window_kernel<Window>, <Window64>
    for name, props in _ptxas_kernels(report.getvalue(), "rolls_window_kernel").items():
        print(f"[build] ptxas {name} ({'64' if 'Window64' in name else '128'} px): {props}")
    # the minima and maxima instructions the card runs, which the sweep's and K5's
    # bounds count (SWEEP_OPS, ROLLS_OPS)
    for kernel in ("sweep_tile_kernel", "rolls_window_kernel"):
        for name, ops in _sass_minmax(rt.build(), kernel).items():
            print(f"[build] sass {name}: integer min/max instructions {ops}")

    # slice 1, the main path: MSER_7_200_2000_1, tuned --downscale 2 point
    base = MSERConfig.from_string("MSER_7_200_2000_1")
    mcfg = _tuned(base)
    # slice 2: main_detection.py --pixel_area_stability (XLA sweep, jumps)
    pcfg = dataclasses.replace(base, max_regions=128, downscale=2, fused_sweep=False)
    # the recall config of scripts/proposal_recall.py (XLA sweep, no jumps)
    rcfg = dataclasses.replace(base, downscale=2, ccl_iters=24, ccl_jumps=0,
                               level_step=3, max_regions=1024, fused_sweep=False)
    # the tuned config with the roll-flood refine (--refine_scan 0)
    fcfg = dataclasses.replace(mcfg, refine_scan_passes=0)
    # slice 9: the tuned config with each of the sweep's knobs; the low-res
    # refine with K4 and, with --refine_scan 0, K5
    knobs = {"extent_only": dataclasses.replace(mcfg, sweep_extent_only=True),
             "scan_passes 2": dataclasses.replace(mcfg, scan_passes=2),
             "sweep_res": dataclasses.replace(mcfg, sweep_res_pipeline=True)}
    xcfg = knobs["sweep_res"]
    xfcfg = dataclasses.replace(xcfg, refine_scan_passes=0)
    frames, signs = make_frames_with_boxes(32, 800, 1360, seed=args.seed)
    names = [f"{i:05d}.jpg" for i in range(len(frames))]
    templates = MeanMaskTemplates.load("artifacts/mean_masks.npz")
    red, blue = templates_to_torch(templates, dev)
    frames_dev = torch.from_numpy(frames).to(dev)

    # --- 3. kernels vs plain at the paths' shapes -------------------------
    pallas_prop = "opencv_traffic_sign_detector_tpu/ops/pallas_prop.py"
    kernels = [  # launch counter, module, kernel, plain version, source, TPU kernel
        ("tile_histograms", clahe_cuda, "tile_histograms", "tile_histograms_plain",
         "csrc/clahe.cu", "opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py:66"),
        # the reference's XLA steps between K1 and K2, no Pallas kernel
        ("tile_luts", clahe_cuda, "tile_luts", "tile_luts_plain",
         "csrc/clahe.cu", "opencv_traffic_sign_detector_tpu/ops/clahe.py:42"),
        ("clahe_apply", clahe_cuda, "clahe_apply", "clahe_apply_plain",
         "csrc/clahe.cu", "opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py:165"),
        ("level_sweep", mser_cuda, "level_sweep_windows", "level_sweep_windows_plain",
         "csrc/mser_sweep.cu", "opencv_traffic_sign_detector_tpu/ops/mser_pallas.py:507"),
        ("flood_bbox", prop_cuda, "flood_bbox", "flood_bbox_plain",
         "csrc/flood.cu", f"{pallas_prop}:234"),
        ("propagate_rolls", prop_cuda, "propagate_rolls", "propagate_rolls_plain",
         "csrc/prop_rolls.cu", f"{pallas_prop}:69"),
        ("propagate_rolls_pixel_area", prop_cuda, "propagate_rolls", "propagate_rolls_plain",
         "csrc/prop_rolls.cu", f"{pallas_prop}:69"),
        ("propagate_rolls_refine", prop_cuda, "propagate_rolls", "propagate_rolls_plain",
         "csrc/prop_rolls.cu", f"{pallas_prop}:69"),
        ("propagate_scan", prop_cuda, "propagate_scan", "propagate_scan_plain",
         "csrc/flood.cu", f"{pallas_prop}:137"),
        ("level_sweep_full", mser_cuda, "fused_level_sweep_full",
         "fused_level_sweep_full_plain", "csrc/mser_sweep.cu",
         "opencv_traffic_sign_detector_tpu/ops/mser_pallas.py:569"),
    ]
    calls = defaultdict(list)
    by_name = lambda name: lambda a, kw: name  # noqa: E731
    # K4's wrapper and K3's host function are bound into ops/mser.py's
    # namespace at import, K5 into ops/ccl.py's; K5 calls are keyed by site
    with contextlib.ExitStack() as stack:
        for target, attr, key in [
            (clahe_cuda, "tile_luts", by_name("tile_luts")),
            (clahe_cuda, "clahe_apply", by_name("clahe_apply")),
            (mser_cuda, "level_sweep_windows", by_name("level_sweep")),
            (mser, "flood_bbox", by_name("flood_bbox")),
            (mser, "fused_level_sweep", by_name("sweep_input")),
            (ccl, "propagate_rolls", lambda a, kw: a[4]),
        ]:
            stack.enter_context(_recording(calls, target, attr, key))
        det.detect_batch(frames_dev, red, blue, PipelineConfig(mser=mcfg))
        det.detect_batch(frames_dev[:8], red, blue, PipelineConfig(mser=rcfg))
        det.detect_batch(frames_dev, red, blue, PipelineConfig(mser=fcfg))
    area_calls = defaultdict(list)  # the pixel-area sweep's K5 calls apart
    with _recording(area_calls, ccl, "propagate_rolls", lambda a, kw: a[4]):
        det.detect_batch(frames_dev, red, blue, PipelineConfig(mser=pcfg))
    res_calls = defaultdict(list)  # the low-res refine's K4 and K5 calls apart
    with _recording(res_calls, mser, "flood_bbox", by_name("flood_bbox")), \
            _recording(res_calls, ccl, "propagate_rolls", lambda a, kw: a[4]):
        det.detect_batch(frames_dev, red, blue, PipelineConfig(mser=xcfg))
        det.detect_batch(frames_dev, red, blue, PipelineConfig(mser=xfcfg))
    torch.cuda.synchronize()

    inputs = {k: calls[k][0] for k in ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox")}
    lut_x, _, _, lut_tiles = inputs["tile_luts"][0]
    inputs["tile_histograms"] = ((lut_x, lut_tiles), {})
    sweep_rolls = calls["propagate_rolls"]  # one call per level of the recall sweep
    inputs["propagate_rolls"] = (sweep_rolls[len(sweep_rolls) // 2][0][:4], {})
    area_rolls = area_calls["propagate_rolls"]  # two calls per level, jumps between
    inputs["propagate_rolls_pixel_area"] = (area_rolls[len(area_rolls) // 2][0][:4], {})
    del area_calls, area_rolls
    inputs["propagate_rolls_refine"] = (calls["propagate_rolls_refine"][0][0][:4], {})
    planes, cand, win_h, win_w, passes, big = inputs["flood_bbox"][0]
    mask, seed = prop_cuda.candidate_windows(planes, cand, win_h, win_w)
    seed_map = torch.where(seed, 0, big).to(torch.int32)
    inputs["propagate_scan"] = ((seed_map, mask, big, passes), {})
    im2, scfg, d_idx, num_levels = calls["sweep_input"][0][0]
    inputs["level_sweep_full"] = ((im2, scfg, d_idx, num_levels), {})
    del calls, sweep_rolls

    table = []
    for name, mod, fn, plain_fn, src, replaces in kernels:
        a, kw = inputs[name]
        table.append(_measure(name, getattr(mod, fn), getattr(mod, plain_fn), a, kw, src,
                              replaces, smi))
    # K4 and K5 at the low-res refine's shapes: 4096 windows of 64x64 over
    # the small stack
    k4_res = res_calls["flood_bbox"][0]
    k5_res = (res_calls["propagate_rolls_refine"][0][0][:4], {})
    del res_calls
    print(f"[kernel] sweep_res refine: K4 on {tuple(k4_res[0][1].shape)} candidates, windows "
          f"{k4_res[0][2]}x{k4_res[0][3]} over {tuple(k4_res[0][0].shape)}; K5 on "
          f"{tuple(k5_res[0][0].shape)}")
    table.append(_measure("flood_bbox_sweep_res", prop_cuda.flood_bbox, prop_cuda.flood_bbox_plain,
                          *k4_res, "csrc/flood.cu", f"{pallas_prop}:234", smi, kind="flood_bbox"))
    table.append(_measure("propagate_rolls_sweep_res", prop_cuda.propagate_rolls,
                          prop_cuda.propagate_rolls_plain, *k5_res, "csrc/prop_rolls.cu",
                          f"{pallas_prop}:69", smi, kind="propagate_rolls_refine"))
    del k4_res
    # the sweep's extent-only, scan-pass and combined bodies
    table += _sweep_bodies(mser_cuda, inputs["level_sweep"][0], inputs["level_sweep_full"][0],
                           smi)
    rows = {row["name"]: row for row in table}
    all_gen = torch.Generator(device=dev).manual_seed(args.seed)
    _k5_all_passes(prop_cuda, inputs["propagate_rolls_refine"][0], "propagate_rolls_refine",
                   smi, all_gen)
    _k5_all_passes(prop_cuda, k5_res[0], "propagate_rolls_sweep_res", smi, all_gen)
    del k5_res
    # --- 4. identities between kernels ---------------------------------
    # K3 and K7 are the two outputs of one tiled kernel: the fold checks
    # that they agree; K7's independent check is its plain version (above)
    def identities():
        windows, params, core, halo, nl, lbits = inputs["level_sweep"][0]
        _require(halo == 0 and core == windows.shape[1],
                 f"tuned sweep is not single-strip: core {core} halo {halo}")
        _require(mser_cuda.SweepParams.from_config(scfg, d_idx) == params,
                 "K3's captured parameters differ from the sweep config's")
        k3 = mser_cuda.level_sweep_windows(windows, params, core, halo, nl, lbits)
        k7 = mser_cuda.fused_level_sweep_full(windows, scfg, d_idx, nl)
        fold = torch.zeros_like(k3)
        for t in range(nl):
            fold = torch.maximum(fold, k7[:, t].to(torch.int32) * (1 << lbits) + t)
        fold_ok = torch.equal(fold, k3)
        k4 = prop_cuda.flood_bbox(planes, cand, win_h, win_w, passes, big)
        k6 = prop_cuda.propagate_scan(seed_map, mask, big, passes)
        bbox_ok = torch.equal(prop_cuda.bbox_area(k6 == 0, big), k4)
        print(f"[identity] K7 fold == K3 (the two outputs of one tiled kernel) on "
              f"{tuple(windows.shape)} windows, {nl} levels: {fold_ok}; bbox(K6 == 0) == K4 on "
              f"{tuple(seed_map.shape)}: {bbox_ok}")
        _require(fold_ok and bbox_ok, "an identity between kernels failed")

    _, counts = _run_path(rt, "identities (K6, K7 as oracles)", identities)
    for name in ("propagate_scan", "level_sweep_full"):
        rows[name]["launches"] = counts[name]
        _require(counts[name] > 0, f"{name} never launched")
    for tag in ("extent", "scan", "combined"):
        _, counts = _run_path(rt, f"identities, {tag} body (K7 as an oracle)",
                              lambda: _body_fold(mser_cuda, inputs["level_sweep"][0], scfg,
                                                 d_idx, tag))
        if tag != "combined":
            rows[f"level_sweep_full_{tag}"]["launches"] = counts["level_sweep_full"]
        _require(counts["level_sweep_full"] > 0, f"K7's {tag} body never launched")
    _scan_strips(mser_cuda, mser, enhance_contrast, make_frames_with_boxes, base, dev,
                 args.seed, smi)
    _scan_bands(mser_cuda, inputs["level_sweep"][0], scfg)
    _sweep_shapes(mser_cuda, inputs["level_sweep"][0], scfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    _k4_shapes(prop_cuda, planes, cand, big, gen)
    _k2_shapes(clahe_cuda, clahe_equalize, lut_x, gen)
    _k5_shapes(prop_cuda, rt, gen)
    _k6_shapes(prop_cuda, gen)
    _k1_shapes(clahe_cuda, lut_x, gen)

    # --- 5. slice 1 through DetectionPipeline -----------------------------
    def run_slice(label, mcfg_, batch, timed, want):
        """One warm-up batch, which captures the dispatch's graph (holding a
        launch and a kernel node of each counter of ``want``), then
        ``timed`` timed batches of ``batch`` host frames run eagerly with
        the stage timer and ``timed`` replayed, each with the same launches;
        prints frames/s, stage ms and proposals per frame; the replays'
        output equals the eager one's bit for bit.  -> (proposals, valid,
        records, the replays' launch counts)."""
        pipe = det.DetectionPipeline(cfg=PipelineConfig(mser=mcfg_, batch_size=batch),
                                     templates=templates, device=dev)
        host = frames[:batch]
        with _dumped_graphs():
            pipe.detect_frames(host, names[:batch])  # warm-up batch: the graph captured
        torch.cuda.synchronize()
        _graph_report(label, pipe._detect.graphs, want)
        _graph_kernel_names(label, pipe._detect.graphs, want)
        # an eager batch first: the capture emptied the allocator's cache
        _eager_packed(pipe)(host)

        def timed_run():
            timer = CudaStageTimer()
            pipe.timer = timer
            batch_s = []
            for _ in range(timed):
                t0 = time.perf_counter()
                dets = pipe.detect_frames(host, names[:batch])
                batch_s.append(time.perf_counter() - t0)
            return dets, batch_s, timer.per_batch_ms(timed)

        tables = clahe_cuda._apply_tables.cache_info().misses
        (dets, batch_s, stage_ms), counts = _run_path(rt, label, timed_run)
        tables = clahe_cuda._apply_tables.cache_info().misses - tables
        _require(tables == 0, f"{label}: K2's plan tables were built and uploaded {tables} "
                 "times in the timed batches")
        props, pvalid = mser.mser_regions(enhance_contrast(frames_dev[:batch]), mcfg_)
        per_frame = pvalid.sum(-1).cpu().numpy()
        fps = batch / statistics.median(batch_s)
        print(f"[{label}] batch {batch} of 1360x800, {timed} timed batch(es): {fps:.2f} frames/s "
              f"on the host's clock (median; min {batch / max(batch_s):.2f}, max "
              f"{batch / min(batch_s):.2f}; batch s {', '.join(f'{s:.4f}' for s in batch_s)}); "
              f"device side {_stage_sum(stage_ms):.3f} ms per batch, the sum of the stages' "
              "CUDA-event ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
              + f"; proposals/frame min {per_frame.min()} mean {per_frame.mean():.2f}; "
              f"detections {len(dets)}; K2 plan uploads in the timed batches {tables}")
        _require(not (per_frame < 1).any(),
                 f"{label}: frames without proposals: {np.nonzero(per_frame < 1)[0]}")
        _require(all(np.isfinite(d.score) and 1 <= d.class_id <= 6 for d in dets),
                 f"{label}: malformed detection records")
        pipe.timer = None

        def replayed():
            batch_s = []
            for _ in range(timed):
                t0 = time.perf_counter()
                rdets = pipe.detect_frames(host, names[:batch])
                batch_s.append(time.perf_counter() - t0)
            return rdets, batch_s

        (rdets, batch_s), rcounts = _run_path(rt, f"{label} replay", replayed)
        print(f"[{label} replay] {timed} batch(es) replayed: "
              f"{batch / statistics.median(batch_s):.2f} frames/s on the host's clock (median; "
              f"min {batch / max(batch_s):.2f}, max {batch / min(batch_s):.2f}); launches as the "
              f"eager batches' {rcounts == counts}; records equal {rdets == dets}; {smi}")
        _require(rcounts == counts, f"{label}: {timed} replays launched {rcounts}, {timed} eager "
                 f"batches {counts}")
        _require(rdets == dets, f"{label}: replayed records differ from the eager ones")
        _replay_vs_eager(label, pipe.dispatch, _eager_packed(pipe), host)
        _require_no_sync(label, lambda: pipe.dispatch(host))
        return props, pvalid, dets, rcounts

    batches = defaultdict(lambda: 1)  # batches of each kernel's path's run
    props, pvalid, dets, counts = run_slice(
        "slice", mcfg, 32, 10, ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox"))
    for name in ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox"):
        rows[name]["launches"] = counts[name]
        batches[name] = 10
        _require(counts[name] > 0, f"slice 1: {name} never launched")
    # K1's kernel runs on this path only inside tile_luts (the same launch,
    # the tail in it): the tile_histograms wrapper itself is not called
    _require(counts["tile_histograms"] == 0, "slice 1 called K1 without its LUT tail")
    rows["tile_histograms"]["launches"] = counts["tile_luts"]
    batches["tile_histograms"] = 10
    _require_no_sync("slice detect_batch", lambda: det.detect_batch(
        frames_dev, red, blue, PipelineConfig(mser=mcfg)), 3)
    flight = {mode: det.DetectionPipeline(cfg=PipelineConfig(mser=mcfg, batch_size=32),
                                          templates=templates, device=dev, timer=timer)
              for mode, timer in (("replay", None), ("eager", _eager_timer))}
    for pipe_ in flight.values():
        pipe_.detect_frames(frames, names)  # warm-up batch
    gaps = _in_turns(flight, frames, names)
    print(f"[slice in flight] batch 32 of 1360x800, tuned MSER_7_200_2000_1, 24 batches each way "
          f"in turns, host frames to records on the host's clock, graph replay against eager: "
          + "; ".join(f"{mode}: one batch at a time {_fps(32, gaps[mode, False])}, two in flight "
                      f"(batch k+1 dispatched before batch k is collected) "
                      f"{_fps(32, gaps[mode, True])}" for mode in flight) + f"; {smi}")
    print(f"[slice enqueue] host ms a dispatch of 32 frames, median (min, max) of 5, graph "
          f"replay against eager: {_enqueue_ms(flight['replay'], frames, names)}; {smi}")
    del flight, gaps
    ours_names = ("tile_hist_kernel", "tile_lut_kernel", "clahe_apply_kernel")
    _, pre_counts = _run_path(rt, "slice preprocess", lambda: enhance_contrast(frames_dev))
    launched = [e.name for e in _cuda_trace(
        lambda: enhance_contrast(frames_dev),
        lambda ev: sum(any(k in e.name for k in ours_names) for e in ev) >= 2)]
    ours = [n for n in launched if any(k in n for k in ours_names)]
    print(f"[slice preprocess] one enhance_contrast call of {tuple(frames_dev.shape)}: "
          f"{len(launched)} CUDA kernels and copies traced by torch.profiler, "
          f"{len(ours)} of them this package's ({', '.join(ours_names)})")
    _require(pre_counts["tile_luts"] == 1 and pre_counts["clahe_apply"] == 1
             and sum(pre_counts.values()) == 2,
             f"enhance_contrast launched {pre_counts}, not K1 with its tail and K2 once each")
    # the same steps as before the LUT tail: K1 alone, then the plain clip,
    # cumsum and rounding
    from opencv_traffic_sign_detector_tpu_torch.ops.clahe import (
        _clip_and_redistribute,
        _tile_luts,
    )
    lx, lclip, larea, ltiles = inputs["tile_luts"][0]
    steps = len(_cuda_trace(lambda: _tile_luts(
        _clip_and_redistribute(clahe_cuda.tile_histograms(lx, ltiles), lclip), larea)))
    fused = len(_cuda_trace(lambda: clahe_cuda.tile_luts(lx, lclip, larea, ltiles)))
    print(f"[slice preprocess] histograms to LUTs of {tuple(lx.shape)}: K1 and the plain steps "
          f"{steps} CUDA kernels and copies, tile_luts {fused} (the fullest of 3 traces each)")
    _require(fused < steps, "tile_luts launches no fewer kernels than the plain steps")

    # --- 5b. the tracer on the card -----------------------------------------
    _trace_phase(rt, dev, smi, frames, names, templates, mcfg)

    # --- 6. slice 2: the XLA sweep paths ---------------------------------
    pprops, ppvalid, _, counts = run_slice(
        "slice2 pixel_area", pcfg, 32, 3,
        ("tile_luts", "clahe_apply", "flood_bbox", "propagate_rolls"))
    for name in ("tile_luts", "clahe_apply", "flood_bbox", "propagate_rolls"):
        _require(counts[name] > 0, f"slice 2: {name} never launched")
    _require(counts["level_sweep"] == 0, "slice 2 launched the fused sweep K3")
    rows["propagate_rolls_pixel_area"]["launches"] = counts["propagate_rolls"]
    batches["propagate_rolls_pixel_area"] = 3
    rprops, rpvalid, _, counts = run_slice(
        "slice2 recall", rcfg, 8, 1, ("tile_luts", "clahe_apply", "flood_bbox", "propagate_rolls"))
    rows["propagate_rolls"]["launches"] = counts["propagate_rolls"]
    _require(counts["propagate_rolls"] > 0 and counts["level_sweep"] == 0,
             "recall config: K5 never launched on the sweep, or K3 did")
    _, _, _, counts = run_slice(
        "slice2 roll refine", fcfg, 32, 1,
        ("tile_luts", "clahe_apply", "level_sweep", "propagate_rolls_refine"))
    rows["propagate_rolls_refine"]["launches"] = counts["propagate_rolls_refine"]
    _require(counts["propagate_rolls_refine"] > 0 and counts["flood_bbox"] == 0,
             "roll refine: K5 never launched on the refine, or K4 did")

    # --- 6b. slice 9: the sweep's knobs through DetectionPipeline ---------
    knob_runs = {}
    for label, cfg_ in knobs.items():
        kp, kv, kdets, counts = run_slice(
            f"slice9 {label}", cfg_, 32, 3, ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox"))
        for name in ("tile_luts", "clahe_apply", "level_sweep", "flood_bbox"):
            _require(counts[name] > 0, f"slice 9 {label}: {name} never launched")
        knob_runs[label] = (cfg_, kp[:2].cpu(), kv[:2].cpu(),
                            [d for d in kdets if d.filename in names[:2]])
        row, counter = {"extent_only": ("level_sweep_extent", "level_sweep"),
                        "scan_passes 2": ("level_sweep_scan", "level_sweep"),
                        "sweep_res": ("flood_bbox_sweep_res", "flood_bbox")}[label]
        rows[row]["launches"] = counts[counter]
        batches[row] = 3
    _, _, _, counts = run_slice(
        "slice9 sweep_res roll refine", xfcfg, 32, 1,
        ("tile_luts", "clahe_apply", "level_sweep", "propagate_rolls_refine"))
    rows["propagate_rolls_sweep_res"]["launches"] = counts["propagate_rolls_refine"]
    _require(counts["propagate_rolls_refine"] > 0 and counts["flood_bbox"] == 0,
             "low-res roll refine: K5 never launched on the refine, or K4 did")

    # --- 7. slices vs plain on the CPU -----------------------------------
    for label, cfg_, n, (p_dev, v_dev) in [("slice", mcfg, 2, (props, pvalid)),
                                           ("slice2 pixel_area", pcfg, 2, (pprops, ppvalid)),
                                           ("slice2 recall", rcfg, 1, (rprops, rpvalid))]:
        t0 = time.perf_counter()
        p_cpu, v_cpu = mser.mser_regions(enhance_contrast(torch.from_numpy(frames[:n])), cfg_)
        same = torch.equal(p_dev[:n].cpu(), p_cpu) and torch.equal(v_dev[:n].cpu(), v_cpu)
        print(f"[{label} vs plain] {n} frame(s) on the CPU in "
              f"{time.perf_counter() - t0:.1f} s: proposals identical {same} "
              f"({int(v_cpu.sum())} valid)")
        _require(same, f"{label}: proposals on the card differ from the CPU plain path")

    cpu_dets = det.DetectionPipeline(cfg=PipelineConfig(mser=mcfg), templates=templates,
                                     device="cpu").detect_frames(frames[:2], names[:2])
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
    print(f"[slice vs plain detections] 2 frames: card {len(gpu_dets)} "
          f"cpu {len(cpu_dets)} match {ok}")
    _require(ok, f"detections differ: card {gpu_dets} cpu {cpu_dets}")
    for label, (cfg_, p_dev, v_dev, card_dets) in knob_runs.items():
        t0 = time.perf_counter()
        # one plain run gives both: the proposals as detect_batch makes them
        proposals = []
        regions = det.mser_regions
        det.mser_regions = lambda *a, **kw: proposals.append(regions(*a, **kw)) or proposals[-1]
        try:
            cpu_knob = det.DetectionPipeline(cfg=PipelineConfig(mser=cfg_), templates=templates,
                                             device="cpu").detect_frames(frames[:2], names[:2])
        finally:
            det.mser_regions = regions
        p_cpu, v_cpu = proposals[0]
        same = torch.equal(p_dev, p_cpu) and torch.equal(v_dev, v_cpu)
        match = _same_detections(card_dets, cpu_knob)
        print(f"[slice9 {label} vs plain] 2 frames on the CPU in "
              f"{time.perf_counter() - t0:.1f} s: proposals identical {same} "
              f"({int(v_cpu.sum())} valid); detections card {len(card_dets)} cpu "
              f"{len(cpu_knob)} match {match}")
        _require(same and match, f"slice 9 {label}: the card differs from the CPU plain path")
    del knob_runs

    # --- 8-9. slice 3: the CNN detector ----------------------------------
    del props, pvalid, pprops, ppvalid, rprops, rpvalid, frames_dev
    torch.cuda.empty_cache()
    _cnn_phases(rt, dev, frames, names, smi)

    # --- 10-13. the server and práctica 2 --------------------------------
    work = rt.BUILD_ROOT.parent / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = _serve_phases(rt, dev, frames, work, smi)
    rec_rows, rec_paths = _recognition_phases(rt, dev, work, smi, args.seed)
    paths.update(rec_paths)
    for row in rec_rows:
        table.append(row)
        batches[row["name"]] = rec_paths["recognition MSER"][1]
    shutil.rmtree(work, ignore_errors=True)

    # --- 14-15. training and calibration --------------------------------
    torch.cuda.empty_cache()
    paths.update(_train_phases(rt, dev, smi, args.seed))

    # --- 16. scale-out ------------------------------------------------------
    torch.cuda.empty_cache()
    scale_paths, lda_row = _scale_out_phases(rt, dev, smi, frames, signs, templates, mcfg,
                                             args.seed)
    paths.update(scale_paths)
    table.append(lda_row)
    batches[lda_row["name"]] = 2  # its launches a shard

    # --- 17. the bench and the tool twins ---------------------------------
    torch.cuda.empty_cache()
    bench_rows, bench_paths, hd_batches, detectors = _bench_phases(rt, dev, smi, args.seed)
    paths.update(bench_paths)
    for row in bench_rows:
        table.append(row)
        batches[row["name"]] = hd_batches

    # --- 18. the graph memory phase ------------------------------------------
    _graph_memory(dev, smi, args.seed, detectors)
    del detectors
    for label, (counts, n) in paths.items():
        print(f"[launches a batch] {label}: "
              + ", ".join(f"{k} {v / n:g}" for k, v in counts.items() if v) + f" ({n} batches)")
    for name in ("jax", "flax", "optax"):
        _require(name not in sys.modules, f"the port imported {name}")
    ref = sorted(m for m in sys.modules if m.split(".")[0] == "opencv_traffic_sign_detector_tpu")
    _require(not ref, f"the port imported the reference package: {ref}")

    for row in table:
        n = batches[row["name"]]
        print(f"[table] {row['name']}: {row['launches']} launches on its path's run of {n} "
              f"batch(es), {row['launches'] / n:g} a batch; {row['ms']:.4f} ms (queued "
              f"{row['queued_ms']:.4f}) against a bound of {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); {smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
