"""Host input pipeline: decode-ahead batching.

The port's copy of ``opencv_traffic_sign_detector_tpu/data/prefetch.py``,
host path only: it yields numpy batches, and the detectors upload them
(pinned, non-blocking) themselves.  Decodes and assembles the next frame
batch on a background thread while the device works on the current one.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .images import (
    load_frames_batch,
    load_frames_patches8_batch,
    load_frames_yuv420_batch,
    load_frames_yuv420_patches_batch,
)


def batched_frames(
    directory: str,
    files: list[str],
    batch_size: int,
    prefetch: int = 2,
    input_format: str = "bgr",
):
    """Yield (frames [B,H,W,3], names [B]) with background decode-ahead.

    The tail batch is padded by repeating the last frame; padded slots get
    the name "__pad__".

    ``input_format`` selects the decode layout:

    * ``"bgr"``      — [B, H, W, 3] uint8 (default; cv2.imread parity).
    * ``"yuv420"``   — items are ((y, cb, cr), names): raw JPEG 4:2:0
      planes at 1.5 bytes/px, half the upload of BGR; consume with
      ``CNNDetector.dispatch_yuv``.
    * ``"yuv420p"``  — same planes PATCHIFIED at decode time
      (y [B,H/8,W/8,64], cb/cr [B,H/8,W/8,16]): same bytes, converted with
      no on-device relayout (ops/yuv.py: yuv420_patches_to_bgr_patches8).
      Falls back to tight planes, then to BGR.
    * ``"patches8"`` — [B, H/8, W/8, 192] uint8: same bytes as BGR,
      repacked at decode time into the stem's matmul layout.

    Both non-BGR formats fall back to BGR items automatically when the
    native decoder is unavailable, so callers must key on the item's
    structure (tuple-of-3, or ndim/last-dim).
    """

    def assemble(chunk: list[str]):
        names = list(chunk)
        pad = batch_size - len(chunk)
        if input_format in ("yuv420", "yuv420p"):
            if input_format == "yuv420p":
                # patchified planes (no on-device relayout); falls back to
                # tight planes, then to BGR frames
                planes = load_frames_yuv420_patches_batch(directory, chunk)
                if planes is None:
                    planes = load_frames_yuv420_batch(directory, chunk)
            else:
                planes = load_frames_yuv420_batch(directory, chunk)
            if planes is not None:
                if pad:
                    planes = tuple(
                        np.concatenate([p, p[-1:].repeat(pad, 0)])
                        for p in planes
                    )
                    names += ["__pad__"] * pad
                return planes, names
        frames = None
        if input_format == "patches8":
            frames = load_frames_patches8_batch(directory, chunk)
        if frames is None:
            # threaded native batch decode (runtime/loader.cpp worker pool)
            frames = load_frames_batch(directory, chunk)
        if pad:
            frames = np.concatenate([frames, frames[-1:].repeat(pad, 0)])
            names += ["__pad__"] * pad
        return frames, names

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            for start in range(0, len(files), batch_size):
                if stop.is_set():
                    return
                q.put(assemble(files[start : start + batch_size]))
        except Exception as e:  # surface decode errors on the consumer side
            q.put(e)
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        # drain so the producer can exit promptly
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
