"""Host-side image I/O (the port's own copy of
``opencv_traffic_sign_detector_tpu/data/images.py``).

Frames are decoded to BGR uint8 arrays (the channel order the whole framework
standardises on, matching the reference's OpenCV convention so the color
tables in :mod:`..constants` apply verbatim).

Decoding uses the native C++ loader (:mod:`..runtime.loader`) when it has been
built, falling back to PIL.  Reference equivalents: `Deteción de
Objetos/source.py:95-108` (directory iteration skips .txt files),
`Reconocimiento de Objetos/source.py:239-246` (dict filename -> image).
"""

from __future__ import annotations

import os

import numpy as np


def _pil_load_bgr(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return rgb[..., ::-1].copy()  # RGB -> BGR


def _native_loader():
    try:
        from ..runtime import loader as native

        return native if native.available() else None
    except Exception:
        return None


def load_image_bgr(path: str) -> np.ndarray:
    """Decode one image file to a BGR uint8 HxWx3 array."""
    native = _native_loader()
    if native is not None and path.lower().endswith((".jpg", ".jpeg")):
        img = native.decode_jpeg_bgr(path)
        if img is not None:
            return img
    return _pil_load_bgr(path)


def list_frame_files(directory: str, extensions: tuple[str, ...] = (".jpg",)) -> list[str]:
    """Sorted frame filenames in a dataset directory (skips gt.txt etc.)."""
    return sorted(
        f
        for f in os.listdir(directory)
        if f.lower().endswith(extensions) and not f.startswith(".")
    )


def load_directory_images(
    directory: str, extensions: tuple[str, ...] = (".jpg",)
) -> dict[str, np.ndarray]:
    """Load every frame in a directory into a dict filename -> BGR image."""
    files = list_frame_files(directory, extensions)
    native = _native_loader()
    if native is not None:
        decoded = native.decode_jpeg_bgr_batch(
            [os.path.join(directory, f) for f in files]
        )
        if decoded is not None:
            return dict(zip(files, decoded))
    return {f: load_image_bgr(os.path.join(directory, f)) for f in files}


def load_frames_batch(directory: str, files: list[str]) -> np.ndarray:
    """Decode a list of same-sized frames to one [B,H,W,3] uint8 array.

    Uses the native loader's pthread worker pool (runtime/loader.cpp) when
    available — ~N_threads x the single-file decode rate — with the
    per-file PIL path as fallback.
    """
    paths = [os.path.join(directory, f) for f in files]
    native = _native_loader()
    if native is not None and all(
        p.lower().endswith((".jpg", ".jpeg")) for p in paths
    ):
        decoded = native.decode_jpeg_bgr_batch(paths)
        if decoded is not None:
            return np.stack(decoded)
    return np.stack([load_image_bgr(p) for p in paths])


def load_frames_patches8_batch(
    directory: str, files: list[str]
) -> np.ndarray | None:
    """Frames decoded straight into the ``patches8`` stem layout
    [B, H/8, W/8, 192] uint8 (same bytes as BGR, repacked for free at
    decode time; see runtime/loader.py) — or None (caller falls back)."""
    paths = [os.path.join(directory, f) for f in files]
    native = _native_loader()
    if native is None or not all(
        p.lower().endswith((".jpg", ".jpeg")) for p in paths
    ):
        return None
    return native.decode_jpeg_bgr_patches8_batch(paths)


def load_frames_yuv420_batch(
    directory: str, files: list[str]
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Raw JPEG 4:2:0 planes for a same-sized frame batch, or None.

    Half-bandwidth counterpart of ``load_frames_batch``: returns
    (y [B,H,W], cb [B,ceil(H/2),ceil(W/2)], cr like cb) uint8 — 1.5
    bytes/px to ship host->device instead of BGR's 3; finish with
    ops.yuv.yuv420_to_bgr on device.  None when the native loader or the
    files' sampling layout is unavailable (caller falls back to BGR)."""
    paths = [os.path.join(directory, f) for f in files]
    native = _native_loader()
    if native is None or not all(
        p.lower().endswith((".jpg", ".jpeg")) for p in paths
    ):
        return None
    return native.decode_jpeg_yuv420_batch(paths)


def load_frames_yuv420_patches_batch(
    directory: str, files: list[str]
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Raw 4:2:0 planes in the PATCHIFIED layouts (y [B,H/8,W/8,64],
    cb/cr [B,H/8,W/8,16]) — same 1.5 bytes/px as the tight planes, zero
    on-device relayout (ops/yuv.py: yuv420_patches_to_bgr_patches8).
    Prefers the native loader's direct decode; falls back to tight planes
    + host repack; None when neither is available."""
    paths = [os.path.join(directory, f) for f in files]
    native = _native_loader()
    if native is None or not all(
        p.lower().endswith((".jpg", ".jpeg")) for p in paths
    ):
        return None
    planes = native.decode_jpeg_yuv420_patches_batch(paths)
    if planes is not None:
        return planes
    tight = native.decode_jpeg_yuv420_batch(paths)
    if tight is None or tight[0].shape[1] % 8 or tight[0].shape[2] % 8:
        return None
    from ..ops.yuv import patchify_yuv_planes

    return patchify_yuv_planes(*tight)


def stack_frames(
    images: dict[str, np.ndarray] | list[np.ndarray],
) -> tuple[list[str], np.ndarray]:
    """Stack same-shaped frames into one [B,H,W,3] uint8 batch array."""
    if isinstance(images, dict):
        names = sorted(images.keys())
        arrs = [images[n] for n in names]
    else:
        names = [str(i) for i in range(len(images))]
        arrs = list(images)
    return names, np.stack(arrs, axis=0)
