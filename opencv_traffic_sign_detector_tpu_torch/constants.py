"""Class tables and shared constants for the GTSDB traffic-sign pipelines.

The port's own copy of ``opencv_traffic_sign_detector_tpu/constants.py``.

The six sign "super-types" group the 43 raw GTSRB class ids.  Parity contract
with the reference tables (reference: `Deteción de Objetos/constants.py:1-9`,
`Reconocimiento de Objetos/constants.py:1-19`, and the instructor remapping in
`Reconocimiento de Objetos/evaluar_resultados.py:125-143`).

Super-type ids (1-based; 0 is reserved for "no sign" / background):

    1  prohibicion            (speed limits & prohibitions: red-ring circles)
    2  peligro                (danger: red triangles)
    3  stop
    4  direccionProhibida     (no-entry)
    5  cedaPaso               (yield)
    6  direccionObligatoria   (mandatory: blue circles)
"""

from __future__ import annotations

# Ordered names of the six detectable super-types; index + 1 == super-type id.
SIGN_TYPES: tuple[str, ...] = (
    "prohibicion",
    "peligro",
    "stop",
    "direccionProhibida",
    "cedaPaso",
    "direccionObligatoria",
)

# Display names for the 7-way recognizer (index 0 is background).
SIGN_NAMES: tuple[str, ...] = (
    "NoSeñal",
    "Prohibicion",
    "Peligro",
    "Stop",
    "DirProhibida",
    "Ceda Paso",
    "DirObligatoria",
)

# Raw GTSRB class id -> super-type id (1..6).  Ids not present map to None
# ("ignore" in the PASCAL evaluation protocol, -1 there).
_PROHIBICION = (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 15, 16)
_PELIGRO = (11, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
_STOP = (14,)
_DIRECCION_PROHIBIDA = (17,)
_CEDA_PASO = (13,)
_DIRECCION_OBLIGATORIA = (38,)

GTSRB_TO_SUPERTYPE: dict[int, int] = {}
for _ids, _st in (
    (_PROHIBICION, 1),
    (_PELIGRO, 2),
    (_STOP, 3),
    (_DIRECCION_PROHIBIDA, 4),
    (_CEDA_PASO, 5),
    (_DIRECCION_OBLIGATORIA, 6),
):
    for _i in _ids:
        GTSRB_TO_SUPERTYPE[_i] = _st

# Directory names (zero-padded GTSRB class id) per super-type, used by the
# mean-mask trainer to locate per-class crops under train_jpg/<dir>/.
SUPERTYPE_CLASS_DIRS: tuple[tuple[str, ...], ...] = tuple(
    tuple(f"{i:02d}" for i in ids)
    for ids in (
        _PROHIBICION,
        _PELIGRO,
        _STOP,
        _DIRECCION_PROHIBIDA,
        _CEDA_PASO,
        _DIRECCION_OBLIGATORIA,
    )
)


def supertype_of(raw_class: int) -> int | None:
    """Map a raw GTSRB class id to its super-type id, or None if unmapped."""
    return GTSRB_TO_SUPERTYPE.get(int(raw_class))


# ---------------------------------------------------------------------------
# HSV color-threshold windows (OpenCV HSV convention: H in [0,179], S,V in
# [0,255]).  Two red hue bands are unioned; blue is a single band.
# Parity contract: `Deteción de Objetos/source.py:63-89`.
# ---------------------------------------------------------------------------
RED_LOW_BAND = ((0, 50, 10), (10, 255, 255))
RED_HIGH_BAND = ((160, 50, 10), (179, 255, 255))
BLUE_BAND = ((90, 70, 10), (128, 255, 255))

# ---------------------------------------------------------------------------
# HOG descriptor parameters for the 32x32 recognition crops
# (reference: `Reconocimiento de Objetos/constants.py:14`).
# 3x3 block grid x 2x2 cells x 9 bins = 324-dim descriptor.
# ---------------------------------------------------------------------------
HOG_WIN_SIZE = (32, 32)
HOG_BLOCK_SIZE = (16, 16)
HOG_BLOCK_STRIDE = (8, 8)
HOG_CELL_SIZE = (8, 8)
HOG_NBINS = 9
HOG_SIGNED_GRADIENT = True
HOG_DESCRIPTOR_DIM = 324

# Crop resolutions used by the two pipelines.
DETECT_CROP = 25  # Práctica 1: mask-correlation classifier operates on 25x25
RECOG_CROP = 32  # Práctica 2: HOG/GRAY features operate on 32x32

# Box growth factors applied to accepted MSER windows.
DETECT_GROW = 1.30  # `Deteción de Objetos/source.py:119`
RECOG_GROW = 1.15  # `Reconocimiento de Objetos/source.py:54`

# Aspect-ratio acceptance window for raw MSER boxes (w/h).
ASPECT_MIN = 0.8
ASPECT_MAX = 1.20

# Duplicate-suppression tolerances (two passes) and the merge band factor.
DEDUP_HIST_TOL = 0.85
DEDUP_COORD_TOL = 0.95
DEDUP_MERGE_BAND = 0.8823

# Mask-correlation acceptance threshold (Práctica 1).
MASK_CORR_TOL = 0.55

# "No sign" probability tolerance for the LDABAYES arbitration (Práctica 2).
NO_SIGN_TOL = 0.5

# IoU threshold below which an MSER training detection is mined as negative.
NEGATIVE_IOU_MAX = 0.5

# Greedy GT-match threshold for the built-in detection statistics.
STATS_MATCH_TOL = 0.85

# Default KNN neighbour count.
KNN_NEIGHBORS = 4
