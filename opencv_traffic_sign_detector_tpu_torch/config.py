"""Typed configuration + the reference-compatible CLI string grammar.

The port's own copy of ``opencv_traffic_sign_detector_tpu/config.py``: the
same dataclasses, defaults, validation and grammar, so one config value
means the same in both packages.

The reference encodes its detector configuration as the string
``MSER_<delta>_<minArea>_<maxArea>_<maxVariation>`` and its classifier as
``<FEATURES>_<REDUCER>_<CLASSIFIER>`` (reference: `Deteción de
Objetos/main.py:37-44`, `Reconocimiento de Objetos/main.py:25-29`,
`Reconocimiento de Objetos/constants.py:10-12`).  We keep that grammar for
compatibility and parse into frozen dataclasses.
"""

from __future__ import annotations

import dataclasses

FEATURE_DESCRIPTORS = ("HOG", "GRAY")
DIM_REDUCERS = ("LDA",)
CLASSIFIERS = ("LDABAYES", "KNN", "BAYES")  # "BAYES" accepted as LDABAYES alias


class ConfigError(ValueError):
    """Raised when a detector/classifier string fails validation."""


@dataclasses.dataclass(frozen=True)
class MSERConfig:
    """MSER region-proposal parameters (same meaning as OpenCV's)."""

    delta: int = 7
    min_area: int = 200
    max_area: int = 2000
    max_variation: float = 1.0
    # Framework knobs (no reference equivalent):
    level_step: int = 0  # gray-level threshold stride; 0 = auto (= delta)
    # Static padding capacity for proposals per frame.  Candidates are
    # stability-ranked, so a moderate cap acts as quality filtering too: the
    # reference's GTSDB runs found 256-384 above 1024 in F1/AP (junk
    # proposals crowd out downstream stages; PARITY.md).
    max_regions: int = 384
    min_diversity: float = 0.2  # OpenCV default, not exposed by the grammar
    # propagation iteration cap (2 rounds; early-exit below it; the
    # reference's full-set quality at 8 matches 12, PARITY.md)
    ccl_iters: int = 8
    ccl_jumps: int = 1  # pointer jumps per round (gathers; 0 = rolls only)
    # Fused level sweep (K3, ops/mser_cuda.py): stability from component
    # *bbox* areas.  The level-by-level sweep (ops/mser.py) runs instead
    # with ccl_jumps > 0 or when the frame has no strip plan.
    fused_sweep: bool = True
    # Upper area bound multiplier for the fused sweep's bbox-area filter
    # (bbox area >= pixel area; the exact pixel-area window is re-applied
    # post-refinement).  2.0 is the reference's best on the GTSDB set
    # (PARITY.md).
    bbox_area_cap_scale: float = 2.0
    # Scan-based propagation for the fused sweep: > 0 replaces the radius-1
    # roll passes with N full (horizontal + vertical) segmented run-resolve
    # passes — convergence bounded by a component's zigzag complexity
    # instead of its diameter.  Kept as an option only: full convergence
    # measurably HURTS sweep quality (the roll cap's radius truncation is a
    # load-bearing spatial band-pass — see PARITY.md).  0 = rolls (default).
    scan_passes: int = 0
    # Scan-based propagation for the bbox-refinement flood (separate knob:
    # unlike the sweep, where roll truncation is a load-bearing band-pass,
    # the refine flood wants the seed's *exact* component — full
    # convergence in 2-3 zigzag-bounded passes beats 96 radius-1 rolls on
    # both speed and accuracy).  0 = rolls.
    refine_scan_passes: int = 2
    # Extent-only fused sweep: propagate just keys + vertical extents and
    # use squared height as the area proxy (3 roll channels instead of 5).
    sweep_extent_only: bool = False
    # Candidate top-k pooling factor: stability maps are max-pooled
    # (pool x pool) with in-block argmax before the top-k (16x less top-k
    # work at pool=4).  1 = exact (rank every pixel).
    topk_pool: int = 4
    # MSER-stage spatial downscale (1 = native res; 2 = 2x2-mean half res
    # with area thresholds scaled by 1/4 — 4x fewer sweep pixels, slight recall
    # cost on the smallest signs).  Boxes are returned in native coords.
    downscale: int = 1
    # Low-res refinement (only meaningful with downscale > 1): run the
    # bbox-refinement flood at sweep resolution (64-px windows instead of
    # 128-px native windows, ~4x less flood + window-extraction work),
    # scaling boxes back to native coords.  Proposal geometry quantizes
    # to `downscale` px.  Divergence from the reference's native-res
    # refinement — end-to-end quality revalidated per round (PARITY.md).
    # Classification crops always come from the native-res BGR frame.
    sweep_res_pipeline: bool = False

    def __post_init__(self) -> None:
        if not (0 < self.delta <= 40):
            raise ConfigError(f"delta must be in (0, 40]: {self.delta}")
        if not (0 < self.min_area <= 20000):
            raise ConfigError(f"min_area must be in (0, 20000]: {self.min_area}")
        if not (0 < self.max_area <= 20000):
            raise ConfigError(f"max_area must be in (0, 20000]: {self.max_area}")
        if self.min_area > self.max_area:
            raise ConfigError("min_area must be <= max_area")
        if not (0 < self.max_variation <= 1):
            raise ConfigError(
                f"max_variation must be in (0, 1]: {self.max_variation}"
            )

    @classmethod
    def from_string(cls, spec: str, **overrides) -> "MSERConfig":
        """Parse ``MSER_<delta>_<minA>_<maxA>_<maxVar>``."""
        parts = spec.split("_")
        if len(parts) != 5 or parts[0] != "MSER":
            raise ConfigError(f"bad detector spec {spec!r}; expected "
                              "MSER_<delta>_<minArea>_<maxArea>_<maxVariation>")
        try:
            delta, min_a, max_a = int(parts[1]), int(parts[2]), int(parts[3])
            max_var = float(parts[4])
        except ValueError as e:
            raise ConfigError(f"bad detector spec {spec!r}: {e}") from None
        return cls(delta=delta, min_area=min_a, max_area=max_a,
                   max_variation=max_var, **overrides)

    def to_string(self) -> str:
        var = self.max_variation
        var_s = str(int(var)) if float(var).is_integer() else str(var)
        return f"MSER_{self.delta}_{self.min_area}_{self.max_area}_{var_s}"


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Recognition-stage configuration: features -> reducer -> classifier."""

    features: str = "HOG"
    reducer: str = "LDA"
    classifier: str = "LDABAYES"
    knn_neighbors: int = 4

    def __post_init__(self) -> None:
        if self.features not in FEATURE_DESCRIPTORS:
            raise ConfigError(f"unknown feature descriptor {self.features!r}")
        if self.reducer not in DIM_REDUCERS:
            raise ConfigError(f"unknown dimensionality reducer {self.reducer!r}")
        if self.classifier not in ("LDABAYES", "KNN"):
            raise ConfigError(f"unknown classifier {self.classifier!r}")

    @classmethod
    def from_string(cls, spec: str, **overrides) -> "ClassifierConfig":
        """Parse ``<FEAT>_<REDUCER>_<CLF>`` (e.g. HOG_LDA_BAYES)."""
        parts = spec.split("_")
        if len(parts) != 3:
            raise ConfigError(f"bad classifier spec {spec!r}; expected "
                              "<FEATURES>_<REDUCER>_<CLASSIFIER>")
        feat, red, clf = parts
        if clf == "BAYES":  # the reference's own default string spells it BAYES
            clf = "LDABAYES"
        if feat not in FEATURE_DESCRIPTORS:
            raise ConfigError(f"unknown feature descriptor {feat!r}")
        if red not in DIM_REDUCERS:
            raise ConfigError(f"unknown reducer {red!r}")
        if clf not in ("LDABAYES", "KNN"):
            raise ConfigError(f"unknown classifier {parts[2]!r}")
        return cls(features=feat, reducer=red, classifier=clf, **overrides)

    def to_string(self) -> str:
        return f"{self.features}_{self.reducer}_{self.classifier}"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration shared by both prácticas."""

    mser: MSERConfig = dataclasses.field(default_factory=MSERConfig)
    classifier: ClassifierConfig = dataclasses.field(
        default_factory=ClassifierConfig
    )
    # Static capacity of post-filter detections per frame (padded shape).
    max_detections: int = 128
    # Batch of frames processed per device step.
    batch_size: int = 8
    # Validation split fraction for the recognition harness.
    validation_pct: float = 0.1
    # Mask-correlation acceptance threshold (reference: 0.55).
    mask_corr_tol: float = 0.55
    # "No sign" probability tolerance for LDABAYES arbitration (reference: 0.5).
    no_sign_tol: float = 0.5
    # Report unrounded mask-correlation scores (framework knob; False =
    # reference parity).  Accept/type decisions always use the rounded
    # score; this only changes the reported ranking key — the AP
    # protocol sorts by score, and 2-decimal rounding is tie-heavy.
    fine_scores: bool = False
    # Sign-assertion margin for LDABAYES arbitration (framework knob; 0 =
    # reference parity).  A head asserts "sign" at p_sign >= 0.5 - margin,
    # trading precision for recall — the reference's tol dial is inert
    # below 0.5 (see models/recognizer.arbitrate_lda_heads).
    sign_margin: float = 0.0
    # Recognition proposal grow factors.  The reference grows every MSER
    # proposal by exactly 1.15 (`Reconocimiento de Objetos/source.py:54`);
    # passing several factors proposes the union of the grown sets —
    # MSER components are often a sign's *inner* region (the disc inside a
    # red rim), so a single small grow under-covers the GT box and caps
    # proposal recall (measured ceiling 0.62 @1.15 vs 0.66 @1.30 on the
    # GTSDB test set; see scripts/proposal_recall.py).  Downstream dedup
    # merges the overlaps.
    rec_grows: tuple[float, ...] = (1.15,)
