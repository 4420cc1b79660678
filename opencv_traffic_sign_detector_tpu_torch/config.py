"""Configuration types, shared with the reference package.

``MSERConfig``/``PipelineConfig`` and the CLI string grammar live in the
reference's framework-free ``config`` module; the port uses them as they
are, so one config value means the same in both packages.
"""

from opencv_traffic_sign_detector_tpu.config import (  # noqa: F401
    ConfigError,
    MSERConfig,
    PipelineConfig,
)
