"""Per-stage failure isolation for the CLI orchestrators.

The reference wraps every orchestration stage in try/except, prints a
"TEST FALLIDO" banner with the exception, and stops cleanly instead of
spewing a traceback (`Deteción de Objetos/source.py:618-626`,
`Reconocimiento de Objetos/source.py:653-661`).  This module provides the
same contract for the CLIs: a ``stage`` context manager that converts
any exception into a one-line banner + :class:`StageError`, which the CLI
main catches to exit nonzero without a raw traceback.  The port's own copy
of ``opencv_traffic_sign_detector_tpu/utils/stages.py``.
"""

from __future__ import annotations

import contextlib
import os
import traceback

_BAR = "-" * 60


class StageError(RuntimeError):
    """A pipeline stage failed; the banner has already been printed."""

    def __init__(self, stage_name: str, cause: BaseException):
        super().__init__(f"stage {stage_name!r} failed: {cause}")
        self.stage_name = stage_name
        self.cause = cause


@contextlib.contextmanager
def stage(name: str):
    """Run a pipeline stage; on failure print a banner and raise StageError.

    KeyboardInterrupt/SystemExit pass through untouched; an inner
    StageError propagates unchanged (no double banner).  Set
    ``TSD_STAGE_TRACEBACK=1`` to append the full traceback for debugging.
    """
    try:
        yield
    except (KeyboardInterrupt, SystemExit, StageError):
        raise
    except Exception as e:  # noqa: BLE001 — the whole point is isolation
        print(_BAR)
        print(f"STAGE FAILED ({name}): {type(e).__name__}: {e}")
        print(_BAR)
        if os.environ.get("TSD_STAGE_TRACEBACK"):
            traceback.print_exc()
        raise StageError(name, e) from e
