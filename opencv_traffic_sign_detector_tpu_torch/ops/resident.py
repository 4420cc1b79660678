"""Constants and weight matrices a dispatch needs on its device, copied
there once.

A copy from pageable host memory to a card ends in
``cudaStreamSynchronize``: the host waits until the card has run all the
work queued before it.  A dispatch that made its constants on the card at
every call would wait for the batch before it, and no batch could queue
behind another (``bench_torch.py``'s device-queue windows and the MSER and
recognition dispatches; ``chip_smoke.py`` checks them with
``torch.cuda.set_sync_debug_mode``).  :func:`resident` makes each one once
per device; :func:`const_f32` is its f32 scalar, the one way the port makes
a dispatch constant.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``dtype``, rounded to it from the
    Python float (as ``jnp.asarray(value, dtype)``)."""
    return torch.tensor(value, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _resident(make, args: tuple, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first made under inference_mode
    with torch.inference_mode(False):
        out = make(*args)
        return (torch.from_numpy(out) if isinstance(out, np.ndarray) else out).to(device)


def resident(make, *args, device) -> torch.Tensor:
    """``make(*args)``, a CPU tensor or a numpy array, on ``device``: made
    and copied at the first call with these arguments, then shared, so
    callers must not write into it.  ``make`` is a module-level function
    and ``args`` are hashable."""
    return _resident(make, args, torch.device(device))


def const_f32(value: float, device) -> torch.Tensor:
    """``value`` rounded to f32 (as ``torch.tensor(value, dtype=float32)``
    rounds it), resident on ``device``: ``resident(scalar, value,
    torch.float32, device=device)``."""
    return resident(scalar, value, torch.float32, device=device)
