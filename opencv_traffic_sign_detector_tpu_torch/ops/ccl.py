"""Component-wise minimum of per-pixel int32 keys by masked min propagation.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/ccl.py:
propagate_min_keys``, the propagation step of the XLA level sweep and of the
roll-flood refine.  The roll passes run through kernel K5
(:func:`.prop_cuda.propagate_rolls`) at every plane size and rank: the
reference takes its Pallas kernel only for rank-3 stacks that fit VMEM and
otherwise the same passes as XLA rolls, which compute the same keys.
"""

from __future__ import annotations

import torch

from .prop_cuda import propagate_rolls


def _jump(k: torch.Tensor, big: int) -> torch.Tensor:
    """Pointer jump on [P, H, W] keys: each key takes the key of the pixel its
    low bits name (``key % (H*W)``) when that is smaller."""
    p, h, w = k.shape
    flat = k.reshape(p, h * w)
    jumped = torch.gather(flat, 1, (flat % (h * w)).long())
    return torch.where(flat < big, torch.minimum(flat, jumped), big).reshape(p, h, w)


def propagate_min_keys(keys: torch.Tensor, mask: torch.Tensor, big: int,
                       num_rolls: int = 12, num_jumps: int = 1,
                       edges_safe: bool = False,
                       site: str = "propagate_rolls") -> torch.Tensor:
    """keys int32 / mask bool [..., H, W] -> propagated keys, same shape.

    Two rounds of ``num_rolls`` masked 4-neighbour min passes (wrapping),
    each followed by ``num_jumps`` pointer jumps.  Without ``edges_safe`` a
    background ring is added, jumps are off (the embedded indices would not
    match the padded lattice) and the ring is stripped afterwards.  ``site``
    names K5's launch counter.
    """
    if not edges_safe:
        *lead, h, w = keys.shape
        keys_p = torch.full((*lead, h + 2, w + 2), big, dtype=keys.dtype, device=keys.device)
        mask_p = torch.zeros((*lead, h + 2, w + 2), dtype=torch.bool, device=mask.device)
        keys_p[..., 1:-1, 1:-1] = keys
        mask_p[..., 1:-1, 1:-1] = mask
        out = propagate_min_keys(keys_p, mask_p, big, num_rolls=num_rolls, num_jumps=0,
                                 edges_safe=True, site=site)
        return out[..., 1:-1, 1:-1]

    shape = keys.shape
    k = keys.reshape((-1,) + shape[-2:]).contiguous()
    m = mask.reshape((-1,) + shape[-2:]).contiguous()
    if num_jumps == 0:  # both rounds in one call
        return propagate_rolls(k, m, big, 2 * num_rolls, site).reshape(shape)
    for _ in range(2):  # rolls seed local minima, jumps spread them
        k = propagate_rolls(k, m, big, num_rolls, site)
        for _ in range(num_jumps):
            k = _jump(k, big)
    return k.reshape(shape)
