"""Connected components and component-wise minima of per-pixel keys.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/ccl.py``.
:func:`propagate_min_keys` is the propagation step of the XLA level sweep
and of the roll-flood refine.  Its roll passes run through kernel K5
(:func:`.prop_cuda.propagate_rolls`) at every plane size and rank: the
reference takes its Pallas kernel only for rank-3 stacks that fit VMEM and
otherwise the same passes as XLA rolls, which compute the same keys.

:func:`label_components` (neighbour min, a scatter-min hook onto the
roots, two pointer jumps), :func:`label_components_scan` (row and column
segmented run-min scans) and :func:`component_areas` label one [H, W] mask
in plain PyTorch, as the reference's do; no pipeline path calls them.
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


def _neighbor_min(lab: torch.Tensor, mask: torch.Tensor, big: int) -> torch.Tensor:
    """``mask ? min(lab, 4-neighbour labels in the mask) : big`` on [H, W],
    no wraparound."""
    pad = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
    mpad = torch.nn.functional.pad(mask, (1, 1, 1, 1), value=False)
    h, w = lab.shape

    def nb(dy, dx):
        sl = (slice(1 + dy, 1 + dy + h), slice(1 + dx, 1 + dx + w))
        return torch.where(mpad[sl], pad[sl], big)

    out = torch.minimum(torch.minimum(nb(-1, 0), nb(1, 0)), torch.minimum(nb(0, -1), nb(0, 1)))
    return torch.where(mask, torch.minimum(lab, out), big)


def _init_labels(mask: torch.Tensor, init_labels: torch.Tensor | None) -> torch.Tensor:
    h, w = mask.shape
    big = h * w
    idx = torch.arange(big, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, idx, big)
    if init_labels is not None:
        lab = torch.where(mask & (init_labels < big), torch.minimum(lab, init_labels), lab)
    return lab


def label_components(mask: torch.Tensor, num_iters: int = 8,
                     init_labels: torch.Tensor | None = None) -> torch.Tensor:
    """Label the True regions of a [H, W] bool mask with canonical flat
    indices (each component's least); int32 [H, W], background H*W.
    ``init_labels`` warm-starts from a subset mask's labels.  Each
    iteration: the neighbour min, a scatter-min of it onto each pixel's
    current root (background into a dump slot), two pointer jumps."""
    h, w = mask.shape
    big = h * w
    lab = _init_labels(mask, init_labels)
    mflat = mask.reshape(-1)
    dump = torch.full((1,), big, dtype=torch.int32, device=mask.device)
    for _ in range(num_iters):
        m = _neighbor_min(lab, mask, big).reshape(-1)
        flat = lab.reshape(-1)
        roots = torch.where(mflat, flat, big).long()
        upd = torch.where(mflat, m, big)
        flat = torch.cat([flat, dump]).scatter_reduce_(0, roots, upd, "amin")[:-1]
        for _ in range(2):  # jump: lab = lab[lab]
            ext = torch.cat([flat, dump])
            flat = torch.where(flat < big, ext[torch.clamp(flat, max=big).long()], big)
        lab = flat.reshape(h, w)
    return lab


def _segmented_min_1d(vals: torch.Tensor, mask: torch.Tensor, big: int, dim: int,
                      reverse: bool) -> torch.Tensor:
    """Running min within the runs of ``mask`` along ``dim`` of [H, W]; a
    background pixel is a barrier.  No wraparound: a Hillis-Steele scan
    over shifted copies."""
    v = torch.where(mask, vals, big)
    barrier = ~mask
    if reverse:
        v, barrier = v.flip(dim), barrier.flip(dim)
    size = v.shape[dim]
    step = 1
    while step < size:
        pad = [0, 0, 0, 0]
        pad[2 * (1 - dim % 2)] = step  # pad the front of ``dim``
        keep = [slice(None), slice(None)]
        keep[dim] = slice(0, size)
        pv = torch.nn.functional.pad(v, pad, value=big)[tuple(keep)]
        pb = torch.nn.functional.pad(barrier, pad, value=False)[tuple(keep)]
        v = torch.where(barrier, v, torch.minimum(pv, v))
        barrier = barrier | pb
        step *= 2
    return v.flip(dim) if reverse else v


def label_components_scan(mask: torch.Tensor, num_iters: int = 4,
                          init_labels: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`label_components` by alternating row and column full-run
    minima (segmented scans both ways); the same labels once converged."""
    h, w = mask.shape
    big = h * w
    lab = _init_labels(mask, init_labels)
    for _ in range(num_iters):
        m = torch.minimum(_segmented_min_1d(lab, mask, big, 1, False),
                          _segmented_min_1d(lab, mask, big, 1, True))
        m = torch.minimum(_segmented_min_1d(m, mask, big, 0, False),
                          _segmented_min_1d(m, mask, big, 0, True))
        lab = torch.where(mask, m, big)
    return lab


def component_areas(labels: torch.Tensor, cap: int = 65535) -> torch.Tensor:
    """Each pixel's component size, uint16 saturating at ``cap``, from
    int32 [H, W] labels with background H*W (area 0)."""
    h, w = labels.shape
    big = h * w
    flat = labels.reshape(-1).long()
    counts = torch.bincount(flat, minlength=big + 1)
    area = torch.where(flat < big, counts[torch.clamp(flat, max=big)], 0)
    return torch.clamp(area, max=cap).to(torch.uint16).reshape(h, w)
