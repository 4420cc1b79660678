"""K4, K5 and K6: masked min propagation of int32 keys.

* K4 ``flood_bbox``: per-candidate seed flood with bbox and pixel-area
  reduction, counterpart of ``opencv_traffic_sign_detector_tpu/ops/
  pallas_prop.py: flood_bbox_pallas``.  Where the reference takes
  materialised [N, 128, 128] seed maps and masks, both versions here read
  each candidate's window straight from the padded native intensity planes,
  given per candidate its plane, window origin, seed and level (a ``[N, 6]``
  int32 table).  The mask is ``pixel <= level`` inside the window's inner
  ring and the seed map is ``{0 at the seed, big elsewhere}``; the flood
  resolves mask runs along rows and columns (H, V, ..., H) and reduces the
  seed component to ``(ymin, ymax, xmin, xmax, area)``.
* K5 ``propagate_rolls``: K synchronous masked 4-neighbour min passes with
  wraparound, counterpart of ``pallas_prop.py: propagate_rolls_pallas``.
  The form follows from the planes' shape (:func:`rolls_form`): a 128x128
  plane (the refine's windows) or a 64x64 one (the low-res refine's) runs
  all passes in registers and stops at a fixed point; another plane that
  fits one block's shared memory runs them resident there, with the same
  stop; larger ones (the sweeps' planes) run spans of passes over tiles with
  halos (:func:`rolls_tiles`, :func:`rolls_spans`).
* K6 ``propagate_scan``: K4's flood on given keys without the reduction,
  counterpart of ``pallas_prop.py: propagate_scan_pallas``: a plane of at
  most 128x128 in one block's registers, each resolve a segmented min scan
  inside lanes, across lanes by shuffles and across warps through shared
  memory.

Each wrapper launches its CUDA kernel (``csrc/flood.cu``,
``csrc/prop_rolls.cu``; K5's window form and K6 share the register layout of
``csrc/window_regs.cuh``) for CUDA tensors and takes its ``*_plain`` version
for CPU tensors; the two are exact.
"""

from __future__ import annotations

import torch

from ..runtime import build as rt

MAX_WIN = 128
# K5's tiled form (csrc/prop_rolls.cu), for planes too large for one block:
# a block's region is ROLLS_REGION_H x ROLLS_REGION_W pixels (kRegionH: 8
# warps of 8 rows; kRegionW: a warp of lanes 4 columns wide), a core tile
# plus a halo of the span on every side; one launch runs a span
# of at most ROLLS_SPAN passes; a block stops early when its span's first
# pass changes nothing off the region's border.  Span 12 measured fastest
# of 4 to 24 at the sweeps' shapes on an H100, the early stop saves a
# quarter (PERF.md section 6).
ROLLS_REGION_H, ROLLS_REGION_W = 64, 128
ROLLS_SPAN = 12
# Shared memory one block may use on sm_90 (csrc/prop_rolls.cu:
# kResidentBytes): the resident form holds two int32 key buffers and a mask
# byte a pixel.
ROLLS_RESIDENT_BYTES = 232448
# K5's forms by csrc/prop_rolls.cu: tsd_propagate_rolls_form's codes.
ROLLS_FORMS = ("window", "window64", "resident", "tiled")


def nb4(x: torch.Tensor, op) -> torch.Tensor:
    """4-neighbour min/max over the last two dims with wraparound
    (``pltpu.roll`` / ``jnp.roll`` semantics)."""
    return op(op(torch.roll(x, 1, -2), torch.roll(x, -1, -2)),
              op(torch.roll(x, 1, -1), torch.roll(x, -1, -1)))


def axis_resolve(vals: list[torch.Tensor], ops: list, m: torch.Tensor,
                 dim: int) -> list[torch.Tensor]:
    """Segmented full-run reduce along ``dim``: each ``vals[i]`` reduced by
    ``ops[i]`` (min or max) over its mask run, by Hillis-Steele doubling over
    rolled copies in both directions, the run flags shared by all values
    (the reference kernels' own formulation).  The rolls wrap: a run that
    crosses the last index into the first is one run, and a line that is all
    mask reduces whole.  Values off the mask are not masked here."""
    size = vals[0].shape[dim]
    mi = m.to(torch.int32)
    seg_fwd = mi * (1 - torch.roll(mi, 1, dim))
    seg_bwd = mi * (1 - torch.roll(mi, -1, dim))

    def dir_scan(xs, f, fwd):
        step = 1
        while step < size:
            amt = step if fwd else -step
            blocked = f > 0
            xs = [torch.where(blocked, x, op(x, torch.roll(x, amt, dim)))
                  for x, op in zip(xs, ops)]
            f = torch.maximum(f, torch.roll(f, amt, dim))
            step *= 2
        return xs

    return [op(a, b) for a, b, op in zip(dir_scan(vals, seg_fwd, True),
                                         dir_scan(vals, seg_bwd, False), ops)]


def _key_resolve(k: torch.Tensor, m: torch.Tensor, big: int, dim: int) -> torch.Tensor:
    """Segmented run-min of keys along ``dim``, ``big`` off the mask."""
    return torch.where(m, axis_resolve([k], [torch.minimum], m, dim)[0], big)


def candidate_windows(planes: torch.Tensor, cand: torch.Tensor, win_h: int, win_w: int):
    """Each candidate's window mask and seed indicator, both bool
    [N, win_h, win_w], from the ``[N, 6]`` table (plane and origin clamped
    into the planes, as the reference's dynamic_slice clamps its start)."""
    plane, y0, x0, sy, sx, level = cand.long().unbind(-1)
    p, h, w = planes.shape
    plane = plane.clamp(0, p - 1)
    y0, x0 = y0.clamp(0, h - win_h), x0.clamp(0, w - win_w)
    ry = torch.arange(win_h, device=planes.device)
    rx = torch.arange(win_w, device=planes.device)
    wins = planes[plane[:, None, None], (y0[:, None] + ry)[:, :, None],
                  (x0[:, None] + rx)[:, None, :]]
    inner = (((ry > 0) & (ry < win_h - 1))[:, None]
             & ((rx > 0) & (rx < win_w - 1))[None, :])
    mask = (wins.long() <= level[:, None, None]) & inner
    seed = (ry[None, :, None] == sy[:, None, None]) & (rx[None, None, :] == sx[:, None, None])
    return mask, seed


def bbox_area(sel: torch.Tensor, big: int) -> torch.Tensor:
    """bool [N, H, W] -> [N, 5] int32 (ymin, ymax, xmin, xmax, area) of the
    selected pixels; an empty selection gives (big, -1, big, -1, 0)."""
    _, h, w = sel.shape
    rows = torch.arange(h, device=sel.device, dtype=torch.int32)[None, :, None]
    cols = torch.arange(w, device=sel.device, dtype=torch.int32)[None, None, :]
    ymin = torch.where(sel, rows, big).amin((1, 2))
    ymax = torch.where(sel, rows, -1).amax((1, 2))
    xmin = torch.where(sel, cols, big).amin((1, 2))
    xmax = torch.where(sel, cols, -1).amax((1, 2))
    area = sel.sum((1, 2), dtype=torch.int32)
    return torch.stack([ymin, ymax, xmin, xmax, area], dim=-1).to(torch.int32)


def flood_bbox_plain(planes: torch.Tensor, cand: torch.Tensor, win_h: int,
                     win_w: int, passes: int, big: int) -> torch.Tensor:
    """-> [N, 5] int32 (ymin, ymax, xmin, xmax, area) of each seed component."""
    mask, seed = candidate_windows(planes, cand, win_h, win_w)
    k = torch.where(mask & seed, 0, big).to(torch.int32)
    return bbox_area(propagate_scan_plain(k, mask, big, passes) == 0, big)


def flood_bbox(planes: torch.Tensor, cand: torch.Tensor, win_h: int, win_w: int,
               passes: int, big: int) -> torch.Tensor:
    """K4: planes [P, H, W] uint8, cand [N, 6] int32 (plane, y0, x0, seed_y,
    seed_x, level) -> [N, 5] int32.

    Replaces ``pallas_prop.py: flood_bbox_pallas`` (lanes 0-4 of its
    output).  Plane and origin are clamped so that each window lies inside
    the planes, as the reference's dynamic_slice clamps its start.  The
    kernel takes windows of at most 128x128 (four 32-bit words a row, four
    rows a lane); the plain version takes any window that fits the planes.
    """
    rt.check_tensor(planes, "planes", torch.uint8, 3)
    rt.check_tensor(cand, "cand", torch.int32, 2)
    if cand.shape[1] != 6:
        raise ValueError(f"cand: expected [N, 6], got {tuple(cand.shape)}")
    p, h, w = planes.shape
    if not (0 < win_h <= h and 0 < win_w <= w):
        raise ValueError(f"window {win_h}x{win_w} does not fit planes {h}x{w}")
    if rt.uses_plain(planes, cand):
        return flood_bbox_plain(planes, cand, win_h, win_w, passes, big)
    if win_h > MAX_WIN or win_w > MAX_WIN:
        raise ValueError(f"window {win_h}x{win_w} exceeds the {MAX_WIN}-px kernel limit")
    n = cand.shape[0]
    out = torch.empty((n, 5), dtype=torch.int32, device=planes.device)
    rc = rt.library().tsd_flood_bbox(
        planes.data_ptr(), cand.data_ptr(), out.data_ptr(), n, p, h, w, win_h,
        win_w, passes, big, rt.stream_ptr(planes.device))
    rt.check(rc, "flood_bbox")
    rt.count_launch("flood_bbox")
    return out


def _check_keys_mask(keys: torch.Tensor, mask: torch.Tensor) -> None:
    rt.check_tensor(keys, "keys", torch.int32, 3)
    rt.check_tensor(mask, "mask", torch.bool, 3)
    if keys.shape != mask.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and mask {tuple(mask.shape)} differ")


def propagate_rolls_plain(keys: torch.Tensor, mask: torch.Tensor, big: int,
                          passes: int) -> torch.Tensor:
    """``k = mask ? keys : big``, then ``passes`` times
    ``k = mask ? min(k, 4-neighbour min of k) : big`` (wrapping)."""
    k = torch.where(mask, keys, big)
    for _ in range(passes):
        k = torch.where(mask, torch.minimum(k, nb4(k, torch.minimum)), big)
    return k


def rolls_tiles(h: int, w: int, span: int) -> tuple[int, int]:
    """The tiled form's core (rows, columns) for [*, h, w] planes and a halo
    of ``span``: at most the region less two halos, the columns a multiple
    of a lane's 4, and as even as the plane allows."""
    side_h = ROLLS_REGION_H - 2 * span
    side_w = (ROLLS_REGION_W - 2 * span) // 4 * 4
    if span < 1 or side_h < 1 or side_w < 4:
        raise ValueError(f"span {span} leaves no core in a {ROLLS_REGION_H}x"
                         f"{ROLLS_REGION_W} region")
    def even(n: int, side: int) -> int:
        return -(-n // -(-n // side))

    return even(h, side_h), -(-even(w, side_w) // 4) * 4


def rolls_spans(passes: int) -> list[int]:
    """Passes of each launch of the tiled form: spans of ``min(ROLLS_SPAN,
    passes)``, the last one shorter where they do not divide ``passes``."""
    if passes <= 0:
        return []
    span = min(ROLLS_SPAN, passes)
    return [min(span, passes - i) for i in range(0, passes, span)]


def rolls_form(h: int, w: int) -> str:
    """K5's form for [*, h, w] planes, as ``csrc/prop_rolls.cu: rolls_form``
    chooses it: "window" (128x128 in registers), "window64" (64x64 in
    registers), "resident" (any other plane whose two key buffers and mask
    fit one block's shared memory) or "tiled".  The library's choice is the
    one that runs; :func:`propagate_rolls` raises where this one differs."""
    if (h, w) == (128, 128):
        return "window"
    if (h, w) == (64, 64):
        return "window64"
    return "resident" if h * w * 9 <= ROLLS_RESIDENT_BYTES else "tiled"


def propagate_rolls(keys: torch.Tensor, mask: torch.Tensor, big: int, passes: int,
                    site: str = "propagate_rolls") -> torch.Tensor:
    """K5: keys int32 [P, H, W], mask bool [P, H, W] -> propagated keys.

    Replaces ``pallas_prop.py: propagate_rolls_pallas`` at any plane size
    (the reference's VMEM cap does not apply).  ``site`` names the launch
    counter: the sweep and the refine count apart.  The kernel's form
    follows from H and W alone (:func:`rolls_form`).  The window forms hold
    a 128x128 or a 64x64 plane in one block's registers, the resident form
    any other plane that fits one block's shared memory (the refine's windows
    on frames smaller than 128 pixels, small sweep planes); each runs in one
    CUDA launch and leaves the loop at the first pass that changes no pixel
    of its plane (a fixed point: exact).  A larger plane takes
    ``len(rolls_spans(passes))`` launches (``ceil(passes / ROLLS_SPAN)``; the
    mask alone at 0 passes) over tiles.
    """
    _check_keys_mask(keys, mask)
    if rt.uses_plain(keys, mask):
        return propagate_rolls_plain(keys, mask, big, passes)
    p, h, w = keys.shape
    lib = rt.library()
    form = ROLLS_FORMS[lib.tsd_propagate_rolls_form(h, w)]
    if form != rolls_form(h, w):
        raise RuntimeError(f"K5 on {h}x{w} planes: the library takes the {form} form, "
                           f"rolls_form the {rolls_form(h, w)} form")
    out = torch.empty_like(keys)
    span, core_h, core_w, scratch = 0, 0, 0, None
    if p and h and w and passes and form == "tiled":
        spans = rolls_spans(passes)
        span = spans[0]
        core_h, core_w = rolls_tiles(h, w, span)
        # launches ping-pong through a second buffer in device memory
        scratch = torch.empty_like(keys) if len(spans) > 1 else None
    rc = lib.tsd_propagate_rolls(
        keys.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), p, h, w, passes, big,
        span, core_h, core_w, rt.stream_ptr(keys.device))
    rt.check(rc, "propagate_rolls")
    rt.count_launch(site)
    return out


def propagate_scan_plain(keys: torch.Tensor, mask: torch.Tensor, big: int,
                         passes: int) -> torch.Tensor:
    """``passes`` row-then-column segmented run-min resolves and a last row
    resolve of ``mask ? keys : big``."""
    k = torch.where(mask, keys, big)
    for _ in range(passes):
        k = _key_resolve(k, mask, big, 2)
        k = _key_resolve(k, mask, big, 1)
    return _key_resolve(k, mask, big, 2)


def propagate_scan(keys: torch.Tensor, mask: torch.Tensor, big: int,
                   passes: int) -> torch.Tensor:
    """K6: keys int32 [P, H, W], mask bool [P, H, W] -> component-min keys by
    run scans.  The kernel takes H, W <= 128; the plain version any size.

    Replaces ``pallas_prop.py: propagate_scan_pallas``.  Precondition, as
    the reference's: the border rows and columns of ``mask`` are False.
    The kernel ends every run at the plane's edge while the plain version
    and the reference scan with wrapping rolls; the two agree only under it.
    """
    _check_keys_mask(keys, mask)
    p, h, w = keys.shape
    if rt.uses_plain(keys, mask):
        return propagate_scan_plain(keys, mask, big, passes)
    if not (h <= MAX_WIN and w <= MAX_WIN):
        raise ValueError(f"planes {h}x{w} exceed the {MAX_WIN}-px kernel limit")
    out = torch.empty_like(keys)
    rc = rt.library().tsd_propagate_scan(
        keys.data_ptr(), mask.data_ptr(), out.data_ptr(), p, h, w, passes, big,
        rt.stream_ptr(keys.device))
    rt.check(rc, "propagate_scan")
    rt.count_launch("propagate_scan")
    return out
