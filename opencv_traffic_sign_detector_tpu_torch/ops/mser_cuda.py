"""K3 and K7: the fused MSER level sweep.

Counterpart of ``opencv_traffic_sign_detector_tpu/ops/mser_pallas.py``:
``fused_level_sweep`` (K3) pads a polarity stack into row-strip windows
(``sweep_plan``/``plan_halo``), runs the bbox-area stability sweep over all
levels on every window, and returns per pixel the max over levels of
``(stability byte << lbits) | level index``.  The strips of one polarity are
stacked as extra windows along the batch dimension, so one launch covers
frames x polarities x strips.  ``fused_level_sweep_full`` (K7) runs the same
sweep body over each whole plane as one strip and returns every level's
stability byte map, the reference's oracle between K3 and the XLA sweep.

``level_sweep_windows`` and ``fused_level_sweep_full`` launch the CUDA
kernel (``csrc/mser_sweep.cu``) for CUDA tensors and take their ``*_plain``
versions for CPU tensors; the two are exact against each other.  K3 and K7
are the two output modes of one kernel, which runs in shared-memory tiles,
one launch per span of Jacobi passes (:data:`SWEEP_SPAN`,
:func:`sweep_tiles`), with the same state and ring scratch
(:func:`_tile_scratch`).  The reference's sweep body has two more forms,
both ported: the extent-only area (``sweep_extent_only``, a flag of the
tiled kernel's emit) and the scan-pass propagation (``scan_passes > 0``), a
second design that keeps bands of window rows in shared memory for all
levels, one cooperative launch a call sized by :func:`scan_plan`, again with
both outputs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MSERConfig
from ..runtime import build as rt
from .prop_cuda import axis_resolve, nb4
from .resident import const_f32

# The reference's per-strip VMEM pixel budget.  It fixes where the
# reference cuts a frame into strips (and so which candidates it emits);
# the port keeps it to keep those semantics.  It is not a limit on the GPU.
_VMEM_PX = 1_110_000
_HALO_MIN, _HALO_MAX = 32, 160
_ROW_ALIGN = 8


def plan_halo(cfg: MSERConfig) -> int:
    """Halo rows per strip side for this config.

    Any near-square candidate that passes the bbox-area cap has side
    <= sqrt(max_area * cap_scale); 1.5x that covers moderately elongated
    shapes (extreme thin-vertical components get truncated extents near
    strip boundaries — they cannot survive the downstream aspect filter,
    and end-to-end quality is revalidated per round, PARITY.md).
    """
    dim = (float(cfg.max_area) * cfg.bbox_area_cap_scale) ** 0.5
    halo = -(-int(dim * 1.5) // _ROW_ALIGN) * _ROW_ALIGN
    return max(_HALO_MIN, min(halo, _HALO_MAX))


def sweep_plan(
    h: int, w: int, pool: int, halo: int = _HALO_MAX
) -> tuple[int, int, int] | None:
    """Static strip plan for a padded (h, w) frame: (n_strips, core, halo).

    core rows are aligned to lcm(8, pool); single-strip plans have halo 0.
    Returns None when even a minimal strip exceeds the VMEM budget (w too
    large).
    """
    pool = max(1, pool)
    align = _ROW_ALIGN * pool // _gcd(_ROW_ALIGN, pool)
    wp = -(-w // pool) * pool
    h_aligned = -(-h // align) * align
    rmax = _VMEM_PX // wp
    rmax -= rmax % _ROW_ALIGN
    if rmax >= h_aligned:
        return (1, h_aligned, 0)
    core = rmax - 2 * halo
    core -= core % align
    if core < align:
        return None
    n = -(-h // core)
    return (n, core, halo)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def packing_bits(pool: int, num_levels: int) -> tuple[int, int]:
    """(in-block position bits, level bits) of the packed candidate value."""
    pool = max(1, pool)
    bits = max((pool * pool - 1).bit_length(), 1)
    lbits = max((num_levels - 1).bit_length(), 1)
    return bits, lbits


@dataclasses.dataclass(frozen=True)
class SweepParams:
    """Per-level constants of the sweep body (``_body_kwargs`` there)."""

    step: int
    d: int
    num_passes: int
    min_area: float
    max_area: float
    max_variation: float
    min_diversity: float
    # the extent-only body: squared height is the area proxy
    extent_only: bool = False
    # the scan-pass body: > 0 replaces the Jacobi passes with this many
    # (row, column) run resolves and one more row resolve
    scan_passes: int = 0

    @classmethod
    def from_config(cls, cfg: MSERConfig, d_idx: int) -> "SweepParams":
        return cls(
            step=cfg.level_step if cfg.level_step > 0 else cfg.delta,
            d=d_idx,
            num_passes=2 * cfg.ccl_iters,
            min_area=float(cfg.min_area),
            max_area=float(cfg.max_area) * cfg.bbox_area_cap_scale,
            max_variation=float(cfg.max_variation),
            min_diversity=float(cfg.min_diversity),
            extent_only=cfg.sweep_extent_only,
            scan_passes=cfg.scan_passes,
        )


# Rows and columns of the region one block of K3 holds: its tile core plus
# a halo of `span` pixels on every side (csrc/mser_sweep.cu: kRegion).
TILE_REGION = 64
# Jacobi passes one K3 launch runs: its tile halo.  1.5 levels of the tuned
# config (4 passes a level); the fastest of 4, 6, 8 and 12 at the tuned
# path's shapes on an H100 (PERF.md section 6).
SWEEP_SPAN = 6
# Threads of one K3 block and rows each owns (csrc/mser_sweep.cu:
# kTileThreads, kRows): the ring scratch holds one record of TILE_ROWS bf16
# per thread and slot.
TILE_THREADS, TILE_ROWS = 1024, 4
# The scan-pass design (csrc/mser_sweep.cu: scan_band_kernel): a block of
# SCAN_THREADS holds a band of window rows in shared memory, SCAN_ROW_BYTES
# a column of a row (keys, (ymin, xmin), (ymax, xmax) as int32 and the
# window byte) and SCAN_ROW_EXTRA a row (its least byte), the plan's bytes
# that the launch takes (the kernel refuses fewer than its layout); its
# summary buffer holds SCAN_COUNTER_INTS barrier counter ints a window slot, then
# two buffers of SCAN_SUMMARY_FIELDS int32 a column, band and slot.
SCAN_THREADS = 1024
SCAN_ROW_BYTES, SCAN_ROW_EXTRA = 13, 4
# Shared memory CUDA reserves a block on sm_80 and later
# (cudaDevAttrReservedSharedMemoryPerBlock): the opt-in limit is an SM's
# shared memory less this, 232448 bytes on an H100.
SCAN_SMEM_RESERVED = 1024
SCAN_COUNTER_INTS, SCAN_SUMMARY_FIELDS = 32, 8


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The launch of the scan-pass design over [n, r, w] windows."""

    rows: int           # window rows a band (a block's share)
    bands: int          # bands a window
    slots: int          # windows a wave
    waves: int          # waves of one call
    smem_bytes: int     # shared memory a block
    summary_bytes: int  # the barrier counters and band summaries

    @property
    def grid(self) -> int:
        return self.slots * self.bands


def scan_plan(n: int, r: int, w: int, sms: int, smem_bytes: int) -> ScanPlan:
    """The scan-pass design's plan for ``n`` windows of ``r`` x ``w`` on a
    card of ``sms`` SMs whose blocks may take ``smem_bytes`` of shared
    memory each, one block an SM.  Every band of a window must be resident
    at once (its blocks wait for each other at each column resolve), so a
    window takes at most ``sms`` bands; of the band heights that fit, the
    plan takes the one with the fewest waves x band rows (a wave's time is
    about its band's rows), then the fewest waves (barriers).

    Raises ValueError where no plan holds the windows: a row wider than one
    block's shared memory holds, more bands than SMs, or rows or columns
    past the int16 bbox pairs.
    """
    if min(n, r, w) < 1:
        raise ValueError(f"no scan-pass plan for {n} windows of {r}x{w}")
    if max(r, w) >= 1 << 15:
        raise ValueError(f"windows of {r}x{w} exceed the scan-pass kernel's int16 bbox pairs")
    max_rows = smem_bytes // (SCAN_ROW_BYTES * w + SCAN_ROW_EXTRA)
    if max_rows < 1:
        raise ValueError(f"a window row of {w} columns does not fit one block's "
                         f"{smem_bytes} bytes of shared memory "
                         f"({SCAN_ROW_BYTES * w + SCAN_ROW_EXTRA} bytes a row)")
    min_bands = -(-r // max_rows)
    if min_bands > sms:
        raise ValueError(f"windows of {r}x{w} take {min_bands} bands of at most {max_rows} "
                         f"rows, more than the {sms} blocks that can be resident")
    best = None
    for bands in range(min_bands, min(sms, r) + 1):
        rows = -(-r // bands)
        bands = -(-r // rows)  # no empty band
        slots = min(sms // bands, n)
        waves = -(-n // slots)
        key = (waves * rows, waves)
        if best is None or key < best[0]:
            best = (key, rows, bands, slots, waves)
    _, rows, bands, slots, waves = best
    summary = 4 * (SCAN_COUNTER_INTS * slots + 2 * slots * bands * SCAN_SUMMARY_FIELDS * w)
    return ScanPlan(rows, bands, slots, waves, rows * (SCAN_ROW_BYTES * w + SCAN_ROW_EXTRA),
                    summary)


def sweep_tiles(r: int, w: int) -> tuple[int, int]:
    """K3's tile core (rows, columns) for [*, r, w] windows: at most
    ``TILE_REGION - 2 * SWEEP_SPAN`` each, and as even as the window allows,
    so that few ghost rows and columns lie past its edge."""
    side = TILE_REGION - 2 * SWEEP_SPAN

    def even(n: int) -> int:
        return -(-n // -(-n // side))

    return even(r), even(w)


def _scan_resolve(mask: torch.Tensor, keys: torch.Tensor, chans: list[torch.Tensor],
                  dim: int, big: int, bigc: int):
    """One run resolve of the scan-pass body along ``dim`` (``mser_pallas.py:
    axis_resolve``): each mask run reduced whole, keys by min over ``mask ?
    keys : big``, the bbox channels (ymin, ymax, xmin, xmax) by min/max over
    ``live ? channel : fill`` with ``live = mask & keys >= 0`` taken before
    it; then the channels keep their run's value only where its key is >= 0.
    -> (keys, [ymin, ymax, xmin, xmax])."""
    mn, mx = torch.minimum, torch.maximum
    ops, fills = [mn, mn, mx, mn, mx], [big, bigc, -1, bigc, -1]
    live = mask & (keys >= 0)
    vals = [torch.where(mask, keys, big)] + [
        torch.where(live, ch, fill) for ch, fill in zip(chans, fills[1:])]
    out = axis_resolve(vals, ops, mask, dim)
    keys = torch.where(mask, out[0], big)
    live = mask & (keys >= 0)
    return keys, [torch.where(live, v, fill) for v, fill in zip(out[1:], fills[1:])]


def _scan_resolves(mask: torch.Tensor, keys: torch.Tensor, chans: list[torch.Tensor],
                   passes: int, big: int, bigc: int):
    """The scan-pass body's propagation (``mser_pallas.py: _sweep_body``):
    ``passes`` times a row resolve then a column resolve, then one more row
    resolve (:func:`_scan_resolve`).  -> (keys, ymin, ymax, xmin, xmax)."""
    for dim in [-1, -2] * passes + [-1]:
        keys, chans = _scan_resolve(mask, keys, chans, dim, big, bigc)
    return (keys, *chans)


def _sweep_levels_plain(windows: torch.Tensor, p: SweepParams, num_levels: int):
    """Yield, for each level t, the candidate byte map ``where(cand, qv, 0)``
    (f32 [N, R, W]) of the sweep body over [N, R, W] uint8 windows."""
    n, r, w = windows.shape
    dev = windows.device
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
    hw = r * w
    big, bigc = 256 * hw, 1 << 28
    im = windows.to(i32)
    rows = torch.arange(r, device=dev, dtype=i32).view(1, r, 1)
    cols = torch.arange(w, device=dev, dtype=i32).view(1, 1, w)
    keys0 = im * hw + rows * w + cols

    def full(v, dtype=i32):
        return torch.full((n, r, w), v, dtype=dtype, device=dev)

    keys, ymin, xmin, ymax, xmax = full(big), full(bigc), full(bigc), full(-1), full(-1)
    nring = p.d + 1
    aring = torch.zeros((nring, n, r, w), dtype=bf16, device=dev)
    vring = torch.full((2, n, r, w), float("inf"), dtype=bf16, device=dev)
    lastemit = torch.zeros((n, r, w), dtype=bf16, device=dev)

    min_area, max_area = const_f32(p.min_area, dev), const_f32(p.max_area, dev)
    max_var, min_div = const_f32(p.max_variation, dev), const_f32(p.min_diversity, dev)
    one, zero, inf = const_f32(1.0, dev), const_f32(0.0, dev), const_f32(float("inf"), dev)
    cap, c253, c254 = const_f32(65535.0, dev), const_f32(253.0, dev), const_f32(254.0, dev)
    mn, mx = torch.minimum, torch.maximum

    for t in range(num_levels):
        mask = (im <= t * p.step) & (rows > 0) & (rows < r - 1)
        keys = torch.where(mask, mn(keys, keys0), big)
        ymin = torch.where(mask, mn(ymin, rows), bigc)
        ymax = torch.where(mask, mx(ymax, rows), -1)
        xmin = torch.where(mask, mn(xmin, cols), bigc)
        xmax = torch.where(mask, mx(xmax, cols), -1)
        if p.scan_passes > 0:
            keys, ymin, ymax, xmin, xmax = _scan_resolves(
                mask, keys, [ymin, ymax, xmin, xmax], p.scan_passes, big, bigc)
        else:
            for _ in range(p.num_passes):  # Jacobi: every pass reads the last one
                knew = torch.where(mask, mn(keys, nb4(keys, mn)), big)
                live = mask & (knew >= 0)
                ymin = torch.where(live, mn(ymin, nb4(ymin, mn)), bigc)
                ymax = torch.where(live, mx(ymax, nb4(ymax, mx)), -1)
                xmin = torch.where(live, mn(xmin, nb4(xmin, mn)), bigc)
                xmax = torch.where(live, mx(xmax, nb4(xmax, mx)), -1)
                keys = knew

        anchor = mask & (keys == keys0)
        height = (ymax - ymin + 1).to(f32)
        bb = height * (height if p.extent_only else (xmax - xmin + 1).to(f32))
        bb = mn(bb, cap)
        a_cur = torch.where(anchor, bb, zero)
        keys = torch.where(anchor & (bb > max_area), -1, keys)

        s_old = (t + nring - (p.d + 1) % nring) % nring
        s_td = (t + nring - p.d % nring) % nring
        s_v_new = (t + 2 * nring - p.d) % 2
        area_c = aring[s_old].to(f32)
        a_td = aring[s_td].to(f32)
        v_c = vring[1 - s_v_new].to(f32)
        v_prev = vring[s_v_new].to(f32)
        v_new = torch.where((a_td > 0) & (a_cur > 0),
                            (a_cur - a_td) / mx(a_td, one), inf)
        cand = ((area_c >= min_area) & (area_c <= max_area) & (v_c < max_var)
                & (v_c <= v_prev) & (v_c <= v_new))
        last = lastemit.to(f32)
        diverse = (last <= 0) | ((area_c - last) >= min_div * mx(area_c, one))
        cand = cand & diverse
        lastemit = torch.where(cand, area_c, last).to(bf16)
        qv = torch.clamp(c254 - torch.floor(v_c * c253), 1.0, 254.0)
        aring[t % nring] = a_cur.to(bf16)
        vring[s_v_new] = v_new.to(bf16)
        yield torch.where(cand, qv, zero)


def level_sweep_windows_plain(windows: torch.Tensor, p: SweepParams, core: int,
                              halo: int, num_levels: int,
                              lbits: int) -> torch.Tensor:
    """[N, R, W] uint8 windows -> [N, core, W] int32 level-collapsed map."""
    n, _, w = windows.shape
    out = torch.zeros((n, core, w), dtype=torch.int32, device=windows.device)
    for t, qv in enumerate(_sweep_levels_plain(windows, p, num_levels)):
        out = torch.maximum(out, qv[:, halo:halo + core].to(torch.int32) * (1 << lbits) + t)
    return out


def _check_windows(windows: torch.Tensor, core: int, halo: int) -> None:
    rt.check_tensor(windows, "windows", torch.uint8, 3)
    r = windows.shape[1]
    if not (0 <= halo and core > 0 and core + 2 * halo == r):
        raise ValueError(f"windows of {r} rows do not hold core {core} + 2*halo {halo}")


def _tile_scratch(windows: torch.Tensor, p: SweepParams):
    """(th, tw, state, rings) of the tiled kernel over [N, R, W] windows:
    its tile core, the double-buffered state and the ring scratch in the
    tile plan's layout (a record per thread and slot).  The kernel holds rows
    and columns as int16, so it refuses windows of 32767 rows or columns."""
    n, r, w = windows.shape
    if max(r, w) >= 1 << 15:
        raise ValueError(f"windows of {r}x{w} exceed the kernel's int16 bbox planes")
    th, tw = sweep_tiles(r, w)
    dev = windows.device
    state = torch.empty((2, 3, n, r, w), dtype=torch.int32, device=dev)
    tiles = -(-r // th) * -(-w // tw)
    rings = torch.empty((n * tiles, p.d + 1 + 3, TILE_THREADS, TILE_ROWS),
                        dtype=torch.bfloat16, device=dev)
    return th, tw, state, rings


def scan_device(device: torch.device) -> tuple[int, int]:
    """(SMs, shared memory bytes a block may opt in to) of a CUDA device:
    an SM's shared memory less what CUDA reserves a block."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_multiprocessor - SCAN_SMEM_RESERVED


def _launch_scan(windows: torch.Tensor, out: torch.Tensor, p: SweepParams, full: bool,
                 core: int, halo: int, num_levels: int, lbits: int) -> int:
    """The scan-pass body (csrc/mser_sweep.cu: scan_band_kernel): one
    cooperative launch of :func:`scan_plan`'s grid, the warm starts, every
    level's ``2 * scan_passes + 1`` run resolves and the emits inside it,
    the sweep state on chip.  Scratch: the barrier counters and band
    summaries, and the rings in the plain layout, bf16 [d + 4, N, R, W]."""
    n, r, w = windows.shape
    plan = scan_plan(n, r, w, *scan_device(windows.device))
    dev = windows.device
    sync = torch.empty(plan.summary_bytes // 4, dtype=torch.int32, device=dev)
    rings = torch.empty((p.d + 4, n, r, w), dtype=torch.bfloat16, device=dev)
    return rt.library().tsd_level_sweep_scan(
        windows.data_ptr(), out.data_ptr(), sync.data_ptr(), rings.data_ptr(), int(full),
        n, r, w, core, halo, plan.rows, plan.bands, plan.slots, plan.waves, plan.smem_bytes,
        num_levels, p.step, p.d, p.scan_passes, lbits, int(p.extent_only), p.min_area,
        p.max_area, p.max_variation, p.min_diversity, rt.stream_ptr(dev))


def level_sweep_windows(windows: torch.Tensor, p: SweepParams, core: int,
                        halo: int, num_levels: int, lbits: int) -> torch.Tensor:
    """K3 over stacked strip windows: [N, R, W] uint8 -> [N, core, W] int32.

    Replaces ``mser_pallas.py: fused_level_sweep`` (``_collapsed_kernel``)
    with each of its bodies: the tiled Jacobi passes, with the extent-only
    area where ``p.extent_only``, or the scan-pass design where
    ``p.scan_passes > 0``.  The tiles refuse windows of 32767 rows or
    columns, the scan-pass design windows that :func:`scan_plan` cannot
    hold; the plain version takes any size.
    """
    _check_windows(windows, core, halo)
    if rt.uses_plain(windows):
        return level_sweep_windows_plain(windows, p, core, halo, num_levels, lbits)
    n, r, w = windows.shape
    out = torch.empty((n, core, w), dtype=torch.int32, device=windows.device)
    if p.scan_passes > 0:
        rc = _launch_scan(windows, out, p, False, core, halo, num_levels, lbits)
    else:
        th, tw, state, rings = _tile_scratch(windows, p)
        rc = rt.library().tsd_level_sweep(
            windows.data_ptr(), out.data_ptr(), state.data_ptr(), rings.data_ptr(),
            n, r, w, core, halo, th, tw, SWEEP_SPAN, num_levels, p.step, p.d, p.num_passes,
            lbits, int(p.extent_only), p.min_area, p.max_area, p.max_variation,
            p.min_diversity, rt.stream_ptr(windows.device))
    rt.check(rc, "level_sweep")
    rt.count_launch("level_sweep")
    return out


def fused_level_sweep(im2: torch.Tensor, cfg: MSERConfig, d_idx: int,
                      num_levels: int) -> torch.Tensor:
    """[P, H, W] polarity-stacked intensities -> level-collapsed candidate map.

    Returns int32 [P, n_strips*core, ceilpool(W)]: per pixel
    ``(stability_byte << lbits) | level_idx`` maximised over all levels;
    level_idx t holds the candidates of threshold ``(t - d_idx - 1) * step``.
    """
    p, h, w = im2.shape
    pool = max(1, cfg.topk_pool)
    plan = sweep_plan(h, w, pool, plan_halo(cfg))
    if plan is None:
        raise ValueError(f"no strip plan for geometry {h}x{w}")
    n_strips, core, halo = plan
    _, lbits = packing_bits(pool, num_levels)
    if num_levels > (1 << lbits):
        raise ValueError(f"{num_levels} levels do not fit {lbits} level bits")
    wp = -(-w // pool) * pool
    h_tot = n_strips * core + 2 * halo
    im2p = torch.full((p, h_tot, wp), 255, dtype=torch.uint8, device=im2.device)
    im2p[:, halo:halo + h, :w] = im2
    r = core + 2 * halo
    windows = im2p.unfold(1, r, core).permute(0, 1, 3, 2).reshape(p * n_strips, r, wp)
    out = level_sweep_windows(windows.contiguous(), SweepParams.from_config(cfg, d_idx),
                              core, halo, num_levels, lbits)
    return out.reshape(p, n_strips * core, wp)


def _full_params(im2: torch.Tensor, cfg: MSERConfig, d_idx: int) -> SweepParams:
    rt.check_tensor(im2, "im2", torch.uint8, 3)
    return SweepParams.from_config(cfg, d_idx)


def fused_level_sweep_full_plain(im2: torch.Tensor, cfg: MSERConfig, d_idx: int,
                                 num_levels: int) -> torch.Tensor:
    """[P, H, W] uint8 -> stability bytes uint8 [P, L, H, W]."""
    p = _full_params(im2, cfg, d_idx)
    return torch.stack([qv.to(torch.int32).to(torch.uint8)
                        for qv in _sweep_levels_plain(im2, p, num_levels)], dim=1)


def fused_level_sweep_full(im2: torch.Tensor, cfg: MSERConfig, d_idx: int,
                           num_levels: int) -> torch.Tensor:
    """K7: [P, H, W] uint8 -> stability bytes uint8 [P, L, H, W].

    Replaces ``mser_pallas.py: fused_level_sweep_full``: one strip per
    plane, no halo, the plane's own width (no pool padding), and each
    level's byte ``qv`` (0 where no candidate) for every row.  It is K3's
    kernels with their full-map output, for each body.  The kernels refuse
    planes as K3's do; the plain version takes any size.
    """
    p = _full_params(im2, cfg, d_idx)
    if rt.uses_plain(im2):
        return fused_level_sweep_full_plain(im2, cfg, d_idx, num_levels)
    n, r, w = im2.shape
    full = torch.empty((n, num_levels, r, w), dtype=torch.uint8, device=im2.device)
    if p.scan_passes > 0:
        rc = _launch_scan(im2, full, p, True, r, 0, num_levels, 0)
    else:
        th, tw, state, rings = _tile_scratch(im2, p)
        rc = rt.library().tsd_level_sweep_full(
            im2.data_ptr(), full.data_ptr(), state.data_ptr(), rings.data_ptr(),
            n, r, w, th, tw, SWEEP_SPAN, num_levels, p.step, p.d, p.num_passes,
            int(p.extent_only), p.min_area, p.max_area, p.max_variation, p.min_diversity,
            rt.stream_ptr(im2.device))
    rt.check(rc, "level_sweep_full")
    rt.count_launch("level_sweep_full")
    return full
