"""The level-by-level MSER sweep's candidate select: each frame's running
top-n packed keys, merged a level at a time (``ops/mser.py: _sweep_topk``).

A level's key is ``byte << IDX_BITS | (2**IDX_BITS - 1 - t * P - i)`` for
the byte at flat index ``i`` of level ``t``'s map ``[B, P]`` (P = 2 H W):
the higher byte first, then the lower index of the flat ``[L, P]`` map, as
``lax.top_k`` orders them.  Every element of the global top-n is in its own
level's top-n, so merging level by level is exact.

:func:`level_topk` takes its plain version (``torch.topk`` of the level's
keys, then of the running list and that) for CPU tensors and launches the
kernel pair of ``csrc/level_topk.cu`` for CUDA tensors, which reads the
level's bytes once and keeps only the nonzero keys that can still enter;
there is no fallback from one to the other.  Both give the same keys, the
zero-byte fillers of the first level included, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ..runtime import build as rt

# The packed key's index bits (a level's keys need (t + 1) * P <= 2**IDX_BITS)
IDX_BITS = 40
# A kept key on the card: byte << LEVEL_BITS | i, so P <= 2**LEVEL_BITS
LEVEL_BITS = 24
# The longest running list the merge keeps in shared memory
# (csrc/level_topk.cu: kMaxN)
MAX_N = 4096


@dataclasses.dataclass
class TopkWork:
    """The kernel pair's scratch, made once for a sweep: the kept keys,
    ``[B, P]`` int32 (a frame's row holds its whole level), and each frame's
    count of them, ``[B]`` int32, zero between calls."""

    keys: torch.Tensor
    counts: torch.Tensor


def topk_work(b: int, per_level: int, device: torch.device) -> TopkWork | None:
    """Scratch for :func:`level_topk` on a card; None on the CPU, whose plain
    version needs none."""
    if torch.device(device).type == "cpu":
        return None
    return TopkWork(torch.empty((b, per_level), dtype=torch.int32, device=device),
                    torch.zeros(b, dtype=torch.int32, device=device))


def _check(best: torch.Tensor | None, sb: torch.Tensor, t: int, n: int,
           kept: torch.Tensor | None) -> None:
    rt.check_tensor(sb, "sb", torch.uint8, 2)
    b, p = sb.shape
    if not 1 <= n <= p:
        raise ValueError(f"n = {n}: expected 1 to the map's {p} keys a frame")
    if t < 0 or (t + 1) * p > 1 << IDX_BITS:
        raise ValueError(f"level {t} of {p} keys does not fit {IDX_BITS} index bits")
    if best is not None:
        rt.check_tensor(best, "best", torch.int64, 2)
        if tuple(best.shape) != (b, n):
            raise ValueError(f"best: expected {(b, n)}, got {tuple(best.shape)}")
    if kept is not None and (kept.dtype != torch.int64 or kept.numel() != 1):
        raise ValueError("kept: expected one int64 counter")


def level_keys(sb: torch.Tensor, t: int) -> torch.Tensor:
    """[B, P] uint8 -> [B, P] int64 packed keys of level ``t``."""
    p = sb.shape[1]
    inv = ((1 << IDX_BITS) - 1 - t * p) - torch.arange(p, dtype=torch.int64, device=sb.device)
    return (sb.to(torch.int64) << IDX_BITS) | inv


def level_topk_plain(best: torch.Tensor | None, sb: torch.Tensor, t: int, n: int,
                     kept: torch.Tensor | None = None) -> torch.Tensor:
    """The running top ``n`` after level ``t``: ``torch.topk`` of the level's
    keys, merged into ``best`` (None at the first level) by a second one.
    ``kept``, when given, gains the keys the kernel would keep: the nonzero
    bytes above ``best``'s n-th key (every nonzero byte at the first)."""
    packed = level_keys(sb, t)
    if kept is not None:
        live = sb != 0
        if best is not None:
            live &= packed > best[:, -1:]
        kept += live.sum()
    top = torch.topk(packed, n, dim=1).values
    if best is not None:
        top = torch.topk(torch.cat([best, top], dim=1), n, dim=1).values
    return top


def level_topk(best: torch.Tensor | None, sb: torch.Tensor, t: int, n: int,
               kept: torch.Tensor | None = None, work: TopkWork | None = None) -> torch.Tensor:
    """Merge level ``t``'s byte map ``sb`` ([B, P] uint8, contiguous) into the
    running top ``n`` ``best`` ([B, n] int64, descending; None at the first
    level) -> the new [B, n] int64, descending.

    On a card the kernel pair (two launches) writes it into ``best`` in place,
    or into a new tensor at the first level; ``work`` is its scratch
    (:func:`topk_work`, made once for the levels), ``kept`` an int64 counter
    that gains the level's kept keys.
    """
    _check(best, sb, t, n, kept)
    if rt.uses_plain(*(x for x in (best, sb, kept) if x is not None)):
        return level_topk_plain(best, sb, t, n, kept)
    b, p = sb.shape
    if n > MAX_N:
        raise ValueError(f"the kernel keeps at most {MAX_N} keys a frame, got n = {n}")
    if p > 1 << LEVEL_BITS:
        raise ValueError(f"the kernel takes at most {1 << LEVEL_BITS} keys a level, got {p}")
    if work is None or tuple(work.keys.shape) != (b, p) or tuple(work.counts.shape) != (b,):
        raise ValueError(f"work: expected topk_work({b}, {p}, device)")
    out = torch.empty((b, n), dtype=torch.int64, device=sb.device) if best is None else best
    rc = rt.library().tsd_level_topk(
        sb.data_ptr(), out.data_ptr(), work.keys.data_ptr(), work.counts.data_ptr(),
        None if kept is None else kept.data_ptr(), b, p, n, t, int(best is None),
        rt.stream_ptr(sb.device))
    rt.check(rc, "level_topk")
    rt.count_launch("topk_compact")
    rt.count_launch("topk_merge")
    return out
