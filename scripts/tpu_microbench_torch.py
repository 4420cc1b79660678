#!/usr/bin/env python3
"""Isolate the cost of the primitives the MSER path's plain code is built
from: scatter, gather, sort, a segmented scan, a roll pass, top-k, a table
take.

Run each primitive separately, so that one crash does not hide the others::

    python scripts/tpu_microbench_torch.py <case> [--device cuda|cpu]

The twin of ``scripts/tpu_microbench.py``: the same cases, inputs (the
original's ``default_rng(0)`` draws in its order, at the MSER path's
1360x800 = 1,088,000 elements) and line, ``<case> <seconds a call>``, after a
first line with the card's name and power limit; ``--device`` defaults to
``cuda`` and without a visible card it exits 2.  Each case is out of place:
its output is filled anew at each call, as the original's lambdas do.  It is
replayed from one ``runtime/graphs.py: CapturedFn`` graph a card and case, as
the original jits it: the warm-up call is the capture, and the inputs are the
graph's constants, read in place as a jitted function reads its arguments
(no input copy a call).  A time is one warm-up call, then the mean of 5
calls (2 for ``top_k``) ended by one synchronisation.  The CPU runs the
cases eagerly.

Where PyTorch differs from JAX:

* scatter and gather take int64 indices where JAX takes int32: the index
  tensors (``idx``, and the image ``take_table`` indexes with) are made
  int64 once, outside the timed call;
* ``scatter_max_u16``: PyTorch has no uint16 ``scatter_reduce``, so the
  case always scatters the values widened to int32 and narrows the result
  to uint16; the values are < 255, so the result is the same;
* ``assoc_scan_rows``: stable PyTorch has no associative scan, so the
  original's segmented-min combine runs as a Hillis-Steele doubling scan
  along each row: 11 rounds for 1360 columns, exact on int32;
* ``top_k`` returns int64 indices; tied values may come in another order.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 1_088_000  # 1360*800
I32 = torch.int32


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def bench(fn, *args, iters=5):
    """Seconds a call: one warm-up (on a card, the capture), then the mean of
    ``iters`` calls ended by one synchronisation."""
    fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def seg_min_rows(x: torch.Tensor) -> torch.Tensor:
    """The inclusive scan along axis 1 of the original's combine
    ``(m1, s1), (m2, s2) -> (where(s2, m2, min(m1, m2)), s1 | s2)`` over
    ``(x, x > 128)``, as a Hillis-Steele scan: at the round of shift ``d``
    each column ``j >= d`` combines the value ``d`` to its left into its
    own.  The combine is associative, so this equals a sequential scan."""
    m, s = x, x > 128
    d = 1
    while d < x.shape[1]:
        m = torch.cat([m[:, :d], torch.where(s[:, d:], m[:, d:],
                                             torch.minimum(m[:, :-d], m[:, d:]))], dim=1)
        s = torch.cat([s[:, :d], s[:, :-d] | s[:, d:]], dim=1)
        d *= 2
    return m


def _full(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((N + 1,), value, dtype=I32, device=like.device)


CASES = {
    "scatter_add_i32": lambda i, v: _full(0, v).index_add_(0, i, v),
    "scatter_min_i32": lambda i, v: _full(2**30, v).scatter_reduce_(0, i, v, "amin"),
    # int32 values, < 255: the uint16 scatter widened, narrowed at the end
    "scatter_max_u16": lambda i, v: _full(0, v).scatter_reduce_(0, i, v, "amax").to(torch.uint16),
    "gather_i32": lambda i, v: v[i],
    "sort_i32": lambda v: torch.sort(v).values,
    "assoc_scan_rows": seg_min_rows,
    "elemwise_pass": lambda x: torch.minimum(torch.minimum(x, torch.roll(x, 1, 0)),
                                             torch.roll(x, 1, 1)) + 1,
    "top_k": lambda x: torch.topk(x, 1024),
    "take_table": lambda t, x: t[x],
}


def inputs(case: str, device) -> tuple[torch.Tensor, ...]:
    """The case's inputs on ``device``, from the original's draws in its
    order: ``idx``, ``vals``, ``img``, then ``top_k``'s floats or
    ``take_table``'s table."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, N, N)
    vals = rng.integers(0, 255, N)
    img = rng.integers(0, 255, (800, 1360))

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    if case in ("scatter_add_i32", "scatter_min_i32", "scatter_max_u16", "gather_i32"):
        return t(idx, torch.int64), t(vals, I32)
    if case == "sort_i32":
        return (t(vals, I32),)
    if case in ("assoc_scan_rows", "elemwise_pass"):
        return (t(img, I32),)
    if case == "top_k":
        return (t(rng.random((74 * N // 8,)), torch.float32),)
    if case == "take_table":
        return t(rng.integers(0, 255, 256), I32), t(img, torch.int64)
    raise KeyError(case)


def run_case(case: str, x: tuple, *args):
    """The function a case's graph captures, keyed by the case: no batch
    input (``x`` is the empty tuple), the case's inputs as constants."""
    return CASES[case](*args)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", nargs="?", help="one of: " + ", ".join(CASES))
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda exits 2 when no card is visible")
    args = ap.parse_args(argv)

    from opencv_traffic_sign_detector_tpu_torch.runtime.build import card_line, missing_card
    from opencv_traffic_sign_detector_tpu_torch.runtime.graphs import CapturedFn

    why = missing_card(args.device)
    if why:
        print(why)
        return 2
    if args.case is None:
        ap.error("the following arguments are required: case")
    device = torch.device(args.device)
    print(card_line(device))
    case = args.case
    if case not in CASES:
        print("unknown case", case)
        return 0
    graph = CapturedFn(run_case, keyed=True)
    t = bench(lambda *a: graph(device, (), *a, key=case), *inputs(case, device),
              iters=2 if case == "top_k" else 5)
    print(case, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
