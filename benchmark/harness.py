"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison with the reference, and the result line.

Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``) and its chips; the configuration names its
family, whose driver is ``drivers/<family>.py``; each metric is
``metrics/<metric>.py``, a reader that returns its value from the run or
None where it has nothing to read.

The window is the product's loop: one batch in flight, batch i+1 dispatched
before batch i is collected, the pool's batches in turn, for ``seconds``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "opencv_traffic_sign_detector_tpu")
TRACE_SECONDS = 1.0       # the traced stretch: about this long, in whole batches
STAGE_BATCHES = 4         # eager batches under the stage timer (MSER)
WARM_PASSES = 2           # passes over the pool before the window


class CellError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise CellError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT.parent)})")
    return json.loads(path.read_text())


def workloads() -> list[str]:
    """Every cell the harness can run: the files under ``workloads/``."""
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))


def cell(name: str) -> dict:
    """A cell with its configuration and traffic loaded."""
    w = load("workloads", name)
    return {**w, "name": name, "config_data": load("configs", w["config"]),
            "traffic_data": load("traffic", w["traffic"])}


def readers(kind: str) -> dict:
    """{metric name: reader module} of every ``metrics/*.py`` of ``kind``
    (``end_to_end`` or ``per_layer``)."""
    out = {}
    for path in sorted((ROOT / "metrics").glob("*.py")):
        module = "bench_metric_" + path.stem.replace(".", "_")
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if mod.KIND == kind:
            out[path.stem] = mod
    return out


def driver(family: str):
    return importlib.import_module(f"benchmark.drivers.{family}")


class Tally:
    """The answers collected, as ``frames``: {(pool batch, frame, records):
    times seen}.  A frame answered alike each time it comes round is kept
    once, so a run holds no more records than its pool has frames."""

    def __init__(self):
        self.frames: dict = {}
        self.batches = 0

    def add(self, pool_index: int, records: list) -> None:
        self.batches += 1
        for i, r in enumerate(records):
            key = (pool_index, i, tuple(r))
            self.frames[key] = self.frames.get(key, 0) + 1

    def pool_batches(self) -> list[int]:
        return sorted({k for k, _, _ in self.frames})


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Batch:
    pool_index: int
    t_dispatch: float      # the host's clock as the dispatch began
    t_dispatched: float    # ... as it returned
    t_done: float = 0.0    # ... as its collect returned


@dataclass
class Run:
    """What the readers read."""

    cell: dict
    config: dict
    traffic: dict
    family: str
    frames_per_batch: int
    setup_s: float
    t_start: float
    t_end: float
    batches: list
    trace: dict | None = None
    stages: dict | None = None

    @property
    def completed(self) -> list:
        """The batches whose records came back inside the window."""
        return [b for b in self.batches if b.t_done <= self.t_end]

    @property
    def frames_per_s(self) -> float | None:
        """Frames the window completed over the seconds from its first
        dispatch to the last of those collects returning."""
        done = self.completed
        if not done:
            return None
        return self.frames_per_batch * len(done) / (done[-1].t_done - self.t_start)

    @property
    def idle_share(self) -> float | None:
        """% of the traced stretch with no kernel and no copy on the card."""
        if not self.trace or self.trace["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])

    @property
    def dispatch_ms(self) -> float:
        """The host's mean milliseconds in a dispatch call over the window."""
        return 1e3 * sum(b.t_dispatched - b.t_dispatch for b in self.batches) / len(self.batches)


def closed_loop(prog, pool: list, tally: Tally, n: int | None = None,
                seconds: float | None = None, span=None) -> list:
    """Dispatch batch i+1, then collect batch i: ``n`` batches, or until
    ``seconds`` have passed since the first dispatch (the last one in flight
    then collected after).  Each batch's records go to ``tally``;
    ``span(name)`` wraps each dispatch and collect."""
    import contextlib

    span = span or (lambda name: contextlib.nullcontext())
    out, pending, i = [], None, 0
    t_end = None if seconds is None else time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        with span("dispatch"):
            handle = prog.dispatch(pool[i % len(pool)])
        nxt = Batch(i % len(pool), t0, time.perf_counter())
        if pending is not None:
            with span("collect"):
                records = prog.collect(pending[0])
            pending[1].t_done = time.perf_counter()
            out.append(pending[1])
            tally.add(pending[1].pool_index, records)
        pending, i = (handle, nxt), i + 1
        if (n is not None and i >= n) or (t_end is not None and time.perf_counter() >= t_end):
            break
    with span("collect"):
        records = prog.collect(pending[0])
    pending[1].t_done = time.perf_counter()
    out.append(pending[1])
    tally.add(pending[1].pool_index, records)
    return out


def window_note(run: Run) -> str:
    """One line on the window's batches: latency and dispatch quantiles, and
    when the slow batches (over 1.5x the median latency) came."""
    import statistics

    lat = sorted(1e3 * (b.t_done - b.t_dispatch) for b in run.batches)
    disp = sorted(1e3 * (b.t_dispatched - b.t_dispatch) for b in run.batches)

    def q(v, p):
        return v[min(len(v) - 1, int(p * len(v)))]

    med = statistics.median(lat)
    slow = [f"{b.t_dispatch - run.t_start:.2f}" for b in run.batches
            if 1e3 * (b.t_done - b.t_dispatch) > 1.5 * med]
    return (f"window: {len(run.batches)} batches; latency ms p50 {med:.3f} p90 {q(lat, .9):.3f} "
            f"p99 {q(lat, .99):.3f} max {lat[-1]:.3f}; dispatch ms p50 {q(disp, .5):.3f} "
            f"p99 {q(disp, .99):.3f} max {disp[-1]:.3f}; {len(slow)} slow batches at s "
            f"{' '.join(slow[:40])}")


def _device(dev: str, chips: int) -> dict:
    import torch

    if dev == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_process: float,
             device: str = "cuda", traffic: dict | None = None, program=None) -> dict:
    """One run; returns the result line as a dict (its last key ``checks``).

    ``device="cpu"``, ``traffic`` (a replacement traffic mix) and
    ``program`` (a factory of the program, given the driver's) are for the
    CPU tests of the harness; the command runs on a card only."""
    import torch

    c = cell(name)
    config, mix = c["config_data"], traffic or c["traffic_data"]
    if device != "cpu":
        if not torch.cuda.is_available():
            raise CellError("torch.cuda.is_available() is false: the benchmark runs on a card")
        if torch.cuda.device_count() < c["chips"]:
            raise CellError(f"{name} needs {c['chips']} cards, "
                            f"{torch.cuda.device_count()} visible")
        device = "cuda"
    from .traffic import make_pool

    drv = driver(config["family"])
    marks = [("imports", time.perf_counter())]
    pool = make_pool(mix, seed)
    marks.append(("frames", time.perf_counter()))
    prog = (program or drv.Program)(config, mix, device)
    marks.append(("program", time.perf_counter()))
    closed_loop(prog, pool, Tally(), n=WARM_PASSES * len(pool))
    if device != "cpu":
        torch.cuda.synchronize()
    marks.append(("capture and warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_process
    print("set-up: " + ", ".join(f"{k} {t - s:.3f} s" for (k, t), s in
                                 zip(marks, [t_process] + [t for _, t in marks[:-1]])),
          file=sys.stderr)

    checked = Tally()
    t_start = time.perf_counter()
    window = closed_loop(prog, pool, checked, seconds=seconds)
    run = Run(c, config, mix, config["family"], mix["batch"], setup_s, t_start,
              t_start + seconds, window)
    print(window_note(run), file=sys.stderr)
    if trace:
        rate = len(window) / (window[-1].t_done - t_start)
        n = int(min(max(round(rate * TRACE_SECONDS), 8), 400))
        if device != "cpu":
            from .timing import trace_stretch

            run.trace = trace_stretch(lambda span: closed_loop(prog, pool, checked, n=n,
                                                               span=span))
            run.trace["batches"] = n
        if hasattr(prog, "stage_split") and device != "cpu":
            run.stages = prog.stage_split(pool, STAGE_BATCHES, checked)
    dev_info = _device(device, c["chips"])
    found = forbidden_modules()
    if found:
        raise CellError(f"modules of JAX or the JAX package are loaded: {found}")

    prog.close()
    del prog
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    reference = drv.Reference(config, mix, device)
    refs = {k: reference.records(pool[k]) for k in checked.pool_batches()}
    nums, failed = drv.numbers(config, mix, checked.frames, refs)
    limits = config["limits"]
    correct = all(nums[k] <= limits[k] for k in limits)

    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m for m in json.loads((ROOT.parent / "BENCHMARK.json").read_text())[kind]}
    metrics = {}
    for metric, mod in readers(kind).items():
        entry = listed.get(metric)
        if entry is None or name not in entry.get("workloads", [name]):
            continue
        value = mod.read(run)
        if value is not None:
            metrics[metric] = {"value": float(value), "unit": mod.UNIT}
    if trace and run.trace is not None:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
    out = {"correct": bool(correct), "attempted": checked.batches * mix["batch"],
           "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace and run.trace is not None:
        ops = sorted(run.trace["ops"].items(), key=lambda x: -x[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                            "idle_gaps": [[k, v] for k, v in run.trace["gaps"][:10]]}
    out["checks"] = {k: {"value": float(nums[k]), "limit": float(limits[k])} for k in limits}
    return out


def main(argv=None, t_process: float | None = None) -> int:
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_process)
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0

