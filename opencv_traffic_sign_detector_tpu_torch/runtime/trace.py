"""The port's tracer: host spans, device stamps and counters of the main
path, a batch at a time, kept in memory.

A batch opens at ``DetectionPipeline.dispatch`` (:meth:`Tracer.dispatch`),
which gives it an id; the pending handle carries the batch to ``collect``
(:meth:`Tracer.collect`), so every span of a batch holds its id.  The last
:data:`RING` batches are kept; :meth:`Tracer.snapshot` gives the resolved
ones, :meth:`Tracer.window` those dispatched in a stretch of the host's
clock.

**Host spans**, on ``time.perf_counter_ns`` (CLOCK_MONOTONIC, the clock the
benchmark reads too): ``dispatch``, with ``pin`` (``parallel/mesh.py:
host_shards``, the frames pinned by ``models/detector.py: pinned``),
``replay`` or ``capture`` (``runtime/graphs.py: CapturedFn`` on a hit or a
miss; ``eager`` where the call runs eagerly) and ``to_host`` (the records'
copy back enqueued, ``parallel/mesh.py``); ``collect``, with ``wait`` (the
host waiting for the card) and ``unpack``.  While a ``torch.profiler`` records, each span also
opens a ``record_function`` range ``tsd.<span>``, so the spans sit in the
profiler's trace beside the card's kernels.

**Device stamps.**  While a traced ``CapturedFn`` call runs its function
(the eager warm-up and the capture of a miss, or an eager call), each
``ops/mser.py: stage_scope`` boundary enqueues the stamp kernel
(``csrc/stamp.cu``), which writes the card's ``%globaltimer`` into the next
slot of the call's :class:`Stamps` buffer.  In a capture those launches
become graph nodes, so every replay writes the stamps of the graph the
product runs.  Slot 0 (``h2d``) is stamped just before the input's copy
into the graph's static input, and a last ``end`` stamp after the function
returns (after ``_pack``).  The buffer is copied to pinned host memory on
the same stream right after the call, ahead of the event ``to_host``
records, so the values come back with the batch's records and ``collect``
resolves them when its wait returns, with no sync added.  A stage entered
several times a batch (``sweep``, ``topk``) is summed.  On the CPU a stamp
is the host's clock (the ops run there in order).  Stamps are not in the
launch counts (``runtime/build.py``).

**One clock.**  A card's ``%globaltimer`` maps onto ``perf_counter_ns`` by an
offset measured when the tracer first meets the card: a stamp enqueued
between two reads of the host's clock around a sync, the shortest of a few
round trips; half that round trip is the offset's error.

**Counters**, a batch: whether it captured, its port kernel launches (the
graph's, recorded at its capture) and, after a capture (where evictions
happen), the card's graph bytes (``runtime/graphs.py: held_bytes``).  The
device counters (:data:`COUNTERS`) are counted on the card: a traced call's
:class:`Stamps` holds them in a small int64 buffer, zeroed where the call
first asks for one (:meth:`Stamps.counter`; in a graph, a node before the
kernels that add to it), copied back beside the stamps and added to the
batch in ``collect``: ``topk_kept``, the keys the level sweep's candidate
select kept over the batch's levels and frames (``ops/level_topk.py``;
None where no call ran it).

Off (:func:`enable`), nothing is recorded and graphs capture without
stamps; ``CapturedFn`` keys its graphs by the state, so a toggle captures
anew and never replays a graph of the other mode.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict, deque

import torch

from . import build

SLOTS = 1024   # stamps a traced call holds (the XLA sweep of the recall config takes ~360)
RING = 2048    # batches kept: a 20 s window of the MSER cells, its warm-up and more
COUNTERS = ("topk_kept",)  # the device counters a traced call holds, in buffer order
ENTER, EXIT, POINT = 1, -1, 0
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    """A host span: start and end on ``perf_counter_ns``, the index of its
    parent in its batch's spans (None for ``dispatch`` and ``collect``)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    batch: int


@dataclasses.dataclass
class DeviceTimes:
    """One traced call's stamps, on the host's clock: ``h2d_ns`` as the
    input's copy began, ``first_ns`` the function's first stamp, ``end_ns``
    its last; each stage's nanoseconds summed over its entries, and when it
    was first entered."""

    device: str
    h2d_ns: int
    first_ns: int | None
    end_ns: int | None
    stages_ns: dict
    opened_ns: dict


@dataclasses.dataclass
class Batch:
    """One dispatched batch: its spans, its calls' resolved stamps (a call a
    shard), the stamps still on their way (``collect`` resolves them) and
    its counters."""

    id: int
    spans: list = dataclasses.field(default_factory=list)
    devices: list = dataclasses.field(default_factory=list)
    pending: list = dataclasses.field(default_factory=list)
    captured: bool = False
    launches: int | None = None
    held_bytes: int | None = None
    topk_kept: int | None = None

    @property
    def start_ns(self) -> int:
        """When its dispatch began."""
        return self.spans[0].start_ns

    def span_ns(self, name: str) -> int | None:
        """The nanoseconds of its spans named ``name``, summed (None: none)."""
        found = [s.end_ns - s.start_ns for s in self.spans if s.name == name]
        return sum(found) if found else None

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        del d["pending"]
        return d


class Stamps:
    """A traced call's stamp buffer (int64 [:data:`SLOTS`] on its device)
    and what each slot marks: ``(name, ENTER | EXIT | POINT)``; its device
    counters (int64 [len(:data:`COUNTERS`)]) and whether its function asked
    for them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buf = torch.zeros(SLOTS, dtype=torch.int64, device=device)
        self.marks: list | tuple = [("h2d", POINT)]
        self.counts = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
        self.counted = False

    def counter(self, name: str) -> torch.Tensor:
        """Counter ``name``'s slot (a 0-dim int64 view) for the running call
        to add to, on its device; the buffer is zeroed at the call's first
        request."""
        if not self.counted:
            self.counts.zero_()
            self.counted = True
        return self.counts[COUNTERS.index(name)]

    def write(self, slot: int) -> None:
        if self.device.type == "cpu":
            self.buf[slot] = time.perf_counter_ns()
        else:
            build.check(build.library().tsd_stamp(self.buf.data_ptr(), slot,
                                                  build.stream_ptr(self.device)), "stamp")

    def mark(self, name: str, kind: int) -> None:
        """Stamp the next slot (none past the buffer's end)."""
        if len(self.marks) < SLOTS:
            self.write(len(self.marks))
            self.marks.append((name, kind))

    @contextlib.contextmanager
    def scope(self, name: str, timer):
        """A stage between two stamps; ``timer(name)``, when given, inside."""
        self.mark(name, ENTER)
        with timer(name) if timer is not None else _NULL:
            yield
        self.mark(name, EXIT)


class _State(threading.local):
    def __init__(self):
        self.stack = []      # the open spans: (batch, index)
        self.stamps = None   # the Stamps the running traced call writes


class _Open:
    """The context of one span."""

    __slots__ = ("state", "batch", "index", "record")

    def __init__(self, state: _State, batch: Batch, name: str, parent: int | None):
        self.state, self.batch = state, batch
        self.index = len(batch.spans)
        batch.spans.append(Span(name, 0, 0, parent, batch.id))
        self.record = None

    def __enter__(self) -> Batch:
        span = self.batch.spans[self.index]
        if torch._C._autograd._profiler_enabled():
            self.record = torch.autograd.profiler.record_function("tsd." + span.name)
            self.record.__enter__()
        self.state.stack.append((self.batch, self.index))
        span.start_ns = time.perf_counter_ns()
        return self.batch

    def __exit__(self, *exc) -> bool:
        self.batch.spans[self.index].end_ns = time.perf_counter_ns()
        self.state.stack.pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


class Tracer:
    """Spans, stamps and counters of the last ``ring`` batches."""

    def __init__(self, ring: int = RING):
        self.enabled = True
        self.batches: deque = deque(maxlen=ring)
        self.clocks: dict = {}   # device -> (offset_ns, error_ns): card clock + offset = host
        self._ids = itertools.count()
        self._state = _State()

    # --- spans -------------------------------------------------------------
    def dispatch(self):
        """Open a new batch and its ``dispatch`` span: a context that gives
        the batch (None while the tracer is off)."""
        if not self.enabled:
            return _NULL
        batch = Batch(next(self._ids))
        self.batches.append(batch)
        return _Open(self._state, batch, "dispatch", None)

    def collect(self, batch: Batch | None):
        """The ``collect`` span of ``batch`` (nothing for None)."""
        return _NULL if batch is None else _Open(self._state, batch, "collect", None)

    def span(self, name: str):
        """A span inside the innermost open one, in its batch (nothing
        outside a batch)."""
        stack = self._state.stack
        if not stack:
            return _NULL
        batch, parent = stack[-1]
        return _Open(self._state, batch, name, parent)

    def tracing(self) -> bool:
        """On, inside a batch: a ``CapturedFn`` call then stamps."""
        return self.enabled and bool(self._state.stack)

    # --- stamps ------------------------------------------------------------
    def armed(self) -> Stamps | None:
        """The stamps of the traced call running now, for ``stage_scope``."""
        return self._state.stamps

    def stamped(self, fn, device: torch.device):
        """-> (``fn`` that stamps each stage boundary it meets, and ``end``
        when it returns, into a new :class:`Stamps` on ``device``, each call
        from slot 1 on; those stamps), with slot 0 (``h2d``) stamped now,
        before the input's copy.  A card's clock is calibrated the first
        time the tracer meets the card (outside any capture)."""
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            if device not in self.clocks and not torch.cuda.is_current_stream_capturing():
                self.calibrate(device)
        stamps, state = Stamps(device), self._state
        stamps.write(0)

        def run(*args):
            stamps.marks = [("h2d", POINT)]
            stamps.counted = False
            outer, state.stamps = state.stamps, stamps
            try:
                out = fn(*args)
            finally:
                state.stamps = outer
            stamps.mark("end", POINT)
            stamps.marks = tuple(stamps.marks)
            return out

        return run, stamps

    def record(self, stamps: Stamps | None, launches: int | None = None,
               captured: bool = False, held_bytes: int | None = None) -> None:
        """Add a call's counters to the open batch (a call a shard) and
        enqueue ``stamps``' copy to pinned host memory on the current stream,
        which ``collect`` resolves."""
        stack = self._state.stack
        if not stack:
            return
        batch = stack[-1][0]
        batch.captured = batch.captured or captured
        if launches is not None:
            batch.launches = (batch.launches or 0) + launches
        if held_bytes is not None:
            batch.held_bytes = held_bytes
        if stamps is not None:
            # the stamps, then the counters where the call asked for them
            n = len(stamps.marks)
            parts = (stamps.buf[:n], stamps.counts) if stamps.counted else (stamps.buf[:n],)
            if stamps.device.type == "cuda":
                host = torch.empty(sum(len(x) for x in parts), dtype=torch.int64,
                                   pin_memory=True)
                host[:n].copy_(parts[0], non_blocking=True)
                if stamps.counted:
                    host[n:].copy_(parts[1], non_blocking=True)
            else:
                host = torch.cat(parts)
            batch.pending.append((stamps.device, host, tuple(stamps.marks)))

    def resolve(self, batch: Batch | None) -> None:
        """Map ``batch``'s arrived stamps onto the host's clock, sum each
        stage and add the counters that follow them (``collect``, once its
        wait has returned)."""
        if batch is None:
            return
        for device, host, marks in batch.pending:
            offset = self.clocks.get(device, (0, 0))[0]
            values = host.tolist()
            for name, v in zip(COUNTERS, values[len(marks):]):
                setattr(batch, name, (getattr(batch, name) or 0) + v)
            t = [v + offset for v in values[:len(marks)]]
            stages, first, inside, end = defaultdict(int), {}, [], None
            for (name, kind), v in zip(marks, t):
                if kind == ENTER:
                    inside.append((name, v))
                    first.setdefault(name, v)
                elif kind == EXIT and inside:
                    entered, v0 = inside.pop()
                    stages[entered] += v - v0
                elif name == "end":
                    end = v
            batch.devices.append(DeviceTimes(str(device), t[0], t[1] if len(t) > 1 else None,
                                             end, dict(stages), first))
        batch.pending = []

    def calibrate(self, device: torch.device, tries: int = 8) -> tuple[int, int]:
        """Measure and keep the offset of ``device``'s ``%globaltimer`` from
        ``perf_counter_ns``: -> (offset_ns, error_ns)."""
        buf = torch.zeros(1, dtype=torch.int64, device=device)
        best = None
        for _ in range(tries):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter_ns()
            build.check(build.library().tsd_stamp(buf.data_ptr(), 0, build.stream_ptr(device)),
                        "stamp")
            torch.cuda.synchronize(device)
            t1 = time.perf_counter_ns()
            card = int(buf.item())
            if best is None or t1 - t0 < 2 * best[1]:
                best = ((t0 + t1) // 2 - card, (t1 - t0) // 2)
        self.clocks[device] = best
        return best

    # --- reading -----------------------------------------------------------
    def window(self, t0: float, t1: float) -> list[Batch]:
        """The batches whose dispatch began in ``[t0, t1]``, seconds of
        ``time.perf_counter``."""
        lo, hi = t0 * 1e9, t1 * 1e9
        return [b for b in list(self.batches) if b.spans and lo <= b.start_ns <= hi]

    def snapshot(self) -> dict:
        """The resolved batches and each card's clock offset, as plain data."""
        return {"clocks": {str(d): {"offset_ns": o, "error_ns": e}
                           for d, (o, e) in self.clocks.items()},
                "batches": [b.as_dict() for b in list(self.batches) if not b.pending]}

    def reset(self) -> None:
        """Forget every batch."""
        self.batches.clear()


def label_gaps(batches: list[Batch]) -> list[tuple[str, int, int]]:
    """The card's gaps between batches, each labelled with what the host was
    doing at its midpoint: -> ``[(label, start_ns, end_ns)]``, one a pair of
    consecutive batches and shard, from the first one's ``end`` stamp to the
    next one's ``h2d`` stamp, labelled with the innermost host span covering
    the midpoint, or ``outside`` where the caller's own code held the host.
    The spans of one thread nest, so that span is the last one begun before
    the midpoint, or the first of its parents that still covers it."""
    spans = sorted(((s.start_ns, s.end_ns, s.name, s.parent, b)
                    for b in batches for s in b.spans), key=lambda s: s[0])
    starts = [s[0] for s in spans]
    done = sorted((b for b in batches if b.devices), key=lambda b: b.id)
    out = []
    for a, b in zip(done, done[1:]):
        if b.id != a.id + 1:
            continue
        for da, db in zip(a.devices, b.devices):
            if da.end_ns is None:
                continue
            mid = (da.end_ns + db.h2d_ns) // 2
            label, i = "outside", bisect.bisect_right(starts, mid) - 1
            if i >= 0:
                _, end, name, parent, owner = spans[i]
                while end < mid and parent is not None:
                    s = owner.spans[parent]
                    end, name, parent = s.end_ns, s.name, s.parent
                if end >= mid:
                    label = name
            out.append((label, da.end_ns, db.h2d_ns))
    return out


TRACER = Tracer()


def enable(on: bool = True) -> None:
    """Switch the process's tracer on or off (on by default)."""
    TRACER.enabled = on
