"""A batch function captured once a card and input shape as a CUDA graph,
then replayed for every batch.

The reference jits its batch functions (``detect_batch``,
``recognize_batch``): one compiled program a shape, dispatched once a batch,
whose host pays the Python cost at compile time.  On a card the counterpart
is a CUDA graph.  :class:`CapturedFn` wraps ``fn(frames, *consts)``, where
``frames`` is one tensor or a tuple of tensors (the three 4:2:0 planes of
the CNN's yuv routes):

* **on the CPU**, or with ``eager=True``, it calls ``fn`` each time;
* **on a card, at the first call with a key** (the card, each input's shape
  and dtype, and the caller's ``key``: the config that selects the work),
  :func:`capture_graph` runs ``fn`` once eagerly on the card's capture
  stream as a warm-up, which makes every first-use constant
  (``ops/resident.py``, K2's plan tables) and each kernel's shared-memory
  attribute, returns that run's outputs, and captures ``fn`` into a
  ``torch.cuda.CUDAGraph`` that reads a static input buffer an input; every
  graph of a card allocates from that card's one memory pool;
* **at every later call** it copies each input into its static buffer on
  the card's current stream without blocking (from pinned host memory, or
  from the card), replays the graph there and returns the graph's static
  outputs.

**Memory.**  Every graph of a card allocates from one pool: a capture takes
the free blocks the earlier ones left (their intermediates), so a card meets
many shapes and configs with about one workspace (one pool of 8.504 GiB held
8 MSER frame sizes and 12 CNN routes at batch 32 on an H100).  What each held
graph keeps on its own is its static input and its outputs.  One account a
card (:class:`_Card`) holds every :class:`CapturedFn` entry there, least
recently used first, with those bytes, and the bytes each pool's captures
reserved; at a miss, before the warm-up, :func:`_make_room` waits for the
card and drops the least recently used entries (of any :class:`CapturedFn`
on the card, never the caller's last one) until the account fits
:data:`GRAPH_MEMORY_SHARE` of the card.  A pool is given back only when no
held graph is in it, so when evicting the rest is not enough the card's
later captures go to a new pool, and the old one is freed with its last
graph.  A capture that does not fit even then still captures.  An evicted
key captures again at its next call.  The training steps' graphs
(:func:`capture_call`) are not in the account: one graph each, in a pool of
its own.

A ``keyed`` function takes the key first, ``fn(key, frames, *consts)``, as a
jitted function takes its static arguments: the CNN's routes read their
baked values (route, threshold, upscale plan) from it, so copies of one
detector that differ in them share one :class:`CapturedFn`.

A capture that fails raises :class:`GraphCaptureError`, naming the site in
the port that refused (a host sync, or a constant first made inside the
capture): there is no eager retry.

:func:`capture_call` is the capture step itself, for a function of no
static input: the CNN training step (``models/cnn_train.py: TrainStep``)
captures its whole step with it, into a memory pool of the graph's own, and
draws its crops from a generator of its own that the graph registers, whose
seed at each replay the replay's draws follow.

**Two batches in flight.**  Stream order is the whole argument.  A call
enqueues the copy into the static input and the replay on the card's current
stream; the caller enqueues its copy of the static outputs (to pinned host
memory, ``parallel/mesh.py: to_host``) on that same stream before it calls
again.  So the next call's copy into the input runs after the previous
replay has read it, and the next replay after the previous outputs were
copied out.  A caller that keeps outputs past its next call with the same
key clones them first.  Graphs that share a card's pool are replayed on one
stream, in turn, never at once.

**Launch counts.**  A replay never calls the kernels' Python wrappers, so
the launches recorded while a graph is captured (``runtime/build.py:
recording_launches``) are the graph's launches a replay, and each replay
adds them to the counts.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import math
import traceback
import weakref
from pathlib import Path

import torch

from . import build

PACKAGE = Path(__file__).resolve().parents[1]

# The share of a card's memory that the graphs CapturedFn holds there may
# keep between calls: their pools and each graph's static input and outputs.
GRAPH_MEMORY_SHARE = 1 / 8


class GraphCaptureError(RuntimeError):
    """A function could not be captured into a CUDA graph."""


class _Card:
    """A card's capture stream, the pool its next capture goes to, and its
    account: ``pools``, the bytes the captures into each pool reserved, and
    ``held``, {(owner, key): (pool, bytes of its static input and outputs)}
    of every :class:`CapturedFn` entry on the card, least recently used
    first."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = self.pool = None
        self.pools: dict = {}
        self.held: collections.OrderedDict = collections.OrderedDict()

    def side_stream(self):
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        return self.stream

    def graph_pool(self):
        """The pool for the next capture: a new one where no held graph is
        in the last (a pool whose graphs are all gone may be given back)."""
        if self.pool not in {pool for pool, _ in self.held.values()}:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def held_bytes(self) -> int:
        return sum(self.pools.values()) + sum(b for _, b in self.held.values())


# one capture stream, graph pool and account a card: {device: _Card}
_cards: dict = {}


def _card(device: torch.device) -> _Card:
    if device not in _cards:
        _cards[device] = _Card(device)
    return _cards[device]


def budget_bytes(device: torch.device) -> float:
    """:data:`GRAPH_MEMORY_SHARE` of the card's memory (no bound off a card)."""
    if device.type != "cuda":
        return math.inf
    return GRAPH_MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory


def held_bytes(device: torch.device) -> int:
    """The bytes the card's account holds: its graphs' pools and their
    static inputs and outputs."""
    card = _card(torch.device(device))
    _prune(card)
    return card.held_bytes()


def _nbytes(x) -> int:
    """Bytes of every tensor in ``x`` (nested tuples, lists and dicts)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list, dict)):
        return sum(_nbytes(o) for o in (x.values() if isinstance(x, dict) else x))
    return 0


def _hold(device: torch.device, record: tuple, entry) -> None:
    """Enter a new capture in its card's account, the most recently used."""
    card = _card(device)
    pool = getattr(entry, "pool", None)
    card.pools[pool] = card.pools.get(pool, 0) + getattr(entry, "pool_bytes", 0)
    card.held.pop(record, None)
    card.held[record] = (pool, _nbytes(getattr(entry, "static", None))
                         + _nbytes(getattr(entry, "outputs", None)))


def _evict(card: _Card, record: tuple) -> None:
    """Drop one entry from its owner and the account; a pool no held graph
    is in leaves the account (the allocator frees it with its graphs)."""
    pool, _ = card.held.pop(record)
    owner = record[0]()
    if owner is not None:
        owner._entries.pop(record[1], None)
    if pool not in {p for p, _ in card.held.values()}:
        card.pools.pop(pool, None)


def _prune(card: _Card) -> None:
    """Drop the records of functions that are gone (their graphs with them)."""
    for record in [r for r in card.held if r[0]() is None]:
        _evict(card, record)


def _make_room(device: torch.device, spare: tuple) -> None:
    """At a miss, before the warm-up and outside any capture: drop the
    card's least recently used entries but ``spare`` (the caller's last,
    whose outputs the caller may still read) until the account fits the
    budget, after every queued replay and copy on the card is done; where
    that is not enough, the card's later captures go to a new pool."""
    card = _card(device)
    _prune(card)
    budget = budget_bytes(device)
    if card.held_bytes() <= budget:
        return
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    for record in list(card.held):
        if card.held_bytes() <= budget:
            break
        if record != spare:
            _evict(card, record)
    gc.collect()
    if card.held_bytes() > budget:
        card.pool = None
    if on_card:
        torch.cuda.empty_cache()


def device_scope(device: torch.device):
    """Context with ``device`` as the current card (nothing off a card)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def refusing_site(exc: BaseException) -> str:
    """``file:line: source: message`` of the innermost frame of the package
    outside ``runtime/`` (this helper, the kernels' loader) in ``exc``, or in
    the exception it was raised while handling: the op that refused a
    capture."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        ours = [f for f in traceback.extract_tb(exc.__traceback__)
                if Path(f.filename).resolve().is_relative_to(PACKAGE)
                and not Path(f.filename).resolve().is_relative_to(PACKAGE / "runtime")]
        if ours:
            f = ours[-1]
            where = Path(f.filename).resolve().relative_to(PACKAGE.parent)
            return f"{where}:{f.lineno}: {f.line}: {type(exc).__name__}: {exc}"
        exc = exc.__cause__ or exc.__context__
    return "no frame of the package"


def _on_stream(out, stream) -> None:
    """Mark every tensor of ``out`` (nested tuples, lists and dicts) as used
    on ``stream``, so the allocator does not hand out its memory before the
    stream is done with it."""
    if isinstance(out, torch.Tensor):
        out.record_stream(stream)
    elif isinstance(out, (tuple, list, dict)):
        for o in out.values() if isinstance(out, dict) else out:
            _on_stream(o, stream)


def _inputs(x) -> tuple:
    """``x``, a tensor or a tuple of tensors, as a tuple."""
    return x if isinstance(x, tuple) else (x,)


def _signature(x) -> tuple:
    """(shape, dtype) of a tensor input, or (the shapes, the dtypes) of a
    tuple of them."""
    if isinstance(x, tuple):
        return tuple(tuple(t.shape) for t in x), tuple(t.dtype for t in x)
    return tuple(x.shape), x.dtype


def _require_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")


@dataclasses.dataclass
class Captured:
    """One captured graph: its static input (a tensor, a tuple of them, or
    ``None`` for a function of no input) and outputs, its launches a replay,
    the bytes its capture reserved on the card for its pool (what the pool's
    free blocks did not cover), and that pool (``None``: a pool of its
    own)."""

    graph: object
    static: torch.Tensor | tuple | None
    outputs: object
    launches: dict
    pool_bytes: int
    pool: tuple | None = None

    def replay(self, x=None):
        if self.static is not None:
            for s, t in zip(_inputs(self.static), _inputs(x), strict=True):
                s.copy_(t, non_blocking=True)
        self.graph.replay()
        build.add_launches(self.launches)
        return self.outputs


def capture_call(fn, device: torch.device, args: tuple, what: str, pool=None,
                 generator: torch.Generator | None = None):
    """Warm ``fn(*args)`` up on ``device``'s capture stream, which makes its
    first-use constants and the cuBLAS and cuDNN workspaces of that stream,
    and capture it there into a CUDA graph that allocates from ``pool`` (by
    default a pool of the graph's own) and draws from ``generator`` (a
    generator of the card's own, registered with the graph: each replay
    draws from the seed it holds then).  -> (the warm-up's outputs,
    :class:`Captured` with no static input).  Raises
    :class:`GraphCaptureError`, naming ``what`` and the refusing site, when
    the capture fails."""
    _require_card(device)
    side = _card(device).side_stream()
    current = torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        first = fn(*args)
    current.wait_stream(side)
    _on_stream(first, current)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # A graph freed during the capture (an earlier pipeline's, in a reference
    # cycle) would destroy its executable graph, which the capture refuses:
    # collect such garbage first and let no collection run inside.
    gc.collect()
    gc.disable()
    try:
        with build.recording_launches() as launches:
            with torch.cuda.graph(graph, pool=pool, stream=side):
                reserved = torch.cuda.memory_reserved(device)
                outputs = fn(*args)
    except Exception as e:
        card = _card(device)  # the failed capture leaves the stream and pool unusable
        card.stream = card.pool = None
        name = getattr(getattr(fn, "func", fn), "__qualname__", fn)  # a keyed fn's partial
        raise GraphCaptureError(
            f"capturing {name} on {device} {what} failed at {refusing_site(e)}") from e
    finally:
        gc.enable()
    return first, Captured(graph, None, outputs, dict(launches),
                           torch.cuda.memory_reserved(device) - reserved)


def capture_graph(fn, device: torch.device, x, consts: tuple):
    """Warm ``fn(static, *consts)`` up on ``device`` with ``x`` (a tensor, or
    a tuple of tensors) in a static input of the same structure and capture
    it into the card's pool (:func:`capture_call`).  -> (the warm-up's
    outputs, :class:`Captured`)."""
    _require_card(device)
    pool = _card(device).graph_pool()
    statics = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in _inputs(x))
    for s, t in zip(statics, _inputs(x)):
        s.copy_(t, non_blocking=True)
    static = statics if isinstance(x, tuple) else statics[0]
    shapes, dtypes = _signature(x)
    first, entry = capture_call(fn, device, (static, *consts),
                                f"for input {shapes} {dtypes}", pool)
    entry.static, entry.pool = static, pool
    return first, entry


class CapturedFn:
    """``fn(frames, *consts)`` replayed from one CUDA graph a card, input
    shape and key; eager on the CPU (:attr:`EAGER_DEVICES`).  ``capture`` is
    the capture step (:func:`capture_graph`); ``keyed``: ``fn`` takes the
    call's ``key`` first."""

    EAGER_DEVICES = ("cpu",)

    def __init__(self, fn, capture=capture_graph, keyed: bool = False):
        self.fn = fn
        self._capture = capture
        self.keyed = keyed
        self._entries: dict = {}  # key -> (consts, Captured)
        self._ref = weakref.ref(self)  # its records in the cards' accounts
        self._last: dict = {}  # device -> the key of its last call there

    def __call__(self, device: torch.device, x, *consts, key=(), eager: bool = False):
        """``fn`` of ``x`` (a tensor or a tuple of tensors, on the host,
        pinned, or on ``device``) on ``device``.  On a card, a graph captures
        ``consts`` (tensors) by address: other tensors than the last call's
        with this key make a new capture."""
        device = torch.device(device)
        fn = functools.partial(self.fn, key) if self.keyed else self.fn
        if eager or device.type in self.EAGER_DEVICES:
            moved = tuple(t.to(device, non_blocking=True) for t in _inputs(x))
            return fn(moved if isinstance(x, tuple) else moved[0], *consts)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        k = (device, *_signature(x), key)
        held = self._entries.get(k)
        spare, self._last[device] = (self._ref, self._last.get(device)), k
        # the static input is made, written and read in one mode
        with torch.inference_mode(), device_scope(device):
            if held is not None and len(held[0]) == len(consts) and all(
                    a is b for a, b in zip(held[0], consts)):
                _card(device).held.move_to_end((self._ref, k))
                return held[1].replay(x)
            _make_room(device, spare)
            first, entry = self._capture(fn, device, x, consts)
        self._entries[k] = (consts, entry)
        _hold(device, (self._ref, k), entry)
        return first

    def entries(self) -> dict:
        """{(device, shape, dtype, key): Captured} of the graphs held (a
        tuple input's shapes and dtypes)."""
        return {k: held[1] for k, held in self._entries.items()}
