"""The CUDA-graph dispatch helper (``runtime/graphs.py``) on the CPU.

The CPU cannot capture a graph, so these tests hold what it can show: on
the CPU the helper calls the function each time and never captures; off the
CPU it keeps one entry a device, shape, dtype, key and set of constants,
which a stand-in capture step (injected into the helper) makes here on the
``meta`` device; a capture step that raises propagates with no eager retry;
a replay copies its input into the static buffer and adds the launches its
capture recorded.  The card-wide account of held graphs, against a budget
patched in (the stand-in's captures carry their pools and pool bytes):
entries beyond it evict the least recently used of any ``CapturedFn`` on
that device, never the caller's last one and never inside a capture; an
evicted key captures again; a shared pool leaves the account only with its
last graph.  On a card ``chip_smoke.py`` holds every replayed dispatch
equal to the eager one, bit for bit, and its graph memory phase the
account's bound.
"""

import types

import numpy as np
import pytest
import torch

from opencv_traffic_sign_detector_tpu_torch.models import detector as tdet
from opencv_traffic_sign_detector_tpu_torch.ops import clahe_cuda
from opencv_traffic_sign_detector_tpu_torch.parallel import mesh as tmesh
from opencv_traffic_sign_detector_tpu_torch.runtime import build, graphs

torch.set_num_threads(1)

META = torch.device("meta")


class StandIn:
    """A capture step that records its calls and replays by calling the
    function: (the warm-up's outputs, an entry whose ``replay`` calls it).
    Its entries reserve ``pool_bytes`` each, in a pool of their own, or
    (``shared``) in the card's pool (``graphs._Card.graph_pool``), where
    only a pool's first capture reserves; ``log`` records each capture's
    start and end."""

    def __init__(self, pool_bytes: int = 0, shared: bool = False, log: list | None = None):
        self.captures = []
        self.replays = 0
        self.pool_bytes, self.shared, self.log = pool_bytes, shared, log

    def __call__(self, fn, device, x, consts):
        if self.log is not None:
            self.log.append("capture")
        self.captures.append((device, tuple(x.shape), x.dtype))

        def replay(y):
            self.replays += 1
            return fn(y, *consts)

        pool, reserved = object(), self.pool_bytes
        if self.shared:
            card = graphs._card(device)
            pool = card.graph_pool()
            reserved = 0 if pool in card.pools else self.pool_bytes
        entry = types.SimpleNamespace(replay=replay, pool=pool, pool_bytes=reserved)
        if self.log is not None:
            self.log.append("captured")
        return fn(x, *consts), entry


def _counting(fn):
    calls = []

    def wrapped(x, *consts):
        calls.append(tuple(x.shape))
        return fn(x, *consts)

    return wrapped, calls


def test_cpu_calls_the_function_each_time_and_never_captures():
    step = StandIn()
    fn, calls = _counting(lambda x, c: x * 2 + c)
    g = graphs.CapturedFn(fn, capture=step)
    x, c = torch.arange(6.0).reshape(2, 3), torch.ones(3)
    for _ in range(3):
        assert torch.equal(g("cpu", x, c, key="cfg"), x * 2 + 1)
    assert calls == [(2, 3)] * 3
    assert step.captures == [] and g.entries() == {}


def test_eager_off_the_cpu_calls_the_function_and_never_captures():
    step = StandIn()
    fn, calls = _counting(lambda x: x + 1)
    g = graphs.CapturedFn(fn, capture=step)
    for _ in range(2):
        g(META, torch.empty(4, 2, device=META), eager=True)
    assert len(calls) == 2 and step.captures == [] and g.entries() == {}


def test_the_same_key_reuses_its_entry():
    step = StandIn()
    fn, calls = _counting(lambda x, c: x + c)
    g = graphs.CapturedFn(fn, capture=step)
    c = torch.empty(3, device=META)
    for _ in range(4):
        out = g(META, torch.empty(2, 3, device=META), c, key="cfg")
        assert out.shape == (2, 3)
    assert step.captures == [(META, (2, 3), torch.float32)]
    assert step.replays == 3  # the first call returns the warm-up's outputs
    assert len(g.entries()) == 1


@pytest.mark.parametrize("change", ["shape", "dtype", "key", "consts", "device"])
def test_a_new_shape_dtype_key_or_constant_makes_a_new_entry(change):
    step = StandIn()
    g = graphs.CapturedFn(lambda x, c: x + c, capture=step)
    c = torch.empty(3, device=META)
    g(META, torch.empty(2, 3, device=META), c, key="a")
    args = {"shape": (torch.empty(5, 3, device=META), c, "a"),
            "dtype": (torch.empty(2, 3, device=META, dtype=torch.float64), c, "a"),
            "key": (torch.empty(2, 3, device=META), c, "b"),
            "consts": (torch.empty(2, 3, device=META), torch.empty(3, device=META), "a"),
            "device": (torch.empty(2, 3, device=META), c, "a")}[change]
    dev = torch.device("meta", 0) if change == "device" else META
    g(dev, args[0], args[1], key=args[2])
    assert len(step.captures) == 2 and step.replays == 0
    # the constants are held by identity: a changed set replaces the entry
    assert len(g.entries()) == (1 if change == "consts" else 2)


def test_a_failed_capture_propagates_with_no_eager_retry():
    fn, calls = _counting(lambda x: x + 1)

    def refusing(fn_, device, x, consts):
        raise graphs.GraphCaptureError("refused at ops/x.py:1")

    g = graphs.CapturedFn(fn, capture=refusing)
    for _ in range(2):  # no entry is kept: each call tries the capture again
        with pytest.raises(graphs.GraphCaptureError, match="refused"):
            g(META, torch.empty(2, device=META))
    assert calls == [] and g.entries() == {}


def test_capture_graph_refuses_a_device_that_is_not_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.capture_graph(lambda x: x, torch.device("cpu"), torch.zeros(2), ())


def test_refusing_site_names_the_ops_line_through_a_chained_error():
    try:
        try:
            clahe_cuda.tile_histograms(np.zeros((1, 8, 8), np.uint8))
        except TypeError as inner:
            raise RuntimeError("capture ended with an error") from inner
    except RuntimeError as e:
        site = graphs.refusing_site(e)
    # the op's own line, not the loader's check (runtime/) that raised
    assert site.startswith("opencv_traffic_sign_detector_tpu_torch/ops/clahe_cuda.py:")
    assert "TypeError" in site and "expected a tensor" in site
    assert graphs.refusing_site(ValueError("no traceback")) == "no frame of the package"


def test_recording_launches_keeps_a_capture_out_of_the_counts():
    build.reset_launch_counts()
    build.count_launch("clahe_apply")
    with build.recording_launches() as rec:
        build.count_launch("level_sweep")
        build.count_launch("level_sweep")
    build.count_launch("flood_bbox")
    counts = build.launch_counts()
    assert rec["level_sweep"] == 2 and sum(rec.values()) == 2
    assert counts["clahe_apply"] == 1 and counts["flood_bbox"] == 1
    assert counts["level_sweep"] == 0
    build.add_launches(rec)
    build.add_launches(rec)
    assert build.launch_counts()["level_sweep"] == 4
    build.reset_launch_counts()


def test_a_replay_writes_the_static_input_and_adds_its_launches():
    build.reset_launch_counts()
    replayed = []
    static = torch.zeros(2, 3, dtype=torch.uint8)
    entry = graphs.Captured(graph=types.SimpleNamespace(replay=lambda: replayed.append(1)),
                            static=static, outputs=("out",),
                            launches={"tile_luts": 1, "clahe_apply": 1}, pool_bytes=0)
    x = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    assert entry.replay(x) == ("out",)
    assert torch.equal(static, x) and replayed == [1]
    counts = build.launch_counts()
    assert counts["tile_luts"] == 1 and counts["clahe_apply"] == 1
    build.reset_launch_counts()


def test_host_shards_split_as_shard_batch_on_the_cpu():
    mesh = tmesh.data_mesh(4, device="cpu")
    x = np.arange(8 * 3, dtype=np.uint8).reshape(8, 3)
    host = tmesh.host_shards(mesh, x)
    dev = tmesh.shard_batch(mesh, x)
    assert len(host) == 4 and all(torch.equal(a, b) for a, b in zip(host, dev))
    assert not any(h.is_pinned() for h in host)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.host_shards(mesh, x[:7])


def test_pinned_leaves_frames_for_the_cpu_as_they_are():
    t = torch.zeros(2, 3, dtype=torch.uint8)
    assert tdet.pinned(t, "cpu") is t
    a = np.zeros((2, 3), np.uint8)
    assert torch.equal(tdet.pinned(a, "cpu"), torch.from_numpy(a))
    assert torch.equal(tdet.upload(a, "cpu"), torch.from_numpy(a))


def test_sharded_detect_fn_passes_key_and_eager_to_the_helper():
    mesh = tmesh.data_mesh(2, device="cpu")
    seen = []

    def detect(frames, red, blue):
        seen.append(frames.shape[0])
        return frames.sum(dim=(1, 2)) + red.sum() + blue.sum()

    run = tmesh.sharded_detect_fn(mesh, detect)
    x = torch.arange(4 * 2 * 2, dtype=torch.float32).reshape(4, 2, 2)
    red, blue = torch.ones(3), torch.zeros(3)
    outs = run(tmesh.host_shards(mesh, x), red, blue, key="cfg", eager=False)
    want = x.sum(dim=(1, 2)) + 3
    assert torch.equal(torch.cat(outs), want) and seen == [2, 2]
    assert isinstance(run.graphs, graphs.CapturedFn) and run.graphs.entries() == {}


def test_two_shards_on_one_device_keep_a_graph_each():
    mesh = tmesh.Mesh((META, META))
    run = tmesh.sharded_detect_fn(mesh, lambda frames, red, blue: frames + red + blue)
    step = run.graphs._capture = StandIn()
    shards = [torch.empty(2, 3, device=META) for _ in range(2)]
    red, blue = torch.empty(3, device=META), torch.empty(3, device=META)
    for _ in range(3):
        outs = run(shards, red, blue, key="cfg")
        assert len(outs) == 2
    # one capture a shard, then a replay a shard a call: no shard reads the
    # other's outputs
    assert len(step.captures) == 2 and step.replays == 4
    assert sorted(k[3] for k in run.graphs.entries()) == [(0, "cfg"), (1, "cfg")]


# --- the card-wide account of held graphs, against a budget ------------------

def _budget(monkeypatch, nbytes: int) -> None:
    """A budget of ``nbytes`` on every device, a fresh account, and pool
    handles off a counter (the CPU build has no CUDA pools)."""
    handles = iter(range(10**6))
    monkeypatch.setattr(graphs, "budget_bytes", lambda device: nbytes, raising=False)
    monkeypatch.setattr(graphs, "_cards", {})
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool", next(handles)))


def _shapes(g) -> list:
    """Rows of the input of each entry ``g`` holds, in capture order."""
    return [k[1][0] for k in g.entries()]


def _call(g, rows: int, dev=META):
    return g(dev, torch.empty(rows, 3, device=META), key="cfg")


def test_entries_stay_within_the_budget_as_shapes_come():
    """Twelve frame shapes through one function: without a bound every
    shape keeps its graph; the account keeps those that fit 250 bytes, 100
    a graph, and the caller's last one beyond them."""
    mp = pytest.MonkeyPatch()
    try:
        _budget(mp, 250)
        step = StandIn(pool_bytes=100)
        g = graphs.CapturedFn(lambda x: x + 1, capture=step)
        for rows in range(1, 13):
            _call(g, rows)
            assert len(g.entries()) <= 3
        assert len(step.captures) == 12 and _shapes(g) == [10, 11, 12]
        assert graphs.held_bytes(META) == 300
    finally:
        mp.undo()


def test_entries_beyond_the_budget_evict_the_least_recently_used(monkeypatch):
    _budget(monkeypatch, 250)
    g = graphs.CapturedFn(lambda x: x + 1, capture=StandIn(pool_bytes=100))
    for rows in (1, 2, 3):  # the third goes past the budget: nothing is evicted yet
        _call(g, rows)
    assert _shapes(g) == [1, 2, 3] and graphs.held_bytes(META) == 300
    _call(g, 4)  # the miss drops the least recently used until 200 <= 250
    assert _shapes(g) == [2, 3, 4]


def test_a_replayed_entry_counts_as_used(monkeypatch):
    _budget(monkeypatch, 250)
    step = StandIn(pool_bytes=100)
    g = graphs.CapturedFn(lambda x: x + 1, capture=step)
    for rows in (1, 2, 3, 1):  # the last call replays 1: 2 is now the oldest
        _call(g, rows)
    assert step.replays == 1
    _call(g, 4)
    assert sorted(_shapes(g)) == [1, 3, 4]


def test_an_evicted_key_captures_again(monkeypatch):
    _budget(monkeypatch, 150)
    step = StandIn(pool_bytes=100)
    fn, calls = _counting(lambda x: x * 2)
    g = graphs.CapturedFn(fn, capture=step)
    _call(g, 1)
    _call(g, 2)   # 100 <= 150: 1 stays
    _call(g, 3)   # 200 > 150: 1 goes, 2 is the caller's last
    assert _shapes(g) == [2, 3]
    x = torch.arange(3.0).reshape(1, 3)
    out = g("cpu", x)  # the CPU still calls the function
    assert torch.equal(out, x * 2)
    _call(g, 1)   # 1 captures again
    assert [c[1][0] for c in step.captures] == [1, 2, 3, 1] and step.replays == 0
    _call(g, 1)
    assert step.replays == 1 and 1 in _shapes(g)


def test_the_callers_last_entry_is_never_evicted(monkeypatch):
    """A budget smaller than one graph: each miss drops every other entry
    but keeps the one the caller's previous batch may still read."""
    _budget(monkeypatch, 50)
    g = graphs.CapturedFn(lambda x: x + 1, capture=StandIn(pool_bytes=100))
    for rows in (1, 2, 3):
        _call(g, rows)
        assert _shapes(g)[-1] == rows and len(g.entries()) <= 2
    assert _shapes(g) == [2, 3]


def test_two_functions_on_one_device_share_the_account_and_two_devices_do_not(monkeypatch):
    _budget(monkeypatch, 250)
    other_dev = torch.device("meta", 1)
    a = graphs.CapturedFn(lambda x: x + 1, capture=StandIn(pool_bytes=100))
    b = graphs.CapturedFn(lambda x: x - 1, capture=StandIn(pool_bytes=100))
    _call(a, 1)
    _call(a, 2)
    for rows in (1, 2, 3):  # another device: an account of its own
        _call(b, rows, other_dev)
    assert graphs.held_bytes(META) == 200 and graphs.held_bytes(other_dev) == 300
    _call(b, 4)  # 200 fits: nothing goes
    _call(b, 5)  # META holds 300: b's miss drops a's oldest
    assert _shapes(a) == [2] and [k[1][0] for k in b.entries() if k[0] == META] == [4, 5]
    assert len([k for k in b.entries() if k[0] == other_dev]) == 3


def test_a_dropped_function_leaves_the_account(monkeypatch):
    _budget(monkeypatch, 250)
    a = graphs.CapturedFn(lambda x: x + 1, capture=StandIn(pool_bytes=100))
    _call(a, 1)
    _call(a, 2)
    del a
    b = graphs.CapturedFn(lambda x: x - 1, capture=StandIn(pool_bytes=100))
    _call(b, 1)
    assert graphs.held_bytes(META) == 100


def test_eviction_never_runs_inside_a_capture(monkeypatch):
    _budget(monkeypatch, 150)
    log = []
    evict = graphs._evict

    def logged(card, record):
        log.append("evict")
        evict(card, record)

    monkeypatch.setattr(graphs, "_evict", logged)
    g = graphs.CapturedFn(lambda x: x + 1, capture=StandIn(pool_bytes=100, log=log))
    for rows in (1, 2, 3, 4):
        _call(g, rows)
    assert log.count("evict") == 2
    inside = False
    for event in log:
        assert not (inside and event == "evict")
        inside = {"capture": True, "captured": False}.get(event, inside)


def test_captures_share_the_cards_pool_while_the_account_fits(monkeypatch):
    _budget(monkeypatch, 250)
    g = graphs.CapturedFn(lambda x: x + 1, capture=StandIn(pool_bytes=200, shared=True))
    for rows in (1, 2, 3, 4):
        _call(g, rows)
    card = graphs._cards[META]
    assert len(g.entries()) == 4 and list(card.pools.values()) == [200]
    assert {pool for pool, _ in card.held.values()} == {card.pool}


def test_a_shared_pool_leaves_the_account_with_its_last_graph(monkeypatch):
    """A pool over the budget: its graphs are dropped but the caller's last,
    which keeps the pool; the next capture goes to a new pool, and the old
    one leaves the account when its last graph does."""
    _budget(monkeypatch, 150)
    g = graphs.CapturedFn(lambda x: x + 1, capture=StandIn(pool_bytes=200, shared=True))
    card = graphs._card(META)
    _call(g, 1)
    first = card.pool
    _call(g, 2)  # over the budget with nothing to drop but 1: a new pool
    second = card.pool
    assert _shapes(g) == [1, 2] and second != first
    assert set(card.pools) == {first, second} and graphs.held_bytes(META) == 400
    _call(g, 3)  # 1 goes, and the first pool with it
    assert _shapes(g) == [2, 3] and set(card.pools) == {second, card.pool}
