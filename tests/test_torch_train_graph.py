"""The CNN training step as one CUDA graph (``models/cnn_train.py:
TrainStep``) on the CPU.

The CPU cannot capture a graph, so these tests hold what it can show:

* (a) the learning-rate table equals ``learning_rate`` bit for bit, and its
  device lookup clamps past the end;
* (b) three steps of the step's body (draws from its own generator, seeded
  with the step's state) equal, bit for bit, the decomposed eager path that
  ``tests/test_torch_cnn_train.py`` holds against the reference:
  ``sample_draws`` -> ``crops_from_draws`` -> ``update``;
* (c) the body as the card runs it (the capturable AdamW, its rate and
  count on the device) makes no tensor from host data and reads no scalar
  back in its second call, and never calls ``learning_rate``;
* (d) with a stand-in capture step injected, the step captures once and
  replays after that, the generator seeded with each step's state before
  each replay; a timer and the CPU never capture; a capture that raises
  propagates with no eager retry;
* (e) the metrics that ``train()`` returns are not the graph's outputs,
  which a later replay rewrites.

(c)-(e) let the step take its card path on the CPU: ``GRAPH_DEVICES``
takes the CPU, and torch's capturable AdamW, whose update is plain tensor
arithmetic, is let past its device check.  Their configs warm up over 0
counts: at a rate of 0 torch's single-tensor capturable update, which the
CPU takes, divides 0 by 0 where a gradient is 0; the card's foreach update
adds eps first.  On a card ``chip_smoke.py`` phase 14 holds the replayed
step against the eager one.
"""

import collections
import contextlib
import importlib
import os
import traceback
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_train as tct
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
from opencv_traffic_sign_detector_tpu_torch.runtime import graphs

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "opencv_traffic_sign_detector_tpu_torch"
TINY = dict(stem_features=16, mid_features=24, deep_features=32, head_features=24)
# counts 0 and 1 in the warm-up, 2 in the decay
STEP_CFG = tct.TrainConfig(batch_size=4, steps=10, warmup_steps=2, lr=1e-3, seed=3)
GRAPH_CFG = tct.TrainConfig(batch_size=2, steps=10, warmup_steps=0, lr=1e-3, seed=3)


@pytest.fixture(scope="module")
def data():
    frames, found = make_labelled_frames(3, 480, 640, seed=1)
    return {k: torch.from_numpy(v) for k, v in tct.pack_dataset(frames, found).items()}


def _model(arch: str):
    kw = {} if arch == "v3" else TINY
    cfg = tcd.CNNDetectorConfig(arch=arch, dtype="float32", **kw)
    return tcd.init_params(tct.SignCenterNetV3Train(cfg) if arch == "v3"
                           else tcd.SignCenterNet(cfg), 1)


def _graphed_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tct.TrainStep, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"),
                        "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cuda", "cpu"])


def _state(model) -> dict:
    return {**tcd.flat_params(model), **{f"stat {k}": v for k, v in
                                         tcd.flat_params(model, "batch_stats").items()}}


def _same_state(a, b) -> bool:
    sa, sb = _state(a), _state(b)
    return sa.keys() == sb.keys() and all(np.array_equal(sa[k], sb[k]) for k in sa)


# ---------------------------------------------------------------------------
# (a) the learning-rate table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,steps", [(200, 4000), (3, 34), (0, 10)])
def test_lr_table_equals_learning_rate_and_clamps(warmup, steps):
    cfg = tct.TrainConfig(warmup_steps=warmup, steps=steps)
    table = tct.lr_table(cfg, "cpu")
    assert table.dtype == torch.float32 and table.shape == (steps + 1,)
    assert table.tolist() == [tct.learning_rate(c, cfg) for c in range(steps + 1)]
    for c in (0, warmup, steps - 1, steps, steps + 1, steps + 1000):
        got = tct.lr_at(table, torch.tensor(c))
        assert got.dim() == 0 and got.item() == tct.learning_rate(min(c, steps), cfg), c


@pytest.mark.parametrize("steps", [2, 200])
def test_lr_table_of_a_run_inside_its_warmup(steps):
    """``steps <= warmup_steps`` (200): the table holds the warm-up's counts
    the run reaches, where ``learning_rate`` has no decay to evaluate."""
    cfg = tct.TrainConfig(steps=steps)
    table = tct.lr_table(cfg, "cpu")
    assert table.tolist() == [tct.learning_rate(c, cfg) for c in range(min(steps + 1, 200))]
    assert tct.lr_at(table, torch.tensor(steps + 5)).item() == table[-1].item()


# ---------------------------------------------------------------------------
# (b) the body against the decomposed eager path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["v3", "slim"])
def test_body_equals_the_decomposed_eager_path(arch, data):
    """Steps 7, 3, 5 (counts 0 and 1 in the warm-up, 2 in the decay), batch
    4, f32: loss and parts, parameters, running statistics and the count
    equal bit for bit."""
    cfg = STEP_CFG
    body, ref = tct.TrainStep(_model(arch), cfg), tct.TrainStep(_model(arch), cfg)
    assert not body.graphed and _same_state(body.model, ref.model)
    start = _state(body.model)
    for count, step in enumerate((7, 3, 5)):
        got = body(data, step)
        draws = tct.sample_draws(tct.step_generator(cfg.seed, step, "cpu"), cfg.batch_size,
                                 len(data["frames"]), len(data["pos"]), cfg)
        want = ref.update(*tct.crops_from_draws(draws, data, cfg))
        assert got.keys() == want.keys() == {"loss", "hm", "wh", "off"}
        assert all(torch.equal(got[k], want[k]) for k in want), count
        assert _same_state(body.model, ref.model), count
        assert body.count.item() == ref.count.item() == count + 1
        assert body.lr.item() == tct.learning_rate(count, cfg)
    moved = max(np.abs(v - start[k]).max() for k, v in _state(body.model).items())
    assert moved > 1e-5


# ---------------------------------------------------------------------------
# (c) no host data and no scalar read in the card's body
# ---------------------------------------------------------------------------


class HostReads(TorchDispatchMode):
    """Records each tensor made from host data (``aten.lift_fresh``) and each
    scalar read back (``aten._local_scalar_dense``): op and innermost
    frame."""

    def __init__(self):
        super().__init__()
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.lift_fresh, torch.ops.aten._local_scalar_dense):
            here = traceback.extract_stack()[-2]
            ours = [f for f in traceback.extract_stack() if PKG in f.filename] or [here]
            self.sites[f"{func.overloadpacket.__name__} at {os.path.relpath(here.filename, REPO)}:"
                       f"{here.lineno} (the port's {ours[-1].name}:{ours[-1].lineno})"] += 1
        return func(*args, **(kwargs or {}))


def test_recorder_sees_host_data_and_scalar_reads():
    rec = HostReads()
    with rec:
        torch.tensor(1.0)
        torch.zeros(2).sum().item()
        float(torch.ones(()))
    assert sum(rec.sites.values()) == 3


@pytest.mark.parametrize("arch", ["v3", "slim"])
def test_graphed_body_reads_nothing_from_the_host(arch, data, monkeypatch):
    _graphed_on_the_cpu(monkeypatch)
    step = tct.TrainStep(_model(arch), GRAPH_CFG)
    assert step.graphed and step.opt.defaults["capturable"]
    step.gen.manual_seed(1)
    step._body(data)                  # makes the constants and the optimizer's state

    def refused(*a, **kw):
        raise AssertionError("learning_rate called inside the step")

    monkeypatch.setattr(tct, "learning_rate", refused)
    step.gen.manual_seed(2)
    rec = HostReads()
    with rec:
        out = step._body(data)
    assert dict(rec.sites) == {}
    assert step.count.item() == 2 and all(torch.isfinite(v) for v in out.values())


# ---------------------------------------------------------------------------
# (d) capture once, then replay; never on the CPU or with a timer
# ---------------------------------------------------------------------------


class StandIn:
    """A capture step that runs the body once eagerly (the warm-up) and, as
    a graph does, returns from each replay the same output tensors,
    rewritten in place; records its captures and the generator's seed at
    each replay."""

    def __init__(self):
        self.captures, self.seeds, self.entries = [], [], []

    def __call__(self, fn, device, args, what, pool=None, generator=None):
        self.captures.append((device, what))
        first = fn(*args)
        outputs = {k: torch.empty_like(v) for k, v in first.items()}

        def replay(x=None):
            self.seeds.append(generator.initial_seed())
            for k, v in fn(*args).items():
                outputs[k].copy_(v)
            return outputs

        self.entries.append(types.SimpleNamespace(replay=replay, outputs=outputs))
        return first, self.entries[-1]


def _seed_of(step: int) -> int:
    return tct.step_generator(GRAPH_CFG.seed, step, "cpu").initial_seed()


def test_a_graphed_step_captures_once_then_replays_seeded(data, monkeypatch):
    _graphed_on_the_cpu(monkeypatch)
    stand_in = StandIn()
    step = tct.TrainStep(_model("slim"), GRAPH_CFG, capture=stand_in)
    eager = tct.TrainStep(_model("slim"), GRAPH_CFG, timer=lambda name: contextlib.nullcontext())
    outs = []
    for s in (4, 8, 1, 6):
        got = step(data, s)
        want = eager(data, s)
        assert all(torch.equal(got[k], want[k]) for k in want), s
        outs.append(got)
    assert stand_in.captures == [(torch.device("cpu"), "as a training step")]
    assert stand_in.seeds == [_seed_of(s) for s in (8, 1, 6)]
    assert outs[1] is outs[2] is outs[3] is stand_in.entries[0].outputs
    assert step.captured is stand_in.entries[0] and step.count.item() == 4
    assert _same_state(step.model, eager.model)
    # other data tensors (by identity, not value) make a new capture
    step({k: v.clone() for k, v in data.items()}, 2)
    assert len(stand_in.captures) == 2 and step.captured is stand_in.entries[1]


def test_a_timer_and_the_cpu_never_capture(data, monkeypatch):
    stand_in = StandIn()
    cpu = tct.TrainStep(_model("slim"), GRAPH_CFG, capture=stand_in)
    stages = []

    def timer(name):
        stages.append(name)
        return contextlib.nullcontext()

    for s in range(2):
        cpu(data, s)
    _graphed_on_the_cpu(monkeypatch)
    timed = tct.TrainStep(_model("slim"), GRAPH_CFG, timer=timer, capture=stand_in)
    for s in range(2):
        timed(data, s)
    assert stand_in.captures == [] and cpu.captured is None and timed.captured is None
    assert stages == ["sample+resize", "targets", "forward+backward", "optimizer"] * 2
    assert cpu.count.item() == timed.count.item() == 2


def test_a_failed_capture_propagates_with_no_eager_retry(data, monkeypatch):
    _graphed_on_the_cpu(monkeypatch)
    calls = []

    def refusing(fn, device, args, what, pool=None, generator=None):
        calls.append(what)
        raise graphs.GraphCaptureError("capturing refused at models/cnn_train.py:1")

    step = tct.TrainStep(_model("slim"), GRAPH_CFG, capture=refusing)
    start = _state(step.model)
    for s in range(2):  # no entry is kept: each call tries the capture again
        with pytest.raises(graphs.GraphCaptureError, match="refused"):
            step(data, s)
    assert calls == ["as a training step"] * 2
    assert step.count.item() == 0 and step.captured is None
    assert all(np.array_equal(v, start[k]) for k, v in _state(step.model).items())


# ---------------------------------------------------------------------------
# (e) train() returns metrics of its own
# ---------------------------------------------------------------------------


def test_train_returns_metrics_a_later_replay_does_not_rewrite(data, monkeypatch):
    _graphed_on_the_cpu(monkeypatch)
    stand_in = StandIn()
    monkeypatch.setattr(graphs, "capture_call", stand_in)
    lines = []
    raw = {k: v.numpy() for k, v in data.items()}
    _, metrics = tct.train(raw, tcd.CNNDetectorConfig(arch="slim", dtype="float32", **TINY),
                           tct.TrainConfig(batch_size=2, steps=3, warmup_steps=0, seed=3),
                           log_every=1, log_fn=lines.append, device="cpu")
    assert len(stand_in.captures) == 1 and len(stand_in.seeds) == 2
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1", "step 2"]
    outputs = stand_in.entries[0].outputs
    assert set(metrics) == set(outputs) == {"loss", "hm", "wh", "off"}
    assert all(torch.equal(metrics[k], outputs[k]) for k in metrics)
    kept = {k: v.clone() for k, v in metrics.items()}
    for v in outputs.values():  # what the graph's next replay would do
        v.fill_(float("nan"))
    assert all(torch.equal(metrics[k], kept[k]) for k in kept)
    assert all(torch.isfinite(v) for v in metrics.values())
