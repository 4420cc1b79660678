"""The SPMD CNN training step with a replica and an AdamW state on every
shard, replayed from captured CUDA graphs on a card (``parallel/cnn.py:
SPMDTrainStep``), on 2 CPU shards of the tiny f32 ``slim`` config.

The CPU cannot capture a graph, so these tests hold what it can show:

* (a) after each of 3 steps every shard's parameters, AdamW moments, AdamW
  counts and update count equal the first shard's bit for bit, and the
  first replica equals the parent design's update on the same crops (each
  shard's gradients on a copy of the first replica, ``pmean``, one AdamW
  step on the first replica), which ``tests/test_torch_parallel_cnn.py``
  holds against the reference: the replicated update changes no number;
* (b) the body as the card runs it (capturable AdamW, the count and rate on
  each shard's device) makes no tensor from host data and reads no scalar
  back in its second call, and never calls ``learning_rate``;
* (c) with a stand-in capture step injected, each shard captures its local
  part and its update once, then replays; each shard's generator is seeded
  with ``(seed, step, shard)``'s state before each replay; the CPU and a
  timer never capture; a capture that raises propagates with no eager
  retry;
* (d) the draws of shard ``i`` at step ``s`` are ``shard_generator(seed, s,
  i)``'s, eager and graphed.

(b)-(d) let the step take its card path on the CPU as
``tests/test_torch_train_graph.py`` does: ``GRAPH_DEVICES`` takes the CPU
and torch's capturable AdamW is let past its device check; their config
warms up over 0 counts (at a rate of 0 the CPU's single-tensor capturable
update divides 0 by 0 where a gradient is 0).  On a card ``chip_smoke.py``
phase 16 holds the replayed step against the eager one.
"""

import contextlib
import copy
import importlib
import types

import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_train as tct
import opencv_traffic_sign_detector_tpu_torch.parallel.cnn as tpc
import opencv_traffic_sign_detector_tpu_torch.parallel.mesh as tmesh
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
from opencv_traffic_sign_detector_tpu_torch.runtime import graphs
from test_torch_train_graph import HostReads

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

TINY = dict(stem_features=16, mid_features=24, deep_features=32, head_features=24)
# counts 0 and 1 in the warm-up, 2 in the decay
STEP_CFG = tct.TrainConfig(batch_size=2, steps=10, warmup_steps=2, lr=1e-3, seed=5)
GRAPH_CFG = tct.TrainConfig(batch_size=2, steps=10, warmup_steps=0, lr=1e-3, seed=5)
METRICS = ("loss", "hm", "wh", "off")


@pytest.fixture(scope="module")
def mesh():
    return tmesh.data_mesh(2, device="cpu")


@pytest.fixture(scope="module")
def data(mesh):
    frames, found = make_labelled_frames(4, 480, 640, seed=1)
    return tpc.put_sharded_cnn_dataset(
        mesh, tpc.shard_cnn_dataset(tct.pack_dataset(frames, found), mesh.size))


def _model():
    cfg = tcd.CNNDetectorConfig(arch="slim", dtype="float32", **TINY)
    return tcd.init_params(tcd.SignCenterNet(cfg), 1)


def _graphed_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tpc.SPMDTrainStep, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"),
                        "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cuda", "cpu"])


def _eager_timer(name):
    return contextlib.nullcontext()


def _shard_state(s) -> list[torch.Tensor]:
    """A shard's parameters, its AdamW state of each and its update count."""
    out = [p.detach() for p in s.params]
    for p in s.params:
        out += [s.opt.state[p][k] for k in ("step", "exp_avg", "exp_avg_sq")]
    return out + [s.count]


def _replicas_equal(step) -> bool:
    first, *rest = [_shard_state(s) for s in step._shards]
    return all(len(r) == len(first) and all(torch.equal(a, b) for a, b in zip(r, first))
               for r in rest)


def _crops(data, step: int, cfg) -> list[tuple]:
    """Each shard's crops of ``step`` from ``shard_generator``'s draws."""
    return [tct.crops_from_draws(tct.sample_draws(tct.shard_generator(cfg.seed, step, i, "cpu"),
                                                  cfg.batch_size, d["frames"].shape[0],
                                                  d["pos"].shape[0], cfg), d, cfg)
            for i, d in enumerate(data)]


def _first_replica_update(mesh, model, opt, crops, count: int, cfg) -> dict:
    """The parent design's update: each shard's gradients on a copy of
    ``model``'s parameters, ``pmean`` of them, then one AdamW step on
    ``model`` alone at ``learning_rate(count)``."""
    flats = []
    for imgs, boxes, cls in crops:
        rep = copy.deepcopy(model)
        targets = tct.crop_targets(boxes, cls, model.cfg.stride)
        loss, parts = tct.centernet_loss(rep(imgs), targets, cfg)
        grads = torch.autograd.grad(loss, list(rep.parameters()))
        metrics = torch.stack([loss] + [parts[k] for k in METRICS[1:]]).detach()
        flats.append(torch.cat([g.reshape(-1) for g in grads] + [metrics]))
    mean = tmesh.pmean(mesh, flats)
    start = 0
    for p in model.parameters():
        p.grad = mean[start:start + p.numel()].view_as(p).clone()
        start += p.numel()
    for group in opt.param_groups:
        group["lr"] = tct.learning_rate(count, cfg)
    opt.step()
    return dict(zip(METRICS, mean[start:]))


# ---------------------------------------------------------------------------
# (a) replicas equal, and equal to the first-replica update
# ---------------------------------------------------------------------------


def test_replicas_equal_the_first_shard_and_the_first_replica_update(mesh, data):
    """Steps 7, 3, 5 (counts 0 and 1 in the warm-up, 2 in the decay)."""
    cfg = STEP_CFG
    model, ref = _model(), _model()
    for p in ref.parameters():
        p.requires_grad_(True)
    ref_opt = tct.make_optimizer(ref.parameters(), cfg)
    step = tpc.make_spmd_cnn_train_step(mesh, model.cfg, cfg)
    start = tcd.flat_params(model)
    for count, s in enumerate((7, 3, 5)):
        got = step(model, data, s)
        want = _first_replica_update(mesh, ref, ref_opt, _crops(data, s, cfg), count, cfg)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in METRICS), s
        assert _replicas_equal(step), s
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), ref.parameters())), s
        assert all(sh.count.item() == count + 1 for sh in step._shards)
        assert step._replicas_of(model)[0] is model
    moved = max(np.abs(v - start[k]).max() for k, v in tcd.flat_params(model).items())
    assert moved > 1e-5


def test_update_on_given_crops_is_the_replicated_update(mesh, data):
    """``update`` on each shard's crops: every shard updated alike, the first
    replica as the first-replica update, its gradients the mean."""
    cfg = STEP_CFG
    model, ref = _model(), _model()
    for p in ref.parameters():
        p.requires_grad_(True)
    ref_opt = tct.make_optimizer(ref.parameters(), cfg)
    step = tpc.make_spmd_cnn_train_step(mesh, model.cfg, cfg)
    for count, s in enumerate((2, 9)):
        crops = _crops(data, s, cfg)
        got = step.update(model, crops)
        want = _first_replica_update(mesh, ref, ref_opt, crops, count, cfg)
        assert all(torch.equal(got[k], want[k]) for k in METRICS), s
        assert _replicas_equal(step), s
        for a, b in zip(model.parameters(), ref.parameters()):
            assert torch.equal(a, b) and torch.equal(a.grad, b.grad)


# ---------------------------------------------------------------------------
# (b) no host data and no scalar read in the card's body
# ---------------------------------------------------------------------------


def test_graphed_body_reads_nothing_from_the_host(mesh, data, monkeypatch):
    _graphed_on_the_cpu(monkeypatch)
    model = _model()
    step = tpc.SPMDTrainStep(mesh, model.cfg, GRAPH_CFG)
    assert step.graphed
    shards = step._shards_of(model)
    assert all(s.opt.defaults["capturable"] for s in shards)
    for s in shards:
        s.gen.manual_seed(1)
    step._body(data)          # makes the constants and the optimizers' state

    def refused(*a, **kw):
        raise AssertionError("learning_rate called inside the step")

    monkeypatch.setattr(tct, "learning_rate", refused)
    for s in shards:
        s.gen.manual_seed(2)
    rec = HostReads()
    with rec:
        out = step._body(data)
    assert dict(rec.sites) == {}
    assert all(s.count.item() == 2 for s in shards)
    assert all(torch.isfinite(v) for v in out.values()) and _replicas_equal(step)


# ---------------------------------------------------------------------------
# (c) capture each shard once, then replay; never on the CPU or with a timer
# ---------------------------------------------------------------------------


class StandIn:
    """A capture step that runs the function once eagerly (the warm-up) and,
    as a graph does, returns from each replay the same output tensor,
    rewritten in place; records its captures and, for a graph with a
    generator, the generator's seed at each replay."""

    def __init__(self):
        self.captures, self.seeds, self.entries = [], [], []

    def __call__(self, fn, device, args, what, pool=None, generator=None):
        self.captures.append((device, what))
        first = fn(*args)
        outputs = None if first is None else torch.empty_like(first)

        def replay(x=None):
            if generator is not None:
                self.seeds.append((what, generator.initial_seed()))
            out = fn(*args)
            if outputs is not None:
                outputs.copy_(out)
            return outputs

        self.entries.append(types.SimpleNamespace(replay=replay, outputs=outputs))
        return first, self.entries[-1]


def _seed_of(step: int, shard: int) -> int:
    return tct.shard_generator(GRAPH_CFG.seed, step, shard, "cpu").initial_seed()


def test_each_shard_captures_once_then_replays_seeded(mesh, data, monkeypatch):
    _graphed_on_the_cpu(monkeypatch)
    stand_in = StandIn()
    model, other = _model(), _model()
    step = tpc.SPMDTrainStep(mesh, model.cfg, GRAPH_CFG, capture=stand_in)
    eager = tpc.SPMDTrainStep(mesh, model.cfg, GRAPH_CFG, timer=_eager_timer)
    steps = (4, 8, 1, 6)
    for s in steps:
        got, want = step(model, data, s), eager(other, data, s)
        assert all(torch.equal(got[k], want[k]) for k in METRICS), s
        assert _replicas_equal(step), s
        for a, b in zip(step._shards, eager._shards):
            assert all(torch.equal(x, y) for x, y in zip(_shard_state(a), _shard_state(b))), s
    cpu = torch.device("cpu")
    assert stand_in.captures == [(cpu, "as shard 0's gradients"), (cpu, "as shard 1's gradients"),
                                 (cpu, "as shard 0's AdamW update"),
                                 (cpu, "as shard 1's AdamW update")]
    assert stand_in.seeds == [(f"as shard {i}'s gradients", _seed_of(s, i))
                              for s in steps[1:] for i in range(2)]
    local, updates = step.captured
    assert local == stand_in.entries[:2] and updates == stand_in.entries[2:]
    assert all(s.count.item() == len(steps) for s in step._shards)
    # other data tensors (by identity, not value) make new captures
    step(model, [{k: v.clone() for k, v in d.items()} for d in data], 2)
    assert len(stand_in.captures) == 8
    # another model makes new replicas, optimizers and captures
    step(_model(), data, 2)
    assert len(stand_in.captures) == 12 and all(s.count.item() == 1 for s in step._shards)


def test_a_timer_and_the_cpu_never_capture(mesh, data, monkeypatch):
    stand_in = StandIn()
    cpu = tpc.SPMDTrainStep(mesh, _model().cfg, GRAPH_CFG, capture=stand_in)
    model = _model()
    stages = []

    def timer(name):
        stages.append(name)
        return contextlib.nullcontext()

    for s in range(2):
        cpu(model, data, s)
    assert not cpu.graphed and not cpu._shards[0].opt.defaults["capturable"]
    _graphed_on_the_cpu(monkeypatch)
    timed = tpc.SPMDTrainStep(mesh, model.cfg, GRAPH_CFG, timer=timer, capture=stand_in)
    for s in range(2):
        timed(model, data, s)
    assert stand_in.captures == [] and cpu.captured is None and timed.captured is None
    shard = ["sample+resize", "targets", "forward+backward"]
    assert stages == (shard * 2 + ["pmean"] + ["optimizer"] * 2) * 2
    assert all(s.count.item() == 2 for s in cpu._shards + timed._shards)


def test_a_failed_capture_propagates_with_no_eager_retry(mesh, data, monkeypatch):
    _graphed_on_the_cpu(monkeypatch)
    calls = []

    def refusing(fn, device, args, what, pool=None, generator=None):
        calls.append(what)
        raise graphs.GraphCaptureError("capturing refused at parallel/cnn.py:1")

    model = _model()
    start = tcd.flat_params(model)
    step = tpc.SPMDTrainStep(mesh, model.cfg, GRAPH_CFG, capture=refusing)
    for s in range(2):  # no entry is kept: each call tries the capture again
        with pytest.raises(graphs.GraphCaptureError, match="refused"):
            step(model, data, s)
    assert calls == ["as shard 0's gradients"] * 2
    assert step.captured is None and all(s.count.item() == 0 for s in step._shards)
    assert all(np.array_equal(v, start[k]) for k, v in tcd.flat_params(model).items())


# ---------------------------------------------------------------------------
# (d) a shard's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graphed", [False, True])
def test_shard_draws_are_shard_generators(mesh, data, monkeypatch, graphed):
    """Steps 5, 2, 5 (the last a replay where graphed): shard ``i``'s draws
    equal ``sample_draws(shard_generator(seed, s, i))``'s bit for bit."""
    if graphed:
        _graphed_on_the_cpu(monkeypatch)
    seen = []
    orig = tpc.sample_draws

    def spy(gen, *a, **kw):
        out = orig(gen, *a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(tpc, "sample_draws", spy)
    model = _model()
    step = tpc.SPMDTrainStep(mesh, model.cfg, GRAPH_CFG, capture=StandIn())
    steps = (5, 2, 5)
    for s in steps:
        step(model, data, s)
    assert len(seen) == 2 * len(steps)
    for j, (s, i) in enumerate((s, i) for s in steps for i in range(2)):
        d = data[i]
        want = tct.sample_draws(tct.shard_generator(GRAPH_CFG.seed, s, i, "cpu"),
                                GRAPH_CFG.batch_size, d["frames"].shape[0], d["pos"].shape[0],
                                GRAPH_CFG)
        assert seen[j].keys() == want.keys()
        assert all(torch.equal(seen[j][k], want[k]) for k in want), (s, i)
    assert not torch.equal(seen[0]["src"], seen[1]["src"])
    assert not torch.equal(seen[0]["src"], seen[2]["src"])
