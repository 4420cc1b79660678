"""PyTorch port vs the JAX reference: SPMD data-parallel CNN training
(``parallel/cnn.py``).

The reference runs on a 2-device sub-mesh of conftest's virtual CPU mesh,
the port on a CPU mesh of 2 shards.  Both start from the reference's own
initial weights (the tiny ``slim`` config of ``tests/test_parallel_cnn.py``
at float32), carried across in the flat keystr layout.  Each shard is fed
the reference's draws of its key ``fold_in(fold_in(PRNGKey(seed), step),
shard)``.  Tolerances are those of ``tests/test_torch_cnn_train.py`` for
a whole f32 step: loss and its parts within 1e-5 relative, each averaged
gradient within 1e-4 of its largest magnitude (1e-3 on uniform-noise
frames, see the test), parameters after the update within 1e-5; against
the reference's jitted step, which cuts its own crops, the loss within
1e-4 relative.  ``shard_cnn_dataset`` is host numpy on both sides: equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.cnn_train as jct
import opencv_traffic_sign_detector_tpu.parallel.cnn as jpc
import opencv_traffic_sign_detector_tpu.parallel.mesh as jmesh
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_train as tct
import opencv_traffic_sign_detector_tpu_torch.parallel.cnn as tpc
import opencv_traffic_sign_detector_tpu_torch.parallel.mesh as tmesh
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
from test_torch_cnn_train import _close, _flat, _grads, _jax_draws

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

TINY = dict(stem_features=16, mid_features=24, deep_features=32, head_features=24)
CFG = tct.TrainConfig(batch_size=2, steps=10, warmup_steps=2, lr=1e-3)
JCFG = jct.TrainConfig(batch_size=2, steps=10, warmup_steps=2, lr=1e-3)


def _toy_data(n_frames=6, hw=tct.SLICE + 32, seed=0):
    """``tests/test_parallel_cnn.py``'s dataset: a sign a frame, frame 3
    without one, and an unmapped (ignore) box on frame 1."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n_frames, hw, hw, 3), dtype=np.uint8)
    boxes = np.zeros((n_frames, tct.MAX_GT, 4), np.float32)
    cls = np.zeros((n_frames, tct.MAX_GT), np.int32)
    for i in range(n_frames):
        if i != 3:
            boxes[i, 0] = (200, 200, 260, 260)
            cls[i, 0] = (i % 6) + 1
    boxes[1, 1] = (40, 300, 90, 350)
    cls[1, 1] = -1
    return {"frames": frames, "boxes": boxes, "cls": cls}


@pytest.mark.parametrize("n_frames,n_shards", [(6, 4), (8, 8), (6, 2), (4, 3)])
def test_shard_cnn_dataset_equals_reference(n_frames, n_shards):
    data = _toy_data(n_frames)
    want = jpc.shard_cnn_dataset(data, n_shards)
    got = tpc.shard_cnn_dataset(data, n_shards)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_put_sharded_cnn_dataset_splits_each_array():
    data = tpc.shard_cnn_dataset(_toy_data(6), 4)
    mesh = tmesh.data_mesh(4, device="cpu")
    shards = tpc.put_sharded_cnn_dataset(mesh, data)
    assert len(shards) == 4
    for k, v in data.items():
        parts = np.split(v, 4)
        for s, part in zip(shards, parts):
            np.testing.assert_array_equal(s[k].numpy(), part, err_msg=k)
    # each shard's positives address its own frames
    for s in shards:
        assert int(s["pos"][:, 0].max()) < s["frames"].shape[0]


def _initial():
    jcfg = jcd.CNNDetectorConfig(arch="slim", dtype="float32", **TINY)
    params = jcd.init_params(jcfg, 1, (64, 64))
    model = tcd.load_flat_params(
        tcd.SignCenterNet(tcd.CNNDetectorConfig(arch="slim", dtype="float32", **TINY)),
        _flat(params))
    return jcfg, params, model


def _shard_keys(step: int, shard: int):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(CFG.seed), step), shard)
    return jax.random.split(key, CFG.batch_size)


def _ref_shard_crops(sdata, step, shard):
    """The reference's crops of one shard at one step (vmapped, not jitted)."""
    return jax.vmap(partial(
        jct._sample_crop, frames=jnp.asarray(sdata["frames"]), boxes=jnp.asarray(sdata["boxes"]),
        cls=jnp.asarray(sdata["cls"]), pos=jnp.asarray(sdata["pos"]), min_zoom=CFG.min_zoom,
        max_zoom=CFG.max_zoom, pos_fraction=CFG.pos_fraction))(_shard_keys(step, shard))


def _ref_mean_grads(jcfg, params, crops_by_shard):
    """The reference step's per-shard loss and gradients, averaged as its
    ``pmean`` averages them."""
    grid = tct.CROP // jcfg.stride

    def loss_fn(p, imgs, boxes, cls):
        out = jcd.SignCenterNet(jcfg).apply({"params": p}, imgs)
        tgt = jax.vmap(partial(jct.make_targets, grid_h=grid, grid_w=grid,
                               stride=jcfg.stride))(boxes, cls)
        return jct.centernet_loss(out, tgt, JCFG)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    outs = [vg(params, *c) for c in crops_by_shard]
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / len(g), *(o[1] for o in outs))
    loss = sum(float(o[0][0]) for o in outs) / len(outs)
    parts = {k: sum(float(o[0][1][k]) for o in outs) / len(outs) for k in outs[0][0][1]}
    return loss, parts, grads


def _labelled(n_frames=4, seed=1):
    """Synthetic road frames with signs (``data/synthetic.py``), the data
    of ``tests/test_torch_cnn_train.py``'s step tests."""
    frames, found = make_labelled_frames(n_frames, 480, 640, seed=seed)
    return tct.pack_dataset(frames, found)


@pytest.mark.parametrize("kind,grad_bound", [("labelled", 1e-4), ("noise", 1e-3)])
def test_spmd_step_matches_reference_on_its_draws(kind, grad_bound):
    """Two steps (the optimizer's counts 0 and 1) over 2 shards, each shard
    fed the reference's crops of its own fold-in key: loss and parts,
    averaged gradients and parameters after each update as the reference's
    step body computes them (``parallel/cnn.py``: per-shard gradients,
    ``pmean``, the optax AdamW update).  On the labelled frames gradients
    are held within the training tests' 1e-4; on the reference test's
    uniform-noise frames within 1e-3, the card-against-CPU bound of
    ``chip_smoke.py``'s training phase: the GroupNorm's f32
    fast variance ``E[x^2] - E[x]^2`` (the reference's formula) cancels on
    noise, and the two packages sum it in other orders (4e-4 apart on the
    first block's kernel)."""
    data = _labelled() if kind == "labelled" else _toy_data(4)
    shard_data = [{k: np.split(v, 2)[s] for k, v in tpc.shard_cnn_dataset(data, 2).items()}
                  for s in range(2)]
    jcfg, params, model = _initial()
    tx = jct.make_optimizer(JCFG)
    opt_state = tx.init(params)
    mesh = tmesh.data_mesh(2, device="cpu")
    step = tpc.make_spmd_cnn_train_step(mesh, model.cfg, CFG)
    before = tcd.flat_params(model)
    for s in (0, 1):
        crops = [_ref_shard_crops(shard_data[i], s, i) for i in range(2)]
        loss, parts, grads = _ref_mean_grads(jcfg, params, crops)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        got = step.update(model, [tuple(torch.from_numpy(np.array(x)) for x in c)
                                  for c in crops])
        np.testing.assert_allclose(got["loss"].item(), loss, rtol=1e-5)
        for k in parts:
            np.testing.assert_allclose(got[k].item(), parts[k], rtol=1e-5, err_msg=k)
        tgrads, want = _grads(model), _flat(grads)
        assert set(tgrads) == set(want)
        for k in want:
            _close(tgrads[k], want[k], grad_bound, k)
        for k, v in _flat(params).items():
            np.testing.assert_allclose(tcd.flat_params(model)[k], v, rtol=0, atol=1e-5,
                                       err_msg=k)
    after = tcd.flat_params(model)
    assert max(np.abs(after[k] - before[k]).max() for k in before) > 1e-4


def test_spmd_step_matches_reference_jitted_step():
    """The reference's jitted SPMD step at step 5 (count 0) on its 2-device
    sub-mesh, and the port's step on its own crops of the same draws: the
    parameters stay as they were on both sides (learning rate 0), the loss
    within 1e-4 relative (each side cuts its own crops; the training tests'
    bound) on
    the labelled frames.  The reference's jitted crops are not its eager
    ones (ROADMAP queue 3); on its uniform-noise frames, where a pixel
    moves the loss more, the two losses land 2e-4 apart."""
    jcfg, params, model = _initial()
    jm = jmesh.data_mesh(devices=jax.devices()[:2])
    data = tpc.shard_cnn_dataset(_labelled(), 2)
    jstep = jax.jit(jpc.make_spmd_cnn_train_step(jm, jcfg, JCFG))
    new_params, _, metrics = jstep(params, jct.make_optimizer(JCFG).init(params),
                                   jpc.put_sharded_cnn_dataset(jm, data), jnp.int32(5))
    mesh = tmesh.data_mesh(2, device="cpu")
    step = tpc.make_spmd_cnn_train_step(mesh, model.cfg, CFG)
    tdata = tpc.put_sharded_cnn_dataset(mesh, data)
    crops = []
    for i, shard in enumerate(tdata):
        draws = _jax_draws(_shard_keys(5, i), shard["frames"].shape[0], shard["pos"].shape[0],
                           CFG)
        crops.append(tct.crops_from_draws(draws, shard, CFG))
    before = tcd.flat_params(model)
    got = step.update(model, crops)
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    after = tcd.flat_params(model)
    for k, v in _flat(new_params).items():
        np.testing.assert_array_equal(v, _flat(params)[k])
        np.testing.assert_array_equal(after[k], before[k])


def test_spmd_step_draws_from_seed_step_and_shard():
    """The port's own step: a shard's draws depend on (seed, step, shard)
    alone; two steps after a one-step warm-up give finite losses and move
    the parameters, and the second shard's replica takes them up."""
    gens = [tct.shard_generator(0, s, i, "cpu") for s, i in ((3, 0), (3, 1), (4, 0), (3, 0))]
    draws = [tct.sample_draws(g, 4, 5, 7, CFG)["src"] for g in gens]
    assert torch.equal(draws[0], draws[3])
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])

    cfg = tct.TrainConfig(batch_size=1, steps=4, warmup_steps=1, lr=1e-3, pos_fraction=1.0)
    _, _, model = _initial()
    mesh = tmesh.data_mesh(2, device="cpu")
    data = tpc.put_sharded_cnn_dataset(mesh, tpc.shard_cnn_dataset(_toy_data(4), 2))
    step = tpc.make_spmd_cnn_train_step(mesh, model.cfg, cfg)
    before = tcd.flat_params(model)
    losses = [step(model, data, s)["loss"].item() for s in range(2)]
    assert np.isfinite(losses).all()
    after = tcd.flat_params(model)
    assert max(np.abs(after[k] - before[k]).max() for k in before) > 0
    replica = step._replicas_of(model)[1]
    assert all(torch.equal(a, b) for a, b in zip(replica.parameters(), model.parameters()))
