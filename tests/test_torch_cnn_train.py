"""PyTorch port vs the JAX reference: CNN training (``models/cnn_train.py``).

Inputs are made with numpy from fixed seeds and handed to both packages;
the network weights are the reference's own initial ones, carried across
through the flat keystr layout (``params`` and ``batch_stats``).  The
reference's crops are fed by the reference's own draws: a key's nine
values rebuilt as ``_sample_crop`` draws them.  Tolerances, each test
restating its own:

* targets: hm, wh, off within 1e-6; pos_mask and loss_mask exact;
* loss: total and each part within 1e-6 relative;
* crops: pixels within +-1 on at most 0.1% of them (the resize products
  sum in another order, and the colour jitter truncates), boxes within
  1e-3 px, classes exact;
* the v3 BatchNorm twin at float32: outputs and running statistics within
  1e-5 of each map's largest magnitude, the fold within 1e-6;
* the schedule within 1e-7 relative at every count; AdamW updates within
  1e-6 relative, the first exactly 0;
* a whole f32 train step: loss within 1e-5 relative, each gradient within
  1e-4 of its largest magnitude, parameters and statistics after the
  update within 1e-5; at bfloat16 the loss within 2e-2 relative.
"""

import contextlib
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.cnn_train as jct
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_train as tct
from opencv_traffic_sign_detector_tpu.data.gt import load_results_file
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import (
    make_labelled_frames,
    write_gt_dir,
)

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
TINY = dict(stem_features=16, mid_features=24, deep_features=32, head_features=24)
H, W = 480, 640      # the smallest frames a SLICE x SLICE cut fits, with room


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unflat(flat: dict, like):
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[jax.tree_util.keystr(kp)]) for kp, _ in paths])


def _close(got, want, rel, what=""):
    """Within ``rel`` of the reference's largest magnitude."""
    want = np.asarray(want, np.float64)
    bound = rel * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=bound,
                               err_msg=what)


def _dataset(seed: int = 1):
    """Three labelled frames, their third box an ignore region, and
    positives in the four corners (so positive slices clip at every
    edge)."""
    frames, found = make_labelled_frames(3, H, W, seed=seed)
    data = tct.pack_dataset(frames, [[(*b[:4], -1 if j == 2 else b[4]) for j, b in enumerate(f)]
                                     for f in found])
    corners = [(0, 5.0, 5.0), (1, W - 5.0, 5.0), (2, 5.0, H - 5.0), (0, W - 5.0, H - 5.0)]
    data["pos"] = np.concatenate([data["pos"], np.asarray(corners, np.float32)])
    return data


@pytest.fixture(scope="module")
def data():
    return _dataset()


def _torch_data(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _jax_draws(keys, n_frames: int, n_pos: int, cfg) -> dict:
    """The nine values ``_sample_crop`` draws from each key, scaled as it
    scales them (``cnn_train.py:114-150``)."""
    def one(key):
        (k_src, k_frame, k_pos, k_jit, k_zoom, k_uv, k_bright, k_contrast,
         k_win) = jax.random.split(key, 9)
        u = jax.random.uniform
        return {"src": u(k_src), "frame": jax.random.randint(k_frame, (), 0, n_frames),
                "pos_idx": jax.random.randint(k_pos, (), 0, n_pos),
                "jitter": u(k_jit, (2,), minval=-tct.CROP / 3, maxval=tct.CROP / 3),
                "zoom": u(k_zoom, (), minval=cfg.min_zoom, maxval=cfg.max_zoom),
                "uv": u(k_uv, (2,)), "bright": u(k_bright, (), minval=-30.0, maxval=30.0),
                "contrast": u(k_contrast, (), minval=0.7, maxval=1.3), "win": u(k_win, (2,))}
    return {k: torch.from_numpy(np.array(v)) for k, v in jax.vmap(one)(keys).items()}


def _step_draws(cfg, step: int, data) -> dict:
    """The draws of the reference's train step ``step``."""
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step)
    return _jax_draws(jax.random.split(key, cfg.batch_size), len(data["frames"]),
                      len(data["pos"]), cfg)


# ---------------------------------------------------------------------------
# Targets and loss
# ---------------------------------------------------------------------------


def _random_boxes(seed: int, b: int = 4, m: int = tct.MAX_GT):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-60, tct.CROP, (b, m))
    y1 = rng.uniform(-60, tct.CROP, (b, m))
    boxes = np.stack([x1, y1, x1 + rng.uniform(3, 90, (b, m)),
                      y1 + rng.uniform(3, 90, (b, m))], -1).astype(np.float32)
    cls = rng.integers(-1, 7, (b, m)).astype(np.int32)
    boxes[0, 1] = boxes[0, 0] + 1.5         # two boxes on one cell
    cls[0, :2] = (2, 5)
    boxes[1, 0] = (-20, -30, 10, 8)         # negative center
    boxes[1, 1] = (300, 310, 360, 370)      # past the crop's far edge
    cls[1, :2] = (1, 3)
    cls[2, 0] = -1                          # an ignore box
    return boxes, cls


@pytest.mark.parametrize("seed,stride", [(0, 16), (1, 8)])
def test_make_targets_matches_reference(seed, stride):
    """hm, wh, off within 1e-6; pos_mask and loss_mask exact."""
    boxes, cls = _random_boxes(seed)
    grid = tct.CROP // stride
    want = jax.jit(jax.vmap(partial(jct.make_targets, grid_h=grid, grid_w=grid,
                                    stride=stride)))(jnp.asarray(boxes), jnp.asarray(cls))
    got = tct.make_targets(torch.from_numpy(boxes), torch.from_numpy(cls), grid, grid, stride)
    for name, g, w in zip(("hm", "wh", "off"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert np.asarray(want[3]).sum() > 4 and (np.asarray(want[4]) == 0).any()
    radius = tct._gaussian_radius(torch.from_numpy(boxes[..., 2] - boxes[..., 0]),
                                  torch.from_numpy(boxes[..., 3] - boxes[..., 1]))
    want_r = jct._gaussian_radius(jnp.asarray(boxes[..., 2] - boxes[..., 0]),
                                  jnp.asarray(boxes[..., 3] - boxes[..., 1]))
    np.testing.assert_allclose(radius.numpy(), np.asarray(want_r), rtol=1e-6)


def test_collisions_average_and_centers_truncate():
    """Two boxes on one cell average their wh and off (the reference's
    code, not its comment's "max"), and a negative center truncates toward
    zero onto cell 0."""
    boxes = torch.tensor([[[32.0, 32.0, 64.0, 64.0], [36.0, 36.0, 84.0, 60.0],
                           [-40.0, 0.0, 8.0, 16.0]]])
    cls = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    hm, wh, off, pos_mask, _ = tct.make_targets(boxes, cls, 20, 20, 16)
    assert pos_mask[0, 3, 3] == 1 and pos_mask.sum() == 2
    np.testing.assert_allclose(wh[0, 3, 3].numpy(), [(2.0 + 3.0) / 2, (2.0 + 1.5) / 2])
    np.testing.assert_allclose(off[0, 3, 3].numpy(), [(0.0 + 0.75) / 2, 0.0])
    # center (-1, 0.5) -> cell (0, 0), its offset keeps the -1
    assert pos_mask[0, 0, 0] == 1 and hm[0, 0, 0, 2] == 1.0
    np.testing.assert_allclose(off[0, 0, 0].numpy(), [-1.0, 0.5])


def test_centernet_loss_matches_reference():
    """Each part within 1e-6 relative, but hm and the total within 2e-6:
    the reference sums hm's 9,600 f32 terms one after another and lands
    1.3e-6 from the float64 sum, which the port's sum meets within 1e-7
    (also held here)."""
    boxes, cls = _random_boxes(3)
    tgt = tct.make_targets(torch.from_numpy(boxes), torch.from_numpy(cls), 20, 20, 16)
    rng = np.random.default_rng(4)
    outs = {"hm": rng.normal(-3, 2, (4, 20, 20, 6)), "size": rng.normal(2, 1, (4, 20, 20, 2)),
            "off": rng.uniform(0, 1, (4, 20, 20, 2))}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    cfg = tct.TrainConfig()
    want_total, want = jax.jit(partial(jct.centernet_loss, cfg=cfg))(
        {k: jnp.asarray(v) for k, v in outs.items()}, tuple(jnp.asarray(t.numpy()) for t in tgt))
    total, got = tct.centernet_loss({k: torch.from_numpy(v) for k, v in outs.items()}, tgt, cfg)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=2e-6)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-6 if k == "hm" else 1e-6,
                                   err_msg=k)
    exact, _ = tct.centernet_loss({k: torch.from_numpy(v).double() for k, v in outs.items()},
                                  tuple(t.double() for t in tgt), cfg)
    np.testing.assert_allclose(total.item(), exact.item(), rtol=1e-7)


# ---------------------------------------------------------------------------
# Crops
# ---------------------------------------------------------------------------


def test_crops_from_reference_draws_match_sample_crop(data):
    """64 keys: positive and random sources, zooms below and above 1,
    positive slices clipped at all four frame edges.  Pixels within +-1 on
    at most 0.1% of them, exact elsewhere; boxes within 1e-3 px; classes
    exact."""
    cfg = tct.TrainConfig()
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    crop = jax.jit(jax.vmap(partial(
        jct._sample_crop, frames=jnp.asarray(data["frames"]), boxes=jnp.asarray(data["boxes"]),
        cls=jnp.asarray(data["cls"]), pos=jnp.asarray(data["pos"]), min_zoom=cfg.min_zoom,
        max_zoom=cfg.max_zoom, pos_fraction=cfg.pos_fraction)))
    want_img, want_boxes, want_cls = (np.asarray(x) for x in crop(keys))
    draws = _jax_draws(keys, len(data["frames"]), len(data["pos"]), cfg)
    img, boxes, cls = tct.crops_from_draws(draws, _torch_data(data), cfg)
    diff = np.abs(img.numpy().astype(np.int16) - want_img.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(boxes.numpy(), want_boxes, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(cls.numpy(), want_cls)

    # what the keys covered
    d = {k: v.numpy() for k, v in draws.items()}
    use_pos = d["src"] < cfg.pos_fraction
    prow = data["pos"][d["pos_idx"]]
    ox = prow[:, 1] + d["jitter"][:, 0] - tct.SLICE / 2
    oy = prow[:, 2] + d["jitter"][:, 1] - tct.SLICE / 2
    assert use_pos.any() and not use_pos.all()
    assert (d["zoom"] < 1).any() and (d["zoom"] > 1).any()
    for clipped in (ox < 0, ox > W - tct.SLICE, oy < 0, oy > H - tct.SLICE):
        assert (use_pos & clipped).any()
    assert (want_cls > 0).any() and (want_cls < 0).any()


def test_sample_draws_depend_on_seed_and_step_only():
    cfg = tct.TrainConfig(batch_size=5)
    a = tct.sample_draws(tct.step_generator(3, 9, "cpu"), 5, 4, 7, cfg)
    b = tct.sample_draws(tct.step_generator(3, 9, "cpu"), 5, 4, 7, cfg)
    c = tct.sample_draws(tct.step_generator(3, 10, "cpu"), 5, 4, 7, cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["zoom"], c["zoom"])
    assert ((a["zoom"] >= cfg.min_zoom) & (a["zoom"] < cfg.max_zoom)).all()
    assert (a["pos_idx"] < 7).all() and (a["frame"] < 4).all()
    assert a["jitter"].abs().max() <= tct.CROP / 3 and a["bright"].abs().max() <= 30


# ---------------------------------------------------------------------------
# The v3 BatchNorm twin and its fold
# ---------------------------------------------------------------------------


def _v3_variables(seed: int = 2):
    """The reference twin's initial variables at float32, with BatchNorm
    scales, biases and statistics moved off their initial values."""
    cfg = jcd.CNNDetectorConfig(arch="v3", dtype="float32")
    var = jct.SignCenterNetV3Train(cfg).init(jax.random.PRNGKey(seed),
                                             jnp.zeros((1, 64, 64, 3), jnp.uint8))
    params, stats = _flat(var["params"]), _flat(var["batch_stats"])
    rng = np.random.default_rng(seed)
    for flat in (params, stats):
        for k, v in flat.items():
            if "BatchNorm" in k:
                flat[k] = (v + rng.uniform(0.2, 0.6, v.shape) * (1 if "var" in k else
                                                                  rng.choice([-1, 1], v.shape))
                           ).astype(np.float32)
    return cfg, var, params, stats


def _twin(params, stats, dtype="float32"):
    twin = tct.SignCenterNetV3Train(tcd.CNNDetectorConfig(arch="v3", dtype=dtype))
    tcd.load_flat_params(twin, params)
    return tcd.load_flat_params(twin, stats, collection="batch_stats")


def test_v3_twin_and_batchnorm_match_reference():
    """Float32: train-mode outputs and the new batch_stats, and eval-mode
    outputs, within 1e-5 of each map's largest magnitude."""
    cfg, var, params, stats = _v3_variables()
    frames = np.random.default_rng(6).integers(0, 256, (2, 64, 96, 3), np.uint8)
    model = jct.SignCenterNetV3Train(cfg)
    jvars = {"params": _unflat(params, var["params"]),
             "batch_stats": _unflat(stats, var["batch_stats"])}
    want, upd = model.apply(jvars, jnp.asarray(frames), train=True, mutable=["batch_stats"])
    want_eval = model.apply(jvars, jnp.asarray(frames), train=False)
    twin = _twin(params, stats)
    assert set(tcd.flat_params(twin)) == set(params)
    assert set(tcd.flat_params(twin, "batch_stats")) == set(stats)
    got = twin.train()(torch.from_numpy(frames))
    for k in want:
        _close(got[k].detach(), want[k], 1e-5, k)
    new_stats = _flat(upd["batch_stats"])
    for k, v in tcd.flat_params(twin, "batch_stats").items():
        _close(v, new_stats[k], 1e-5, k)
    twin = _twin(params, stats)
    with torch.no_grad():
        got = twin.eval()(torch.from_numpy(frames))
    for k in want_eval:
        _close(got[k], want_eval[k], 1e-5, k)
    assert all(np.array_equal(v, stats[k])
               for k, v in tcd.flat_params(twin, "batch_stats").items())


def test_fold_matches_reference_and_bn_eval():
    """The fold within 1e-6 of the reference's; the folded inference net
    within 1e-5 (of the largest magnitude) of the twin's eval forward."""
    _, var, params, stats = _v3_variables(3)
    want = _flat(jct.fold_v3_batchnorm(_unflat(params, var["params"]),
                                       _unflat(stats, var["batch_stats"])))
    twin = _twin(params, stats)
    net = tct.fold_v3_batchnorm(twin)
    assert isinstance(net, tcd.SignCenterNet) and net.cfg.arch == "v3"
    got = tcd.flat_params(net)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    frames = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 64, 96, 3), np.uint8))
    with torch.no_grad():
        ref = twin.eval()(frames)
        out = net(frames)
    for k in ref:
        _close(out[k], ref[k], 1e-5, k)


def test_init_params_flax_defaults():
    twin = tcd.init_params(tct.SignCenterNetV3Train(), seed=4)
    flat, stats = tcd.flat_params(twin), tcd.flat_params(twin, "batch_stats")
    k = flat["['Conv_2']['kernel']"]
    std = (1 / (3 * 3 * 128)) ** 0.5
    assert abs(k.std() / std - 1) < 0.05 and np.abs(k).max() <= 2 * std / 0.87962566103423978
    assert np.all(flat["['Conv_4']['bias']"] == np.float32(-4.59))
    assert np.all(flat["['Conv_5']['bias']"] == 0) and np.all(flat["['BatchNorm_1']['scale']"] == 1)
    assert all(np.all(v == (1 if "var" in n else 0)) for n, v in stats.items())
    slim = tcd.init_params(tcd.SignCenterNet(tcd.CNNDetectorConfig(arch="slim")), seed=4)
    assert np.all(tcd.flat_params(slim)["['Conv_1']['bias']"] == np.float32(-4.59))
    again = tcd.flat_params(tcd.init_params(tct.SignCenterNetV3Train(), seed=4))
    assert all(np.array_equal(v, again[n]) for n, v in flat.items())


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,steps", [(200, 4000), (3, 34), (0, 10)])
def test_learning_rate_equals_optax_schedule(warmup, steps):
    """Every count in 0..steps+5 within 1e-7 relative (optax's own f32)."""
    cfg = tct.TrainConfig(warmup_steps=warmup, steps=steps)
    sched = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, warmup, steps, cfg.lr * 0.02)
    counts = range(steps + 6) if steps < 100 else [*range(0, 210), *range(3990, 4006), 1234]
    for c in counts:
        np.testing.assert_allclose(tct.learning_rate(c, cfg), float(sched(jnp.int32(c))),
                                   rtol=1e-7, atol=0, err_msg=str(c))
    assert tct.learning_rate(0, cfg) == (0.0 if warmup else float(np.float32(cfg.lr)))


def test_adamw_updates_equal_optax():
    """Three updates on fixed grads (parameters near 0 and a large learning
    rate, so that an update is not lost in its parameter's rounding).  The
    first is exactly 0 on both sides.  optax forms its bias corrections
    ``1 - b**t`` in f32, where ``1 - 0.999**t`` cancels: its updates lie up
    to 1.3e-5 relative from the float64 AdamW formula, so the port's are
    held within 2e-5 relative of optax's and within 1e-6 relative of the
    float64 formula."""
    cfg = tct.TrainConfig(lr=0.5, warmup_steps=2, steps=10, weight_decay=0.1)
    rng = np.random.default_rng(9)
    p0 = rng.normal(0, 0.01, (64,)).astype(np.float32)
    grads = [rng.normal(0, 1, (64,)).astype(np.float32) for _ in range(3)]
    tx = jct.make_optimizer(cfg)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tct.make_optimizer([tp], cfg)
    p64, m, v = p0.astype(np.float64), 0.0, 0.0
    for count, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        before = tp.detach().clone()
        tp.grad = torch.from_numpy(g)
        lr = tct.learning_rate(count, cfg)
        opt.param_groups[0]["lr"] = lr
        opt.step()
        got = (tp.detach() - before).numpy()
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g.astype(np.float64) ** 2
        exact = -lr * (m / (1 - 0.9 ** (count + 1))
                       / (np.sqrt(v / (1 - 0.999 ** (count + 1))) + 1e-8) + 0.1 * p64)
        p64 = p64 + exact
        if count == 0:
            assert np.all(got == 0) and np.all(np.asarray(upd) == 0)
            continue
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got, np.asarray(upd), rtol=2e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# One whole train step
# ---------------------------------------------------------------------------


def _ref_crops(cfg, data, step):
    """The reference's crops of train step ``step`` (vmapped, not jitted)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step),
                            cfg.batch_size)
    return jax.vmap(partial(
        jct._sample_crop, frames=jnp.asarray(data["frames"]), boxes=jnp.asarray(data["boxes"]),
        cls=jnp.asarray(data["cls"]), pos=jnp.asarray(data["pos"]), min_zoom=cfg.min_zoom,
        max_zoom=cfg.max_zoom, pos_fraction=cfg.pos_fraction))(keys)


def _ref_loss_and_grads(model_cfg, cfg, params, stats, crops):
    """The reference train step's loss, parts, gradients and new statistics
    on ``crops`` (``cnn_train.py:358-374``)."""
    imgs, boxes, cls = crops
    grid = tct.CROP // model_cfg.stride

    def loss_fn(params, stats):
        if stats is None:
            out, new = jcd.SignCenterNet(model_cfg).apply({"params": params}, imgs), None
        else:
            out, upd = jct.SignCenterNetV3Train(model_cfg).apply(
                {"params": params, "batch_stats": stats}, imgs, train=True,
                mutable=["batch_stats"])
            new = upd["batch_stats"]
        tgt = jax.vmap(partial(jct.make_targets, grid_h=grid, grid_w=grid,
                               stride=model_cfg.stride))(boxes, cls)
        total, parts = jct.centernet_loss(out, tgt, cfg)
        return total, (parts, new)

    (loss, (parts, new)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, stats)
    return float(loss), parts, grads, new


def _grads(model) -> dict:
    """The port's gradients in the reference's flat layout (kernels HWIO)."""
    out = {}
    for key, layer, name in tcd.flax_entries(model):
        conv_kernel = isinstance(layer, tcd.Conv) and name == "kernel"
        p = layer.weight if conv_kernel else getattr(layer, name)
        g = p.grad.detach()
        out[key] = (g.permute(2, 3, 1, 0) if g.dim() == 4 else g).numpy()
    return out


STEP_CFG = tct.TrainConfig(batch_size=2, steps=10, warmup_steps=2, lr=1e-3)


def _initial(arch):
    """The reference's initial variables at float32 and the port's model
    carrying them."""
    kw = {} if arch == "v3" else TINY
    jcfg = jcd.CNNDetectorConfig(arch=arch, dtype="float32", **kw)
    if arch == "v3":
        var = jct.SignCenterNetV3Train(jcfg).init(jax.random.PRNGKey(1),
                                                  jnp.zeros((1, 64, 64, 3), jnp.uint8))
        return jcfg, var["params"], var["batch_stats"], _twin(_flat(var["params"]),
                                                              _flat(var["batch_stats"]))
    params = jcd.init_params(jcfg, 1, (64, 64))
    model = tcd.load_flat_params(
        tcd.SignCenterNet(tcd.CNNDetectorConfig(arch=arch, dtype="float32", **kw)), _flat(params))
    return jcfg, params, None, model


@pytest.fixture(scope="module", params=["v3", "slim"])
def step_case(request, data):
    """Both packages from the same initial weights through two f32 steps on
    the reference's crops of steps 7 and 3 (the optimizer's counts are 0
    and 1), batch 2, warm-up 2: the reference's step body (loss, gradients,
    optax update) and the port's ``TrainStep.update``.  -> per step, each
    side's (loss, parts, grads, params after, statistics after)."""
    cfg = STEP_CFG
    jcfg, params, stats, model = _initial(request.param)
    tx = jct.make_optimizer(cfg)
    opt_state = tx.init(params)
    trainer = tct.TrainStep(model, cfg)
    steps = []
    for step in (7, 3):
        crops = _ref_crops(cfg, data, step)
        loss, parts, grads, stats = _ref_loss_and_grads(jcfg, cfg, params, stats, crops)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        got = trainer.update(*(torch.from_numpy(np.array(c)) for c in crops))
        steps.append({
            "ref": (loss, {k: float(v) for k, v in parts.items()}, _flat(grads), _flat(params),
                    None if stats is None else _flat(stats)),
            "port": (got["loss"].item(), {k: got[k].item() for k in parts}, _grads(model),
                     tcd.flat_params(model),
                     None if stats is None else tcd.flat_params(model, "batch_stats"))})
    return steps, trainer


def test_train_step_loss_and_grads_match_reference(step_case):
    """On the same crops: loss and its parts within 1e-5 relative; each
    gradient leaf within 1e-4 of its largest magnitude."""
    steps, _ = step_case
    for s in steps:
        (loss, parts, grads, *_), (tloss, tparts, tgrads, *_) = s["ref"], s["port"]
        np.testing.assert_allclose(tloss, loss, rtol=1e-5)
        for k in parts:
            np.testing.assert_allclose(tparts[k], parts[k], rtol=1e-5, err_msg=k)
        assert set(tgrads) == set(grads)
        for k in grads:
            _close(tgrads[k], grads[k], 1e-4, k)


def test_train_step_update_matches_reference(step_case):
    """Parameters and statistics after each update within 1e-5.  The first
    update (count 0, crops of step 7) leaves the parameters as they were,
    the second (count 1, step 3) moves them at the warm-up's lr / 2."""
    steps, trainer = step_case
    assert trainer.count == 2
    for s in steps:
        for ref, got in zip(s["ref"][3:], s["port"][3:]):
            if ref is None:
                continue
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
    first, second = steps[0]["port"][3], steps[1]["port"][3]
    assert max(np.abs(second[k] - first[k]).max() for k in first) > 1e-4


def test_step_from_draws_matches_reference_step(data):
    """The reference's jitted v3 step at step 7 (count 0) from fresh
    weights, and the port's step on its own crops of the same draws: the
    parameters stay as they were on both sides, the statistics agree
    within 1e-5, the loss within 1e-4 relative (each side cuts its own
    crops: a pixel one count apart, which the crop test allows on 0.1% of
    pixels and which tens of these 614,400 are, moves the loss by up to
    2e-5)."""
    cfg = STEP_CFG
    jcfg, params, stats, model = _initial("v3")
    step_fn = jax.jit(jct.make_v3_train_step(jcfg, cfg))
    new_params, new_stats, _, metrics = step_fn(
        params, stats, jct.make_optimizer(cfg).init(params),
        {k: jnp.asarray(v) for k, v in data.items()}, jnp.int32(7))
    before = tcd.flat_params(model)
    got = tct.TrainStep(model, cfg).update(
        *tct.crops_from_draws(_step_draws(cfg, 7, data), _torch_data(data), cfg))
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    after = tcd.flat_params(model)
    assert all(np.array_equal(after[k], v) and np.array_equal(v, np.asarray(w))
               for (k, v), w in zip(before.items(), (_flat(new_params)[k] for k in before)))
    for k, v in _flat(new_stats).items():
        np.testing.assert_allclose(tcd.flat_params(model, "batch_stats")[k], v, rtol=0,
                                   atol=1e-5, err_msg=k)


def test_bf16_train_loss_matches_reference(data):
    """The default bfloat16 twin on the same crops: loss within 2e-2
    relative (both round convs to bf16 after sums taken in other
    orders)."""
    cfg = tct.TrainConfig(batch_size=2)
    jcfg = jcd.CNNDetectorConfig(arch="v3")
    var = jct.SignCenterNetV3Train(jcfg).init(jax.random.PRNGKey(2),
                                              jnp.zeros((1, 64, 64, 3), jnp.uint8))
    crops = _ref_crops(cfg, data, 5)
    loss, *_ = _ref_loss_and_grads(jcfg, cfg, var["params"], var["batch_stats"], crops)
    model = _twin(_flat(var["params"]), _flat(var["batch_stats"]), dtype="bfloat16").train()
    imgs, boxes, cls = (torch.from_numpy(np.array(c)) for c in crops)
    got, _ = tct.centernet_loss(model(imgs), tct.crop_targets(boxes, cls, 16), cfg)
    np.testing.assert_allclose(got.item(), loss, rtol=2e-2)


def test_train_returns_folded_inference_net(data):
    """Two steps of ``train`` on the CPU: the v3 twin comes back folded, its
    parameters without grads, finite; the log lines name the metrics and the
    timer sees each step's four stages."""
    lines, stages = [], []

    @contextlib.contextmanager
    def timer(name):
        stages.append(name)
        yield

    net, metrics = tct.train(data, tcd.CNNDetectorConfig(arch="v3"),
                             tct.TrainConfig(batch_size=2, steps=2), log_every=1,
                             log_fn=lines.append, device="cpu", timer=timer)
    assert stages == ["sample+resize", "targets", "forward+backward", "optimizer"] * 2
    assert isinstance(net, tcd.SignCenterNet) and net.cfg.arch == "v3"
    assert not any(p.requires_grad for p in net.parameters())
    assert all(np.isfinite(v).all() for v in tcd.flat_params(net).values())
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1"]
    assert set(metrics) == {"loss", "hm", "wh", "off"} and "loss=" in lines[0]
    with pytest.raises(ValueError, match="no mapped gt box"):
        tct.upload_dataset({**data, "pos": np.zeros((0, 3), np.float32)}, "cpu")


# ---------------------------------------------------------------------------
# The training twin end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli") / "gtsdb")
    write_gt_dir(root, 3, 800, 1360, seed=66)
    return root


def test_build_dataset_matches_reference(gt_dir, tmp_path):
    """The padded arrays of a GTSDB-style directory, one unmapped class
    (an ignore box) added, equal the reference's."""
    import shutil

    root = str(tmp_path / "with_ignore")
    shutil.copytree(gt_dir, root)
    with open(os.path.join(root, "gt.txt"), "a") as f:
        f.write("00001.ppm;10;20;40;52;12\n")
    want, got = jct.build_dataset(root), tct.build_dataset(root)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["cls"] == -1).sum() == 1 and len(got["pos"]) == 18


def test_train_script_trains_saves_and_scores(tmp_path, gt_dir, capsys, monkeypatch):
    """``scripts/train_cnn_torch.py --cpu --steps 2 --batch 2`` writes an
    npz the reference's ``CNNDetector.load`` reads as v3 at the threshold
    given, a resultado.txt, and the reference's P/R/F1 and AP lines;
    ``--eval_only`` on that npz writes the same resultado.txt as
    ``scripts/train_cnn.py --eval_only --cpu``."""
    import train_cnn
    import train_cnn_torch

    out, res = str(tmp_path / "cnn.npz"), str(tmp_path / "ours.txt")
    common = ["--train_path", gt_dir, "--test_path", gt_dir, "--out", out, "--threshold", "0.3"]
    assert train_cnn_torch.main(common + ["--cpu", "--steps", "2", "--batch", "2",
                                          "--resultado", res]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("dataset: (3, 800, 1360, 3) frames, 18 sign boxes, 0 ignore")
    assert [ln.split(" loss=")[0] for ln in lines[1:3]] == ["step 0:", "step 1:"]
    assert lines[3].startswith("trained 2 steps in ") and lines[4] == f"saved {out}"
    assert lines[5].startswith("0 detections over 3 frames in ")
    assert lines[6] == "totals: correct 0 incorrect 0 missed 18 | P nan R 0.0 F1 0.0"
    assert lines[7] == "PASCAL AP@0.5: 0.0000 (11pt 0.0000)"
    jdet = jcd.CNNDetector.load(out)
    assert jdet.cfg.arch == "v3" and jdet.cfg.score_threshold == pytest.approx(0.3)

    ours, ref = str(tmp_path / "ours_eval.txt"), str(tmp_path / "ref_eval.txt")
    assert train_cnn_torch.main(common + ["--eval_only", "--device", "cpu",
                                          "--resultado", ours]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train_cnn.py", *common, "--eval_only", "--cpu",
                                      "--resultado", ref])
    train_cnn.main()
    ref_lines = capsys.readouterr().out.splitlines()
    with open(ours) as a, open(ref) as b:
        assert a.read() == b.read()
    assert port_lines[1:] == ref_lines[1:]


def test_train_script_eval_only_matches_reference_on_shipped_weights(tmp_path, gt_dir, capsys,
                                                                     monkeypatch):
    """``--eval_only`` on the shipped v3 checkpoint at threshold 0.1: both
    twins' resultado.txt agree within the CNN parity bound (same file and
    class, corners within 1 px, scores within 0.05, but detections within
    0.05 of the threshold), and both print the stats and AP lines."""
    import train_cnn
    import train_cnn_torch

    params = os.path.join(REPO, "artifacts", "cnn_detector", "params.npz")
    ours, ref = str(tmp_path / "ours.txt"), str(tmp_path / "ref.txt")
    common = ["--test_path", gt_dir, "--out", params, "--threshold", "0.1", "--eval_only"]
    assert train_cnn_torch.main(common + ["--device", "cpu", "--resultado", ours]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train_cnn.py", *common, "--cpu", "--resultado", ref])
    train_cnn.main()
    ref_lines = capsys.readouterr().out.splitlines()
    want, got = load_results_file(ref), load_results_file(ours)
    assert want, "the reference detected nothing on the synthetic frames"
    assert not tcd.unmatched_detections(want, got, 0.05, 0.1)
    assert [ln.split()[0] for ln in port_lines] == [ln.split()[0] for ln in ref_lines]


def test_train_script_refuses_a_missing_card(tmp_path, gt_dir, capsys, monkeypatch):
    import train_cnn_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_cnn_torch.main(["--train_path", gt_dir, "--out", str(tmp_path / "x.npz"),
                                 "--device", "cuda"]) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().out
    assert not (tmp_path / "x.npz").exists()


class _Parsed(Exception):
    """Raised in place of ``parse_args``: carries the parser it was called on."""

    def __init__(self, parser):
        super().__init__("parser captured")
        self.parser = parser


def _parser_defaults(main, monkeypatch) -> dict:
    """The defaults of the parser that ``main()`` builds, by ``dest``, the
    port-only ``--device`` left out."""
    import argparse

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as caught:
            main()
    return {a.dest: a.default for a in caught.value.parser._actions
            if a.dest not in ("help", "device")}


def test_train_script_defaults_equal_reference(monkeypatch):
    """Every flag of ``scripts/train_cnn_torch.py`` but ``--device``
    defaults as in ``scripts/train_cnn.py``: train and test frames come
    from the reference's train_jpg and test_alumnos_jpg unless given.  The
    twin writes ``--resultado`` into the process's temp dir, the
    reference into /tmp: the two are compared with the temp dir at /tmp."""
    import tempfile

    import train_cnn
    import train_cnn_torch

    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    got = _parser_defaults(train_cnn_torch.main, monkeypatch)
    want = _parser_defaults(train_cnn.main, monkeypatch)
    assert got == want
