"""PyTorch port vs the JAX reference: min-key propagation and kernels K5, K6.

All comparisons are bit-exact.  K5's plain version is held against the
reference kernel body (``pallas_prop._kernel``) run through the Pallas
interpreter, K6's against ``propagate_scan_pallas(interpret=True)``.
``propagate_min_keys`` is compared without ``TSD_PALLAS_INTERPRET``: with it
the reference's jump-free rank-3 branch calls ``propagate_rolls_pallas``,
which has no interpret switch and refuses the CPU backend; without it the
reference takes its XLA roll passes, which compute the same keys.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import opencv_traffic_sign_detector_tpu.ops.ccl as jccl
import opencv_traffic_sign_detector_tpu.ops.pallas_prop as jprop
import opencv_traffic_sign_detector_tpu_torch.ops.ccl as tccl
import opencv_traffic_sign_detector_tpu_torch.ops.prop_cuda as tprop
from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_interpret(monkeypatch):
    monkeypatch.delenv("TSD_PALLAS_INTERPRET", raising=False)


def _random_mask(rng, shape, density, border):
    mask = rng.random(shape) < density
    if not border:
        mask[..., 0, :] = mask[..., -1, :] = mask[..., :, 0] = mask[..., :, -1] = False
    return mask


def _index_keys(rng, shape):
    """``intensity * H*W + flat index``, the sweep's composite keys."""
    h, w = shape[-2:]
    return (rng.integers(0, 256, shape) * (h * w)
            + np.arange(h * w).reshape(h, w)).astype(np.int32)


@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("density,passes", [(0.3, 7), (0.6, 24), (0.9, 0)])
def test_k5_plain_matches_kernel_interpret(density, passes, border):
    rng = np.random.default_rng(int(density * 10) + passes)
    shape = (3, 24, 40)
    keys = rng.integers(-5, 2**20, shape).astype(np.int32)
    mask = _random_mask(rng, shape, density, border)
    big = 2**21
    kern = functools.partial(jprop._kernel, num_rolls=passes, big=big)
    want = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(keys), jnp.asarray(mask).astype(jnp.int8))
    got = tprop.propagate_rolls(torch.from_numpy(keys), torch.from_numpy(mask), big, passes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(30, 44), (3, 30, 44), (2, 2, 30, 44)],
                         ids=["rank2", "rank3", "rank4"])
@pytest.mark.parametrize("edges_safe", [True, False])
@pytest.mark.parametrize("num_jumps", [0, 1])
def test_propagate_min_keys_matches(shape, edges_safe, num_jumps):
    rng = np.random.default_rng(len(shape) * 10 + num_jumps)
    mask = _random_mask(rng, shape, 0.7, border=True)
    keys = _index_keys(rng, shape)
    big = 256 * shape[-1] * shape[-2]
    keys = np.where(mask, keys, big).astype(np.int32)
    want = np.asarray(jccl.propagate_min_keys(jnp.asarray(keys), jnp.asarray(mask), big,
                                              num_rolls=3, num_jumps=num_jumps,
                                              edges_safe=edges_safe))
    rt.reset_launch_counts()
    got = tccl.propagate_min_keys(torch.from_numpy(keys), torch.from_numpy(mask), big,
                                  num_rolls=3, num_jumps=num_jumps, edges_safe=edges_safe)
    assert got.shape == keys.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != keys).any()  # some keys moved
    assert rt.launch_counts() == dict.fromkeys(rt.KERNELS, 0)  # CPU: plain only


def _flood_inputs(rng, n, h, w):
    mask = _random_mask(rng, (n, h, w), 0.62, border=False)
    big = h * w + 1
    seeds = np.full((n, h, w), big, np.int32)
    sy, sx = rng.integers(1, h - 1, n), rng.integers(1, w - 1, n)
    seeds[np.arange(n), sy, sx] = 0
    mask[np.arange(n - 1), sy[:-1], sx[:-1]] = True  # all seeds but the last on the mask
    return seeds, mask, big


@pytest.mark.parametrize("passes", [0, 1, 3])
def test_k6_plain_matches_scan_interpret(passes):
    rng = np.random.default_rng(40 + passes)
    seeds, mask, big = _flood_inputs(rng, 6, 40, 56)
    keys = np.where(rng.random(seeds.shape) < 0.1, rng.integers(0, big, seeds.shape),
                    seeds).astype(np.int32)
    for k in (seeds, keys):
        want = np.asarray(jprop.propagate_scan_pallas(jnp.asarray(k), jnp.asarray(mask),
                                                      big, passes, interpret=True))
        got = tprop.propagate_scan(torch.from_numpy(k), torch.from_numpy(mask), big, passes)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("passes", [1, 2])
def test_k6_bbox_equals_k4(passes):
    """bbox and area of ``K6(seed map, mask) == 0`` equal K4's output on the
    same candidate windows (the identity chip_smoke.py checks on the card)."""
    rng = np.random.default_rng(50 + passes)
    planes = rng.integers(0, 256, (3, 90, 100)).astype(np.uint8)
    planes[:, 30:60, 20:70] //= 3  # dark blobs: components larger than a pixel
    n, win = 16, 48
    cand = np.stack([rng.integers(0, 3, n), rng.integers(0, 90 - win, n),
                     rng.integers(0, 100 - win, n), rng.integers(0, win, n),
                     rng.integers(0, win, n), rng.integers(40, 200, n)], -1).astype(np.int32)
    planes_t, cand_t = torch.from_numpy(planes), torch.from_numpy(cand)
    big = win * win + 1
    k4 = tprop.flood_bbox(planes_t, cand_t, win, win, passes, big)
    mask, seed = tprop.candidate_windows(planes_t, cand_t, win, win)
    seed_map = torch.where(seed, 0, big).to(torch.int32)
    k6 = tprop.propagate_scan(seed_map, mask, big, passes)
    np.testing.assert_array_equal(tprop.bbox_area(k6 == 0, big).numpy(), k4.numpy())
    assert (k4[:, 4] > 1).sum() >= 3 and (k4[:, 4] == 0).sum() >= 1


def test_k5_roll_flood_reaches_k6_component():
    """Enough roll passes reach the whole seed component: K5 then equals K6."""
    rng = np.random.default_rng(60)
    seeds, mask, big = _flood_inputs(rng, 5, 32, 32)
    k5 = tprop.propagate_rolls(torch.from_numpy(seeds), torch.from_numpy(mask), big, 32 * 32)
    k6 = tprop.propagate_scan(torch.from_numpy(seeds), torch.from_numpy(mask), big, 256)
    np.testing.assert_array_equal(k5.numpy(), k6.numpy())


@pytest.mark.parametrize("case", ["keys_dtype", "mask_dtype", "shape", "rank", "scan_size"])
def test_wrappers_reject_bad_input(case, monkeypatch):
    k = torch.zeros((2, 16, 16), dtype=torch.int32)
    m = torch.zeros((2, 16, 16), dtype=torch.bool)
    if case == "scan_size":
        # K6's kernel takes planes of at most 128x128; CPU tensors take the
        # plain version at any size, so the refusal is shown for tensors
        # bound for the kernel, before the library is reached
        monkeypatch.setattr(rt, "uses_plain", lambda *tensors: False)
        monkeypatch.setattr(rt, "library", lambda: pytest.fail("the library was reached"))
    calls = {
        "keys_dtype": lambda: tprop.propagate_rolls(k.long(), m, 9, 2),
        "mask_dtype": lambda: tprop.propagate_rolls(k, m.to(torch.uint8), 9, 2),
        "shape": lambda: tprop.propagate_rolls(k, m[:, :8].contiguous(), 9, 2),
        "rank": lambda: tprop.propagate_scan(k[0], m[0], 9, 2),
        "scan_size": lambda: tprop.propagate_scan(
            torch.zeros((1, 130, 8), dtype=torch.int32),
            torch.zeros((1, 130, 8), dtype=torch.bool), 9, 2),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()
