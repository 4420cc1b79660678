"""PyTorch port vs the JAX reference: HOG and GRAY descriptors.

The same numpy-seeded crops go through ``ops/hog.py`` of both packages.
The spatial weight table must be identical, the gradients bit-exact, the
descriptors within 1e-5 (the products and sums of the block contraction
run in another order), and the port must reproduce the cv2 4.x golden
fixture with the reference's own residual (cv2's fastAtan2: <= 5e-4, on
the same elements as the reference).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.ops.hog as jhog
import opencv_traffic_sign_detector_tpu_torch.ops.hog as thog

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _crops(seed: int, n: int = 48) -> np.ndarray:
    """Random, flat, two-level and ramp 32x32 crops: every bin, zero
    gradients and exact bin boundaries (axis-aligned gradients)."""
    rng = np.random.default_rng(seed)
    crops = rng.integers(0, 256, (n, 32, 32), dtype=np.uint8)
    crops[0] = 117
    crops[1, :, :16], crops[1, :, 16:] = 20, 230
    crops[2] = np.arange(32, dtype=np.uint8)[None, :] * 7
    crops[3] = np.arange(32, dtype=np.uint8)[:, None] * 5
    return crops


def test_spatial_weights_identical():
    np.testing.assert_array_equal(thog._spatial_weights(), jhog._spatial_weights())


def test_gradients_bit_exact():
    crops = _crops(1)
    want = jhog._gradients(jnp.asarray(crops))
    got = thog._gradients(torch.from_numpy(crops))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [2, 3])
def test_hog_matches_reference(seed):
    crops = _crops(seed)
    want = np.asarray(jhog.hog_descriptors(jnp.asarray(crops)))
    got = thog.hog_descriptors(torch.from_numpy(crops)).numpy()
    assert got.shape == want.shape == (len(crops), 324) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gray_descriptors_match_reference():
    crops = _crops(4)
    np.testing.assert_array_equal(
        thog.gray_descriptors(torch.from_numpy(crops)).numpy(),
        np.asarray(jhog.gray_descriptors(jnp.asarray(crops))))


def test_hog_matches_cv2_golden_with_the_reference_residual():
    data = np.load(os.path.join(REPO, "tests", "fixtures", "cv2_hog_golden.npz"))
    spec = importlib.util.spec_from_file_location(
        "make_cv2_hog_fixture", os.path.join(REPO, "scripts", "make_cv2_hog_fixture.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    np.testing.assert_array_equal(data["crops"], gen.fixture_inputs())
    golden = data["descriptors"]
    got = thog.hog_descriptors(torch.from_numpy(data["crops"])).numpy()
    ref = np.asarray(jhog.hog_descriptors(jnp.asarray(data["crops"])))
    np.testing.assert_allclose(got, golden, atol=5e-4)
    # the residual against cv2 sits on the same elements as the reference's
    np.testing.assert_array_equal(np.abs(got - golden) > 1e-4, np.abs(ref - golden) > 1e-4)
