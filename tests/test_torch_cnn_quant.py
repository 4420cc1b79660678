"""PyTorch port vs the JAX reference: the int8 v3 serving path.

Layer by layer, the reference's int8 activation of layer i-1 goes into the
port's layer i: the int32 accumulators must be bit-exact (both sum
integers exactly), and the requantised int8 within +-1 on at most 0.1% of
values (the f32 epilogue ``acc * mult + bias`` may be contracted into an
FMA by XLA; measured: no value differs).  The ``float_heads`` variant runs
bf16 head convs on both sides: its head maps agree within 0.05.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import opencv_traffic_sign_detector_tpu.models.cnn_detector as jcd
import opencv_traffic_sign_detector_tpu.models.cnn_quant as jcq
import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
import opencv_traffic_sign_detector_tpu_torch.models.cnn_quant as tcq
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8 = os.path.join(REPO, "artifacts", "cnn_detector", "params_int8.npz")


def _torch_q(q: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in q.items()}


def _ref_requant(acc, q, i):
    y = jnp.maximum(acc.astype(jnp.float32) * q[f"q{i}_mult"] + q[f"q{i}_bias"], 0.0)
    return jnp.clip(jnp.round(y * q[f"a{i}_inv"]), 0, 127).astype(jnp.int8)


def _assert_requant_close(got: torch.Tensor, want) -> None:
    diff = np.abs(got.numpy().astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_int8_layers_bit_exact():
    jq, _ = jcq.load_quant_params(INT8)
    tq, _ = tcq.load_quant_params(INT8, "cpu")
    frames = make_frames(2, 96, 160, seed=51)
    # stem
    x = jcq._patchify(jnp.asarray(frames))
    xs = (x.astype(jnp.int32) - 128).astype(jnp.int8)
    acc = jnp.einsum("bhwk,kf->bhwf", xs, jq["q0_kernel"], preferred_element_type=jnp.int32)
    tacc = tcq.stem_int8_acc(tq, torch.from_numpy(frames))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc))
    h = h0 = _ref_requant(acc, jq, 0)
    _assert_requant_close(tcq.requant(tacc, tq["q0_mult"], tq["q0_bias"], tq["a0_inv"]), h)
    # trunk: the reference's activation of layer i-1 into the port's layer i
    for i in (1, 2, 3):
        k, s = jq[f"q{i}_kernel"], jcq._TRUNK_STRIDES[i]
        dn = lax.conv_dimension_numbers(h.shape, k.shape, ("NHWC", "HWIO", "NHWC"))
        acc = lax.conv_general_dilated(h, k, (s, s), "SAME", dimension_numbers=dn,
                                       preferred_element_type=jnp.int32)
        tacc = tcq.conv_int8(torch.from_numpy(np.array(h)), tq[f"q{i}_kernel"], s)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc))
        _assert_requant_close(tcq.requant(tacc, tq[f"q{i}_mult"], tq[f"q{i}_bias"],
                                          tq[f"a{i}_inv"]), _ref_requant(acc, jq, i))
        h = _ref_requant(acc, jq, i)
    # trunk and heads (one fused product on the port's side) from the stem
    want = jcq.v3_int8_trunk_heads(jq, h0)
    got = tcq.v3_int8_trunk_heads(tq, torch.from_numpy(np.array(h0)))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5)


def test_int8_matmul_plain_is_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (37, 1152), dtype=np.int8)
    b = rng.integers(-128, 128, (1152, 10), dtype=np.int8)
    got = tcq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(ValueError):
        tcq.int8_matmul(torch.from_numpy(a).to("meta"), torch.from_numpy(b).to("meta"))


@pytest.fixture(scope="module", params=["port", "reference"])
def float_heads_q(request):
    """A ``float_heads`` artifact made from random v3 weights, with heads
    lifted so that something is detected, by the port's quantizer or by the
    reference's own."""
    cfg = jcd.CNNDetectorConfig(arch="v3")
    params = dict(jcd.init_params(cfg, 3, (64, 64)))
    params["Conv_4"] = {"kernel": params["Conv_4"]["kernel"],
                        "bias": params["Conv_4"]["bias"] + 4.0}
    calib = make_frames(2, 64, 96, seed=52)
    if request.param == "reference":
        return jcq.quantize_v3(params, calib, float_heads=True)
    flat = {f"['{m}']['{n}']": np.asarray(v) for m, leaf in params.items() for n, v in leaf.items()}
    return tcq.quantize_v3(flat, calib, float_heads=True)


def test_float_heads_variant_matches_reference(float_heads_q):
    frames = make_frames(2, 64, 96, seed=53)
    want = jcq.v3_int8_forward({k: jnp.asarray(v) for k, v in float_heads_q.items()},
                               jnp.asarray(frames))
    got = tcq.v3_int8_forward(_torch_q(float_heads_q), torch.from_numpy(frames))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=0.05)


def test_quant_artifact_roundtrip_and_loader_dispatch(tmp_path):
    det = tcq.load_detector(INT8, device="cpu", upscale=1.6)
    assert isinstance(det, tcq.QuantCNNDetector) and det.upscale == 1.6
    assert det.cfg == tcd.CNNDetectorConfig(**jcq.load_quant_params(INT8)[1])
    out = str(tmp_path / "int8.npz")
    det.save(out)
    with np.load(out) as saved, np.load(INT8) as orig:
        assert set(saved.files) == set(orig.files) - {"__source_sha256__"}
        for key in saved.files:
            np.testing.assert_array_equal(saved[key], orig[key])
    assert tcq.saved_quant(out) == "int8" == jcq.saved_quant(out)
    assert tcq.saved_quant(os.path.join(REPO, "artifacts", "cnn_detector", "params.npz")) is None
    with pytest.raises(ValueError, match="v3 arch"):
        tcq.QuantCNNDetector(det.q, tcd.CNNDetectorConfig(arch="slim"))
