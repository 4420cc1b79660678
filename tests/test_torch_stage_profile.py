"""PyTorch port vs the JAX reference: the stage profile and the two CNN rate
probes under ``scripts/``.

``scripts/stage_profile.py`` runs at batch 2 on two synthetic 256x256
frames (``data/synthetic.py: write_gt_dir``, read through each bench's
``_load_frames``) with its ``timeit`` replaced by one recorded call, and its
Pallas kernels through the interpreter: that gives each stage as the
original composes it (the jitted ``detect_batch``, ``vmap(enhance_contrast)``,
its ``downs_pad``, the vmapped ``fused_level_sweep``, ``mser_regions_batch``
and its ``post``), its input and its output.  Each stage of
``scripts/stage_profile_torch.py`` on the same input must give the same
output: ``pre``, ``downs_pad``, ``sweep`` and ``msr`` bit for bit; ``post``
and ``total`` with boxes, types and validity exact and scores within 1e-4.
The twin's stages composed must equal the port's ``detect_batch``, and its
``main`` must print the original's lines.  The int8 probe's three conv
forms are held against ``lax.conv_general_dilated`` at batch 2, 8x12,
3x3 16->16, on the probe's own draws.
"""

import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import bench
import bench_torch
import opencv_traffic_sign_detector_tpu.ops.mser_pallas as jmser_pallas
from opencv_traffic_sign_detector_tpu_torch.config import MSERConfig, PipelineConfig
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_gt_dir
from opencv_traffic_sign_detector_tpu_torch.models.detector import compact_first
from opencv_traffic_sign_detector_tpu_torch.models.mean_masks import (
    MeanMaskTemplates,
    templates_to_torch,
)
from test_torch_tools import _run, interpret  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import int8_probe_torch  # noqa: E402
import stage_profile  # noqa: E402
import stage_profile_torch as sp  # noqa: E402

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

# the config stage_profile.py builds from its defaults, at batch 2
CFG = PipelineConfig(mser=MSERConfig(max_variation=1.0, max_regions=128, downscale=2,
                                     ccl_jumps=0, ccl_iters=2, level_step=9,
                                     refine_scan_passes=2), batch_size=2)
_REF: dict = {}  # the reference's run, made once a process
_TWIN: dict = {}  # the twin's


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("det_root")
    write_gt_dir(str(root / "test_alumnos_jpg"), 2, 256, 256, seed=0)
    return str(root)


@pytest.fixture(scope="module")
def frames(tree) -> np.ndarray:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_torch, "DET_DATA", tree)
        return bench_torch._load_frames(2, "gtsdb")


@pytest.fixture(scope="module")
def templates():
    return templates_to_torch(MeanMaskTemplates.load(
        os.path.join(REPO, "artifacts", "mean_masks.npz")), "cpu")


@pytest.fixture
def ref(frames, interpret, monkeypatch) -> dict:
    """{stage: (its arguments, its output)} of ``stage_profile.main()`` at
    ``--batch 2`` in the twin's stage order, and ``"lines"``, what it
    printed (each time 1 s)."""
    if not _REF:
        monkeypatch.setattr(jmser_pallas, "fused_level_sweep",
                            functools.partial(jmser_pallas.fused_level_sweep, interpret=True))
        monkeypatch.setattr(bench, "_load_frames", lambda n, size: frames)
        calls = []

        def timeit(fn, *args, iters=20):
            out = fn(*args)
            calls.append((args, out))
            return 1.0, out

        monkeypatch.setattr(stage_profile, "timeit", timeit)
        monkeypatch.chdir(REPO)
        rc, lines = _run(stage_profile.main, sys_argv=["--batch", "2"], monkeypatch=monkeypatch)
        assert rc == 0
        _REF.update(zip(sp.STAGES, calls), lines=lines)
    return _REF


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _detections_equal(got, want) -> None:
    """(boxes, types, scores, valid): all exact but scores, within 1e-4."""
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert want[3].any(), "the reference detected nothing; pick another seed"
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)


@pytest.mark.parametrize("stage", sp.STAGES)
def test_stage_equals_reference(stage, ref, twin, frames, templates):
    """The twin's stage on the reference stage's input (``total``: from the
    twin's run, on the same frames).  ``downs_pad`` gives uint8 planes where
    the reference's are int32, the same values."""
    args, want = ref[stage]
    red, blue = templates
    if stage == "total":
        np.testing.assert_array_equal(np.asarray(args[0]), frames)
        _detections_equal(twin["total"], want)
    elif stage == "post":
        _detections_equal(sp.post(CFG, tuple(_t(a) for a in args), red, blue), want)
    elif stage == "msr":
        got = sp.msr(CFG, _t(args[0]))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        x = _t(args[0])
        got = getattr(sp, stage)(CFG, x.to(torch.uint8) if stage == "sweep" else x)
        assert got.dtype == torch.uint8 if stage != "sweep" else got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def twin(tree, monkeypatch) -> dict:
    """{stage: its output} of ``stage_profile_torch.main(["--device", "cpu",
    "--batch", "2"])`` on the tree's frames, with its ``timeit`` replaced by
    one recorded call as the reference's is, and ``"lines"``, what it
    printed."""
    if not _TWIN:
        monkeypatch.setattr(bench_torch, "DET_DATA", tree)
        outs = []

        def timeit(fn, x, device, iters=20):
            outs.append(fn(x))
            return 1.0, outs[-1]

        monkeypatch.setattr(sp, "timeit", timeit)
        rc, lines = _run(sp.main, ["--device", "cpu", "--batch", "2"])
        assert rc == 0
        _TWIN.update(zip(sp.STAGES, outs), lines=lines)
    return _TWIN


def test_composed_stages_equal_detect_batch(twin):
    """``main``'s chain through the twin's graphs (eager on the CPU):
    ``post(frames, *msr(pre(frames)))``, compacted as ``detect_batch``
    compacts, equals ``total``, the port's ``detect_batch``."""
    boxes, types, scores, valid = twin["post"]
    got = compact_first(valid, CFG.max_detections, boxes, types, scores)
    assert twin["total"][3].any()
    for a, b in zip(got, twin["total"], strict=True):
        assert torch.equal(a, b)


def test_main_prints_the_original_lines(twin, ref):
    """The card's line (here the device), then the original's lines but for
    the numbers."""
    assert twin["lines"][0] == "device cpu"

    def untimed(ls):
        return [re.sub(r" *-?\d+\.\d+", " T", ln) for ln in ls]

    assert untimed(twin["lines"][1:]) == untimed(ref["lines"])


# --- the int8 probe -------------------------------------------------------------

SMALL = dict(b=2, h=8, w=12, c=16, n=16)


def test_int8_probe_draws_equal_reference():
    """The original's ``default_rng(0)`` draws, in its order and casts."""
    rng = np.random.default_rng(0)
    b, h, w, c, n = SMALL.values()
    want = {"x_f": jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.bfloat16),
            "k_f": jnp.asarray(rng.standard_normal((3, 3, c, c)), jnp.bfloat16),
            "x_i": jnp.asarray(rng.integers(-127, 127, (b, h, w, c)), jnp.int8),
            "k_i": jnp.asarray(rng.integers(-127, 127, (3, 3, c, c)), jnp.int8),
            "a_f": jnp.asarray(rng.standard_normal((n, n)), jnp.bfloat16),
            "b_f": jnp.asarray(rng.standard_normal((n, n)), jnp.bfloat16),
            "a_i": jnp.asarray(rng.integers(-127, 127, (n, n)), jnp.int8),
            "b_i": jnp.asarray(rng.integers(-127, 127, (n, n)), jnp.int8)}
    got = int8_probe_torch.draws("cpu", **SMALL)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(v, np.float32))


def _reference_conv(form: str, x, k):
    """The original's conv forms (``scripts/int8_probe.py``) on jnp inputs."""
    dn = lax.conv_dimension_numbers(x.shape, k.shape, ("NHWC", "HWIO", "NHWC"))
    if form == "conv_bf16":
        return lax.conv_general_dilated(x, k, (1, 1), "SAME", dimension_numbers=dn)
    y = lax.conv_general_dilated(x, k, (1, 1), "SAME", dimension_numbers=dn,
                                 preferred_element_type=jnp.int32)
    if form == "conv_int8":
        return y
    y = jnp.maximum(y, 0)
    q = jnp.clip(jnp.round(y.astype(jnp.float32) * jnp.float32(0.02)), 0, 127)
    return q.astype(jnp.int8)


@pytest.mark.parametrize("form", ["conv_int8", "conv_int8_requant", "conv_bf16"])
def test_int8_probe_conv_equals_reference(form):
    """int8 -> int32 and the requant exact; bf16 within one bf16 step (2^-7)
    of the largest output, both sides summing in f32 and rounding once."""
    d = int8_probe_torch.draws("cpu", **SMALL)
    xk = ("x_f", "k_f") if form == "conv_bf16" else ("x_i", "k_i")
    x, k = (d[n] for n in xk)
    got = getattr(int8_probe_torch, form)(x, k)
    jx, jk = (jnp.asarray(t.float().numpy(), jnp.bfloat16 if form == "conv_bf16" else jnp.int8)
              for t in (x, k))
    want = np.asarray(_reference_conv(form, jx, jk))
    if form == "conv_bf16":
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        want = want.astype(np.float32)
        gap = np.abs(got.float().numpy() - want).max()
        assert gap <= 2.0 ** -7 * np.abs(want).max(), gap
    else:
        assert got.dtype == {"conv_int8": torch.int32, "conv_int8_requant": torch.int8}[form]
        if form == "conv_int8_requant":
            assert 0 < (want > 0).mean() < 1 and (want == 127).any()
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_probe_matmuls_equal_reference():
    """The matmul forms: int8 -> int32 exact, bf16 within one bf16 step of
    the largest output."""
    d = int8_probe_torch.draws("cpu", **SMALL)
    ja, jb = (jnp.asarray(d[n].numpy()) for n in ("a_i", "b_i"))
    want = np.asarray(lax.dot(ja, jb, preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(int8_probe_torch.mm_int8(d["a_i"], d["b_i"]).numpy(), want)
    ja, jb = (jnp.asarray(d[n].float().numpy(), jnp.bfloat16) for n in ("a_f", "b_f"))
    want = np.asarray(ja @ jb, np.float32)
    got = int8_probe_torch.mm_bf16(d["a_f"], d["b_f"]).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
