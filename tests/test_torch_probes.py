"""PyTorch port vs the JAX reference: the CNN variant timer and the
primitive microbench under ``scripts/``.

``scripts/cnn_variants_torch.py``: each variant's flax module is initialised
at ``PRNGKey(0)`` on the first of 2 frames of 128x192 from
``default_rng(0)`` and applied to both; its parameters, carried into the
twin (``params_from_flax``), must give heads of the same shapes, each
within 3% of the reference head's largest |value| (bf16 convs round after
sums taken in other orders), and the twin's flax names and shapes must be
the module's.  Product mode must print the reference's parameter count for
each arch, and ``main`` the reference's lines but for times.

``scripts/tpu_microbench_torch.py``: each case runs at full size with its
``bench`` replaced by one recorded call on both sides (the reference's case
takes < 0.2 s on a CPU): the inputs must be the reference's draws, and the
results equal exactly, but ``top_k``'s, whose values must be equal and
``x[idx]`` equal to them, with the indices equal where a value is untied
(the f32 casts of 10 M draws tie near 1.0).
"""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu_torch.models.cnn_detector as tcd
from test_torch_tools import _run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cnn_variants  # noqa: E402
import cnn_variants_torch as cvt  # noqa: E402
import tpu_microbench  # noqa: E402
import tpu_microbench_torch as tmt  # noqa: E402

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

BOUND = 0.03  # a head's largest gap, as a share of the reference's largest |value|
FRAMES = np.random.default_rng(0).integers(0, 256, (2, 128, 192, 3), np.uint8)
_REF: dict = {}  # variant -> (flat params, heads), made once a process


def _reference(name: str) -> tuple[dict, dict]:
    """The flax variant's ``params`` at ``PRNGKey(0)``, flat keystr ->
    numpy, and its heads on :data:`FRAMES` (init and apply jitted)."""
    if name not in _REF:
        spec = cnn_variants.VARIANTS[name]
        m = cnn_variants.Variant(**spec) if isinstance(spec, dict) else spec()
        p = jax.jit(m.init)(jax.random.PRNGKey(0), FRAMES[:1])
        flat = {jax.tree_util.keystr(kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(p["params"])[0]}
        _REF[name] = flat, {k: np.asarray(v) for k, v in jax.jit(m.apply)(p, FRAMES).items()}
    return _REF[name]


@pytest.mark.parametrize("name", list(cnn_variants.VARIANTS))
def test_variant_equals_reference(name):
    flat, want = _reference(name)
    twin = cvt.params_from_flax(cvt.make_variant(name), flat)
    with torch.inference_mode():
        got = twin(torch.from_numpy(FRAMES))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, k
        assert np.abs(g - w).max() <= BOUND * np.abs(w).max(), k


@pytest.mark.parametrize("name", list(cnn_variants.VARIANTS))
def test_variant_flax_names_equal_reference(name):
    flat, _ = _reference(name)
    got = {key: layer.flax_shapes()[n]
           for key, layer, n in tcd.flax_entries(cvt.make_variant(name))}
    assert got == {k: v.shape for k, v in flat.items()}


def _params_k(lines: list[str]) -> str:
    (line,) = lines
    return re.search(r"\((\d+)k params\)", line).group(1)


@pytest.mark.parametrize("arch", ["base", "slim", "v2wide", "v2s16", "v2s16wide", "v3"])
def test_product_param_counts_equal_reference(arch):
    """One batch of one GTSDB frame, one timed dispatch each side."""
    _, want = _run(lambda _: cnn_variants.product_timing(arch, 1, "gtsdb", 1))
    _, got = _run(lambda _: cvt.product_timing(arch, 1, "gtsdb", 1, "cpu"))
    assert _params_k(got) == _params_k(want)


def test_variants_main_lines_equal_reference(monkeypatch):
    """``--variant slim`` and ``--variant product --arch v3`` at batch 1 of
    GTSDB's size, each ``timeit`` one call: the card's line (here the
    device), then the original's lines but for the numbers with a point."""
    monkeypatch.setattr(cnn_variants, "timeit", lambda fn, *a, iters=10: (fn(*a), 1.0)[1])
    monkeypatch.setattr(cvt, "timeit", lambda fn, *a, iters=10: (fn(*a), 1.0)[1])

    def untimed(ls):
        return [re.sub(r" *\d+\.\d+", " T", ln) for ln in ls]

    for argv in (["--variant", "slim"], ["--variant", "product", "--arch", "v3"]):
        argv = argv + ["--batch", "1", "--size", "gtsdb", "--iters", "1"]
        rc, want = _run(cnn_variants.main, sys_argv=argv, monkeypatch=monkeypatch)
        assert rc == 0
        rc, got = _run(cvt.main, argv + ["--device", "cpu"])
        assert rc == 0 and got[0] == "device cpu"
        assert untimed(got[1:]) == untimed(want) and len(want) == 1


def _recorded(main, argv, monkeypatch, mod) -> tuple[list[str], tuple, object]:
    """(the lines, the case's inputs, its output) of ``main(argv)`` with
    ``mod.bench`` one recorded call."""
    calls = []

    def bench(fn, *args, iters=5):
        calls.append((args, fn(*args)))
        return 1.0

    monkeypatch.setattr(mod, "bench", bench)
    rc, lines = _run(main, argv)
    assert rc == 0 and len(calls) == 1
    return lines, *calls[0]


@pytest.mark.parametrize("case", list(tmt.CASES))
def test_microbench_case_equals_reference(case, monkeypatch):
    lines, args, want = _recorded(tpu_microbench.main, case, monkeypatch, tpu_microbench)
    assert lines == [f"{case} 1.0"]
    got_lines, got_args, got = _recorded(tmt.main, [case, "--device", "cpu"], monkeypatch, tmt)
    assert got_lines == ["device cpu", f"{case} 1.0"]
    # the original's draws, as values (the twin's indices are int64, its
    # scatter_max_u16 values int32)
    assert len(got_args) == len(args)
    for g, w in zip(got_args, args):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "top_k":
        values, idx = (t.numpy() for t in got)
        want_values, want_idx = (np.asarray(t) for t in want)
        x = got_args[0].numpy()
        np.testing.assert_array_equal(values, want_values)
        np.testing.assert_array_equal(x[idx], values)
        seen, counts = np.unique(x[x >= values.min()], return_counts=True)
        untied = ~np.isin(values, seen[counts > 1])
        assert untied.sum() > 512
        np.testing.assert_array_equal(idx[untied], want_idx[untied])
    else:
        w = np.asarray(want)
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


def test_unknown_microbench_case_prints_the_original_line(monkeypatch):
    _, want = _run(tpu_microbench.main, "no_such_case")
    rc, got = _run(tmt.main, ["no_such_case", "--device", "cpu"])
    assert rc == 0 and got == ["device cpu"] + want == ["device cpu", "unknown case no_such_case"]
