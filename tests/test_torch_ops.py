"""PyTorch port vs the JAX reference: pixel ops, geometry, crops, histograms,
dedup and mean-mask classification, plus the port's guards and wrappers.

Inputs are made with numpy from a fixed seed and handed to both packages.
Tolerances: bit-exact for the integer pixel ops; crops within 1 count on at
most 0.5% of values (the window products sum in another f32 order);
similarities within 1e-5 with equal dedup and classify decisions.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.ops.blur as jblur
import opencv_traffic_sign_detector_tpu.ops.color as jcolor
import opencv_traffic_sign_detector_tpu.ops.dedup as jdedup
import opencv_traffic_sign_detector_tpu.ops.geometry as jgeom
import opencv_traffic_sign_detector_tpu.ops.histogram as jhist
import opencv_traffic_sign_detector_tpu.ops.resize as jresize
import opencv_traffic_sign_detector_tpu.models.mean_masks as jmm
import opencv_traffic_sign_detector_tpu_torch.ops.blur as tblur
import opencv_traffic_sign_detector_tpu_torch.ops.color as tcolor
import opencv_traffic_sign_detector_tpu_torch.ops.dedup as tdedup
import opencv_traffic_sign_detector_tpu_torch.ops.geometry as tgeom
import opencv_traffic_sign_detector_tpu_torch.ops.histogram as thist
import opencv_traffic_sign_detector_tpu_torch.ops.resize as tresize
import opencv_traffic_sign_detector_tpu_torch.models.mean_masks as tmm
from opencv_traffic_sign_detector_tpu.constants import DEDUP_COORD_TOL, DEDUP_HIST_TOL
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_frames, write_train_dir
from opencv_traffic_sign_detector_tpu_torch.ops import clahe_cuda, mser_cuda, prop_cuda
from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n=2, h=96, w=128, seed=0):
    return make_frames(n, h, w, seed=seed, signs_per_frame=3)


def _rand_bgr(seed=1, shape=(4, 64, 64, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("name", ["bgr_to_gray", "bgr_to_hsv"])
def test_color_conversions_bit_exact(name):
    x = np.concatenate([_rand_bgr().reshape(-1, 3), _frames().reshape(-1, 3)])
    want = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
    got = getattr(tcolor, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gray_full_truth_table_subset():
    v = np.arange(0, 256, 5, dtype=np.uint8)
    x = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_array_equal(tcolor.bgr_to_gray(torch.from_numpy(x)).numpy(),
                                  np.asarray(jcolor.bgr_to_gray(jnp.asarray(x))))


@pytest.mark.parametrize("color", ["r", "b"])
def test_color_mask_bit_exact(color):
    x = np.concatenate([_rand_bgr(2), _frames()[:, :64, :64]])
    np.testing.assert_array_equal(
        tcolor.color_mask(torch.from_numpy(x), color).numpy(),
        np.asarray(jcolor.color_mask(jnp.asarray(x), color)))


@pytest.mark.parametrize("gamma", [2.0, 1.5])
def test_gamma_bit_exact(gamma):
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        tcolor.gamma_correct(torch.from_numpy(x), gamma).numpy(),
        np.asarray(jcolor.gamma_correct(jnp.asarray(x), gamma)))


@pytest.mark.parametrize("shape", [(2, 37, 53), (64, 64)])
def test_blur_bit_exact(shape):
    x = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        tblur.gaussian_blur_3x3(torch.from_numpy(x)).numpy(),
        np.asarray(jblur.gaussian_blur_3x3(jnp.asarray(x))))


def _boxes_xywh(n=64, seed=4):
    rng = np.random.default_rng(seed)
    b = np.stack([rng.integers(0, 200, n), rng.integers(0, 200, n),
                  rng.integers(1, 90, n), rng.integers(1, 90, n)], -1).astype(np.int32)
    return b, rng.random(n) < 0.8


def test_filter_and_grow_matches():
    b, v = _boxes_xywh()
    jb, jk = jgeom.filter_and_grow_boxes(jnp.asarray(b), jnp.asarray(v), 1.30)
    tb, tk = tgeom.filter_and_grow_boxes(torch.from_numpy(b), torch.from_numpy(v), 1.30)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_coord_similarity_within_tolerance():
    b, v = _boxes_xywh(seed=5)
    xyxy = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], -1)
    xyxy[1] = xyxy[0] + 1  # near-duplicates
    want = np.asarray(jgeom.pairwise_coord_similarity(jnp.asarray(xyxy)))
    got = tgeom.pairwise_coord_similarity(torch.from_numpy(xyxy)[None])[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# jitted like the reference's detection path (jit turns "/ const" into a
# product with the reciprocal, which the port reproduces)
_jit_crop = jax.jit(jresize.crop_and_resize, static_argnums=(2, 3))
_jit_classify = jax.jit(jmm.mask_correlation_classify, static_argnames=("tol", "fine_scores"))


def _crop_boxes(n, h, w, seed):
    rng = np.random.default_rng(seed)
    x1 = rng.integers(-10, w - 10, n)
    y1 = rng.integers(-10, h - 10, n)
    side = rng.integers(5, 160, n)
    return np.stack([x1, y1, x1 + side, y1 + side], -1).astype(np.int32)


@pytest.mark.parametrize("h,w,exact,jit", [(256, 256, False, True), (96, 128, False, True),
                                           (256, 256, True, True), (96, 128, False, False)])
def test_crop_and_resize_within_one_count(h, w, exact, jit):
    frames = _frames(2, h, w, seed=6)
    boxes = np.stack([_crop_boxes(24, h, w, 7), _crop_boxes(24, h, w, 8)])
    got = tresize.crop_and_resize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                  25, exact=exact, reciprocal=jit).numpy()
    ref = _jit_crop if jit else jresize.crop_and_resize
    for i in range(2):
        want = np.asarray(ref(jnp.asarray(frames[i]), jnp.asarray(boxes[i]), 25, exact))
        diff = np.abs(got[i].astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 0.005


def _crops_and_boxes(seed=9):
    frames = _frames(1, 256, 256, seed=seed)
    boxes = _crop_boxes(32, 256, 256, seed + 1)
    boxes[5] = boxes[4] + 1  # near-duplicate pairs for both dedup passes
    boxes[9] = boxes[8]
    crops = np.array(_jit_crop(jnp.asarray(frames[0]), jnp.asarray(boxes), 25, False))
    valid = np.random.default_rng(seed).random(32) < 0.9
    return crops, boxes, valid


def test_hist_correlation_within_tolerance():
    crops, _, _ = _crops_and_boxes()
    want = np.asarray(jhist.hist_correlation(jnp.asarray(crops)))
    got = thist.hist_correlation(torch.from_numpy(crops)[None])[0].numpy()
    np.testing.assert_array_equal(thist.hs_histograms(torch.from_numpy(crops)).numpy(),
                                  np.asarray(jhist.hs_histograms(jnp.asarray(crops))))
    # f32 sums over 3000 bins in another order than XLA's: the reference's
    # own self-correlations sit 1.6e-5 below 1, so compare within 1e-4 and
    # hold the dedup decisions equal (test_dedup_same_decisions)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["histogram", "coords"])
def test_dedup_same_decisions(kind):
    crops, boxes, valid = _crops_and_boxes()
    tol = DEDUP_HIST_TOL if kind == "histogram" else DEDUP_COORD_TOL
    jfn = getattr(jdedup, f"dedup_by_{kind}")
    tfn = getattr(tdedup, f"dedup_by_{kind}")
    jc, jb, jv = jfn(jnp.asarray(crops), jnp.asarray(boxes), jnp.asarray(valid), tol)
    tc, tb, tv = tfn(torch.from_numpy(crops)[None], torch.from_numpy(boxes)[None],
                     torch.from_numpy(valid)[None], tol)
    assert (~np.asarray(jv)).sum() > (~valid).sum()  # something was removed
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))


@pytest.mark.parametrize("fine", [False, True])
def test_mask_classify_matches(fine):
    tm = jmm.MeanMaskTemplates.load(os.path.join(REPO, "artifacts", "mean_masks.npz"))
    crops, _, _ = _crops_and_boxes(seed=11)
    jt, js, ja = _jit_classify(jnp.asarray(crops), jnp.asarray(tm.red),
                               jnp.asarray(tm.blue), fine_scores=fine)
    red, blue = tmm.templates_to_torch(tm, "cpu")
    tt, ts, ta = tmm.mask_correlation_classify(torch.from_numpy(crops)[None], red, blue,
                                               fine_scores=fine)
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))


def test_templates_load_and_train_match(tmp_path):
    path = os.path.join(REPO, "artifacts", "mean_masks.npz")
    jt, tt = jmm.MeanMaskTemplates.load(path), tmm.MeanMaskTemplates.load(path)
    np.testing.assert_array_equal(jt.red, tt.red)
    np.testing.assert_array_equal(jt.blue, tt.blue)
    red, blue = tmm.templates_to_torch(jt, "cpu")
    assert red.shape == (6, 625) and red.dtype == torch.float32
    np.testing.assert_array_equal(blue.numpy(), tt.blue)

    train = write_train_dir(str(tmp_path / "train"), seed=3)
    want, got = jmm.train_mean_masks(train), tmm.train_mean_masks(train, "cpu")
    np.testing.assert_array_equal(got.red, want.red)
    np.testing.assert_array_equal(got.blue, want.blue)
    assert want.red.sum() > 0 and want.blue.sum() > 0


# --- guards and wrappers -----------------------------------------------------

def test_port_imports_no_jax(tmp_path):
    """Importing the port, its CNN, recognition and scale-out modules and
    the CLIs, and running the detection CLI's CNN branch on a one-frame
    directory on the CPU (``--upscale 1.6``, and yuv420 ingest, which becomes yuv420p),
    imports neither jax nor any module of the reference package."""
    frames = str(tmp_path / "frames")
    cli = (f"['--detector', 'CNN_0.3', '--test_path', {frames!r}, '--device', 'cpu', "
           f"'--no-images', '--out', {str(tmp_path / 'r.txt')!r}")
    code = (
        "import sys; import opencv_traffic_sign_detector_tpu_torch.models.detector; "
        "import opencv_traffic_sign_detector_tpu_torch.models.cnn_quant; "
        "import opencv_traffic_sign_detector_tpu_torch.ops.fused_upscale; "
        "import opencv_traffic_sign_detector_tpu_torch.ops.yuv; "
        "import main_detection_torch, serve_detection_torch, main_recognition_torch; "
        "import evaluate_results_torch; "
        "import opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline; "
        "import opencv_traffic_sign_detector_tpu_torch.parallel.cnn; "
        "import opencv_traffic_sign_detector_tpu_torch.parallel.multihost; "
        "import opencv_traffic_sign_detector_tpu_torch.eval.device_stats; "
        "from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_test_dir; "
        f"write_test_dir({frames!r}, 1, 64, 64); "
        f"assert main_detection_torch.main({cli}, '--upscale', '1.6']) == 0; "
        f"assert main_detection_torch.main({cli}, '--input_format', 'yuv420']) == 0; "
        "assert 'jax' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith('jax')); "
        "ref = [m for m in sys.modules if m.split('.')[0] == "
        "'opencv_traffic_sign_detector_tpu']; assert not ref, ref")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cpu_tensors_never_build_or_launch():
    rt.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64), dtype=np.uint8))
    luts = clahe_cuda.tile_histograms(x).clamp(max=255).to(torch.uint8)
    clahe_cuda.clahe_apply(x, luts)
    assert rt.launch_counts() == dict.fromkeys(rt.KERNELS, 0)
    assert not rt.is_loaded()


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("a CUDA toolkit is installed at its default prefix")
    monkeypatch.setattr(rt, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(rt.KernelBuildError, match="nvcc not found"):
        rt.build()


@pytest.mark.parametrize("case", ["dtype", "rank", "tiles", "luts", "sweep_rows",
                                  "cand_cols", "window", "device", "luts_dtype",
                                  "apply_tiles", "cand_dtype", "window_zero", "keys_mask"])
def test_wrappers_reject_bad_input(case):
    u8 = torch.zeros((1, 64, 64), dtype=torch.uint8)
    params = mser_cuda.SweepParams(9, 1, 4, 50.0, 1000.0, 1.0, 0.2)
    cand = torch.zeros((3, 6), dtype=torch.int32)
    calls = {
        "dtype": lambda: clahe_cuda.tile_histograms(u8.to(torch.int32)),
        "rank": lambda: clahe_cuda.tile_histograms(u8[0]),
        "tiles": lambda: clahe_cuda.tile_histograms(torch.zeros((1, 60, 64), dtype=torch.uint8)),
        "luts": lambda: clahe_cuda.clahe_apply(u8, torch.zeros((1, 8, 8, 255), dtype=torch.uint8)),
        "sweep_rows": lambda: mser_cuda.level_sweep_windows(u8, params, 40, 8, 31, 5),
        "cand_cols": lambda: prop_cuda.flood_bbox(u8, torch.zeros((3, 5), dtype=torch.int32),
                                                  32, 32, 2, 1025),
        "window": lambda: prop_cuda.flood_bbox(u8, cand, 65, 32, 2, 1025),
        "device": lambda: clahe_cuda.tile_histograms(u8.to("meta")),
        "luts_dtype": lambda: clahe_cuda.clahe_apply(u8, torch.zeros((1, 8, 8, 256),
                                                                     dtype=torch.int32)),
        "apply_tiles": lambda: clahe_cuda.clahe_apply(
            torch.zeros((1, 60, 64), dtype=torch.uint8),
            torch.zeros((1, 8, 8, 256), dtype=torch.uint8)),
        "cand_dtype": lambda: prop_cuda.flood_bbox(u8, cand.long(), 32, 32, 2, 1025),
        "window_zero": lambda: prop_cuda.flood_bbox(u8, cand, 32, 0, 2, 1025),
        "keys_mask": lambda: prop_cuda.propagate_scan(
            torch.zeros((1, 8, 8), dtype=torch.int32), torch.zeros((1, 8, 9), dtype=torch.bool),
            65, 1),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()


def _beyond_kernel_limits(case: str):
    """A call the plain version takes and the kernel refuses, and its plain
    result."""
    rng = np.random.default_rng(1)
    if case == "flood_window":  # wider than the kernel's 128-pixel rows
        planes = torch.from_numpy(rng.integers(0, 256, (2, 200, 210), dtype=np.uint8))
        cand = torch.tensor([[0, 10, 20, 75, 70, 120], [1, -5, 90, 40, 100, 200],
                             [1, 60, 0, 0, 5, 255], [0, 0, 0, 149, 139, 30]], dtype=torch.int32)
        args = (planes, cand, 150, 140, 2, 150 * 140 + 1)
        return prop_cuda.flood_bbox, args, prop_cuda.flood_bbox_plain(*args)
    if case == "scan_plane":  # a plane larger than the kernel's shared memory
        mask = torch.from_numpy(rng.random((2, 130, 131)) < 0.7)
        mask[:, [0, -1]] = False
        mask[:, :, [0, -1]] = False
        keys = torch.from_numpy(rng.integers(0, 1000, (2, 130, 131), dtype=np.int32))
        args = (keys, mask, 1 << 20, 2)
        return prop_cuda.propagate_scan, args, prop_cuda.propagate_scan_plain(*args)
    x = torch.from_numpy(rng.integers(0, 256, (1, 64, 96), dtype=np.uint8))  # 16x16 tiles
    luts = torch.from_numpy(rng.integers(0, 256, (1, 16, 16, 256), dtype=np.uint8))
    return clahe_cuda.clahe_apply, (x, luts, 16), clahe_cuda.clahe_apply_plain(x, luts, 16)


@pytest.mark.parametrize("case", ["flood_window", "scan_plane", "apply_tiles"])
def test_kernel_limits_bind_only_the_kernel(case, monkeypatch):
    """CPU tensors beyond a kernel's limits take the plain version; tensors
    bound for the kernel are refused there, before the library is loaded."""
    fn, args, want = _beyond_kernel_limits(case)
    assert torch.equal(fn(*args), want)

    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(rt, "uses_plain", lambda *tensors: False)
    monkeypatch.setattr(rt, "library", no_library)
    with pytest.raises(ValueError, match="kernel"):
        fn(*args)


def test_k3_int16_limit_binds_only_the_kernel():
    """K3's kernel holds rows and columns as int16 and refuses windows of
    32767 columns or more; a CPU tensor of that width takes the plain
    version, which has no such limit."""
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 4, 1 << 15),
                                                           dtype=np.uint8))
    params = mser_cuda.SweepParams(9, 1, 4, 1.0, 1000.0, 1.0, 0.2)
    got = mser_cuda.level_sweep_windows(x, params, 4, 0, 3, 2)
    assert torch.equal(got, mser_cuda.level_sweep_windows_plain(x, params, 4, 0, 3, 2))
