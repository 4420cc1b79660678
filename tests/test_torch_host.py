"""The port's copies of the reference's host modules give the reference's
answers: config defaults and grammar, constants, gt.txt and resultado.txt
parsing and writing, AP and detection statistics, the classification
report and confusion matrix, annotation, stage
banners, JPEG decoding (BGR, patches8, yuv420 tight and patchified) and
the decode-ahead batcher.

Each case runs the same input through the reference package's module and
the port's copy.  Everything here is exact: same values, same bytes, same
strings.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import opencv_traffic_sign_detector_tpu.config as jcfg
import opencv_traffic_sign_detector_tpu.constants as jconst
import opencv_traffic_sign_detector_tpu.data.gt as jgt
import opencv_traffic_sign_detector_tpu.data.images as jimages
import opencv_traffic_sign_detector_tpu.data.prefetch as jprefetch
import opencv_traffic_sign_detector_tpu.eval.ap as jap
import opencv_traffic_sign_detector_tpu.eval.reports as jreports
import opencv_traffic_sign_detector_tpu.eval.stats as jstats
import opencv_traffic_sign_detector_tpu.utils.annotate as jannotate
import opencv_traffic_sign_detector_tpu.utils.profiling as jprofiling
import opencv_traffic_sign_detector_tpu.utils.serialization as jser
import opencv_traffic_sign_detector_tpu.utils.stages as jstages
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.constants as tconst
import opencv_traffic_sign_detector_tpu_torch.data.gt as tgt
import opencv_traffic_sign_detector_tpu_torch.data.images as timages
import opencv_traffic_sign_detector_tpu_torch.data.prefetch as tprefetch
import opencv_traffic_sign_detector_tpu_torch.eval.ap as tap
import opencv_traffic_sign_detector_tpu_torch.eval.reports as treports
import opencv_traffic_sign_detector_tpu_torch.eval.stats as tstats
import opencv_traffic_sign_detector_tpu_torch.utils.annotate as tannotate
import opencv_traffic_sign_detector_tpu_torch.utils.profiling as tprofiling
import opencv_traffic_sign_detector_tpu_torch.utils.serialization as tser
import opencv_traffic_sign_detector_tpu_torch.utils.stages as tstages
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_test_dir
from opencv_traffic_sign_detector_tpu_torch.runtime import loader as tloader

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
DETS = os.path.join(FIXTURES, "ours_resultado_tpu_ds2.txt")


def _rows(boxes) -> list[tuple]:
    """Box records of either package as plain tuples."""
    return [dataclasses.astuple(b) for b in boxes]


# --- config and constants ----------------------------------------------------

@pytest.mark.parametrize("name", ["MSERConfig", "ClassifierConfig", "PipelineConfig"])
def test_config_defaults(name):
    assert (dataclasses.asdict(getattr(tcfg, name)())
            == dataclasses.asdict(getattr(jcfg, name)()))


@pytest.mark.parametrize("spec", ["MSER_7_200_2000_1", "MSER_5_200_3000_0.45",
                                  "MSER_40_1_20000_0.1", "MSER_0_200_2000_1",
                                  "MSER_7_300_200_1", "MSER_7_200_2000", "CNN_0.4",
                                  "MSER_7_200_2000_1.5", "MSER_x_200_2000_1"])
def test_mser_spec_grammar(spec):
    def parse(mod):
        try:
            cfg = mod.MSERConfig.from_string(spec)
        except mod.ConfigError as e:
            return "error", str(e)
        return dataclasses.asdict(cfg), cfg.to_string()

    assert parse(tcfg) == parse(jcfg)


@pytest.mark.parametrize("spec", ["HOG_LDA_BAYES", "GRAY_LDA_KNN", "HOG_PCA_KNN", "HOG_LDA"])
def test_classifier_spec_grammar(spec):
    def parse(mod):
        try:
            cfg = mod.ClassifierConfig.from_string(spec)
        except mod.ConfigError as e:
            return "error", str(e)
        return dataclasses.asdict(cfg), cfg.to_string()

    assert parse(tcfg) == parse(jcfg)


def test_config_replace_and_validation():
    for mod in (jcfg, tcfg):
        with pytest.raises(mod.ConfigError):
            dataclasses.replace(mod.MSERConfig(), min_area=3000)
    tuned = {"downscale": 2, "ccl_iters": 2, "level_step": 9, "ccl_jumps": 0}
    assert (dataclasses.asdict(dataclasses.replace(tcfg.MSERConfig(), **tuned))
            == dataclasses.asdict(dataclasses.replace(jcfg.MSERConfig(), **tuned)))


@pytest.mark.parametrize("name", sorted(n for n in vars(jconst)
                                        if n.isupper() and not n.startswith("_")))
def test_constants(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def test_supertype_of():
    assert ([tconst.supertype_of(i) for i in range(-1, 50)]
            == [jconst.supertype_of(i) for i in range(-1, 50)])


# --- classification reports ----------------------------------------------------

@pytest.mark.parametrize("case", ["random", "missing_classes", "empty", "perfect"])
def test_classification_reports(case):
    rng = np.random.default_rng(3)
    y_true = rng.integers(0, 7, 200)
    y_pred = np.where(rng.random(200) < 0.6, y_true, rng.integers(0, 7, 200))
    if case == "missing_classes":
        y_true, y_pred = y_true % 3, y_pred % 4  # some labels never true or never predicted
    elif case == "empty":
        y_true, y_pred = y_true[:0], y_pred[:0]
    elif case == "perfect":
        y_pred = y_true
    labels = list(range(7))
    names = list(jconst.SIGN_NAMES)
    np.testing.assert_array_equal(treports.confusion_matrix(y_true, y_pred, labels),
                                  jreports.confusion_matrix(y_true, y_pred, labels))
    assert (treports.classification_report(y_true, y_pred, labels, target_names=names)
            == jreports.classification_report(y_true, y_pred, labels, target_names=names))
    assert (treports.classification_report(y_true, y_pred, labels)
            == jreports.classification_report(y_true, y_pred, labels))
    assert treports.accuracy(y_true, y_pred) == jreports.accuracy(y_true, y_pred)


# --- gt.txt / resultado.txt --------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"drop_unmapped": True}, {"normalize_jpg": False}])
def test_load_ground_truth(kwargs):
    path = os.path.join(FIXTURES, "gt_test.txt")
    want = _rows(jgt.load_ground_truth(path, **kwargs))
    assert _rows(tgt.load_ground_truth(path, **kwargs)) == want and want


def test_load_results_and_group():
    want = jgt.load_results_file(DETS)
    got = tgt.load_results_file(DETS)
    assert _rows(got) == _rows(want) and len(want) > 100
    jg, tg = jgt.boxes_by_file(want), tgt.boxes_by_file(got)
    assert list(tg) == list(jg) and all(_rows(tg[k]) == _rows(jg[k]) for k in jg)


def test_write_results_file_bytes(tmp_path):
    rng = np.random.default_rng(0)
    boxes = [dict(filename=f"{i % 7:05d}.jpg", x1=int(x), y1=int(y), x2=int(x + s),
                  y2=int(y + s), class_id=int(c), score=float(sc))
             for i, (x, y, s, c, sc) in enumerate(zip(
                 rng.integers(0, 1300, 40), rng.integers(0, 740, 40),
                 rng.integers(5, 60, 40), rng.integers(1, 7, 40), rng.random(40)))]
    boxes += [dict(boxes[0], score=s) for s in (0.0, 1.0, 0.005, 0.995, 0.125, 1 / 3)]
    jser.write_results_file(str(tmp_path / "j.txt"), [jgt.GroundTruthBox(**b) for b in boxes])
    tser.write_results_file(str(tmp_path / "t.txt"), [tgt.GroundTruthBox(**b) for b in boxes])
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert (tser.detections_to_lines([tgt.GroundTruthBox(**b) for b in boxes])
            == jser.detections_to_lines([jgt.GroundTruthBox(**b) for b in boxes]))


# --- AP and statistics -------------------------------------------------------

def _synthetic_gt(path: str, seed: int) -> str:
    """A gt.txt over the fixture's frames: most detections' boxes moved by a
    few pixels under their class's raw GTSRB id, some dropped, some raw ids
    outside the six super-types (ignore regions), and missed signs."""
    rng = np.random.default_rng(seed)
    raw_of = {st: next(r for r, s in jconst.GTSRB_TO_SUPERTYPE.items() if s == st)
              for st in range(1, 7)}
    lines = []
    for d in jgt.load_results_file(DETS):
        u = rng.random()
        if u < 0.3:
            continue
        raw = 42 if u > 0.9 else raw_of[d.class_id]
        dx, dy = rng.integers(-4, 5, 2)
        lines.append(f"{d.filename[:-4]}.ppm;{d.x1 + dx};{d.y1 + dy};{d.x2 + dx};"
                     f"{d.y2 + dy};{raw}")
        if rng.random() < 0.1:
            lines.append(f"{d.filename[:-4]}.ppm;10;10;40;40;{raw_of[1 + rng.integers(0, 6)]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("gt", ["fixture", "synthetic0", "synthetic1"])
@pytest.mark.parametrize("ovr", [0.5, 0.3])
def test_score_detection_files(tmp_path, gt, ovr):
    path = (os.path.join(FIXTURES, "gt_test.txt") if gt == "fixture"
            else _synthetic_gt(str(tmp_path / "gt.txt"), int(gt[-1])))
    want = jap.score_detection_files(DETS, path, ovr)
    got = tap.score_detection_files(DETS, path, ovr)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("gt", ["fixture", "synthetic0", "synthetic1"])
@pytest.mark.parametrize("unmapped_as_type6", [True, False])
def test_detection_statistics(tmp_path, gt, unmapped_as_type6):
    path = (os.path.join(FIXTURES, "gt_test.txt") if gt == "fixture"
            else _synthetic_gt(str(tmp_path / "gt.txt"), int(gt[-1])))
    want = jstats.compute_detection_statistics(jgt.load_results_file(DETS), path,
                                               unmapped_as_type6=unmapped_as_type6)
    got = tstats.compute_detection_statistics(tgt.load_results_file(DETS), path,
                                              unmapped_as_type6=unmapped_as_type6)
    for per_file in (False, True):
        assert (tstats.format_stats_report(got, per_file)
                == jstats.format_stats_report(want, per_file))
    assert dataclasses.astuple(got.total) == dataclasses.astuple(want.total)


def test_ap_helpers():
    rng = np.random.default_rng(1)
    tp = (rng.random(50) < 0.6).astype(float)
    fp = 1.0 - tp
    for a, b in zip(tap.pr_from_tp_fp(tp, fp, 40), jap.pr_from_tp_fp(tp, fp, 40)):
        np.testing.assert_array_equal(a, b)
    assert tap.pr_from_tp_fp(tp[:0], fp[:0], 0)[2:] == jap.pr_from_tp_fp(tp[:0], fp[:0], 0)[2:]
    assert (tstats.box_match_score((1, 2, 30, 40), (3, 1, 33, 41))
            == jstats.box_match_score((1, 2, 30, 40), (3, 1, 33, 41)))
    assert math.isnan(tstats.TypeCounts().f1) and math.isnan(jstats.TypeCounts().f1)


# --- annotation, stages, profiler --------------------------------------------

def test_draw_boxes_bgr():
    img = np.random.default_rng(2).integers(0, 256, (60, 90, 3), dtype=np.uint8)
    boxes = [(5, 5, 40, 30), (-10, 50, 100, 70), (80, 2, 95, 8), (30, 40, 20, 45)]
    for thickness in (1, 3):
        np.testing.assert_array_equal(tannotate.draw_boxes_bgr(img, boxes, thickness=thickness),
                                      jannotate.draw_boxes_bgr(img, boxes, thickness=thickness))


def test_stage_banner(capsys):
    outs = []
    for mod in (jstages, tstages):
        with pytest.raises(mod.StageError) as err:
            with mod.stage("decode frames"):
                raise FileNotFoundError("no such dir")
        outs.append((capsys.readouterr().out, err.value.stage_name))
    assert outs[0] == outs[1] and "STAGE FAILED (decode frames)" in outs[0][0]


def test_stage_profiler_table():
    profs = []
    for mod in (jprofiling, tprofiling):
        prof = mod.StageProfiler()
        with prof.stage("detect", items=10):
            pass
        prof.stages["detect"].total_s = 2.0  # a fixed time: same table
        profs.append(prof.summary())
    assert profs[0] == profs[1]


# --- JPEG decoding and batching ----------------------------------------------

@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jpegs"))
    names = write_test_dir(root, 3, 64, 96, seed=4)
    return root, names


def test_port_loader_builds_under_build_dir():
    if not tloader.available():
        pytest.skip("no g++ or libjpeg: the port decodes with PIL")
    path = tloader.build()
    assert path.is_relative_to(tloader.BUILD_ROOT)
    assert not any(p.suffix == ".so" for p in tloader.SRC.parent.iterdir())


def test_load_image_bgr(jpeg_dir):
    root, names = jpeg_dir
    for n in names:
        path = os.path.join(root, n)
        np.testing.assert_array_equal(timages.load_image_bgr(path), jimages.load_image_bgr(path))
    assert timages.list_frame_files(root) == jimages.list_frame_files(root) == names


@pytest.mark.parametrize("fn", ["load_frames_batch", "load_frames_patches8_batch",
                                "load_frames_yuv420_batch",
                                "load_frames_yuv420_patches_batch"])
def test_batch_decoders(jpeg_dir, fn):
    root, names = jpeg_dir
    want = getattr(jimages, fn)(root, names)
    got = getattr(timages, fn)(root, names)
    assert (got is None) == (want is None)
    if want is not None:
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("input_format", ["bgr", "patches8", "yuv420", "yuv420p"])
def test_batched_frames(jpeg_dir, input_format):
    root, names = jpeg_dir
    want = list(jprefetch.batched_frames(root, names, 2, input_format=input_format))
    got = list(tprefetch.batched_frames(root, names, 2, input_format=input_format))
    assert [n for _, n in got] == [n for _, n in want] == [names[:2], [names[2], "__pad__"]]
    for (g, _), (w, _) in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            np.testing.assert_array_equal(a, b)
