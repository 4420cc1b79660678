"""PyTorch port vs the JAX reference: the práctica-2 CLIs.

``main_recognition_torch.py`` against ``main_recognition.py`` on a synthetic
GTSDB-style train directory (2 frames of 192x192, signs of all six
super-types) and a test directory of 1 frame, with ``--proposals MSER``
(the reference's Pallas refine through the interpreter), cut to a CPU
test's scale (:func:`_cut_scale`): the same
validation accuracy and the same ``resultado.txt`` from ``--run_test``;
``--sweep_configs`` prints the same summary rows; ``--proposals auto``
resolves as the reference does.  ``evaluate_results_torch.py`` against
``evaluate_results.py`` on a synthetic detections file: the same AP lines.
Both CLIs refuse the same bad arguments.
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

import evaluate_results
import evaluate_results_torch
import main_recognition
import main_recognition_torch
import opencv_traffic_sign_detector_tpu.config as jcfg
import opencv_traffic_sign_detector_tpu.models.recognizer as jrec
import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.models.recognizer as trec
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_gt_dir

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_PARAMS = os.path.join(REPO, "artifacts", "cnn_detector", "params.npz")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rec_cli")
    train, test = str(root / "train"), str(root / "test")
    write_gt_dir(train, 2, 192, 192, seed=6, signs_per_frame=6)
    write_gt_dir(test, 1, 192, 192, seed=8, signs_per_frame=4)
    return train, test, root


def _cut_scale(mp):
    """Both packages' CLIs at a CPU test's scale: 96 MSER regions a frame
    instead of 384, mining batches of 2 frames and test batches of 1
    instead of 8 (padded with copies of the last frame)."""
    for cfg_mod, rec_mod, cli in [(jcfg, jrec, main_recognition),
                                  (tcfg, trec, main_recognition_torch)]:
        parse = cfg_mod.MSERConfig.from_string.__func__
        mp.setattr(cfg_mod.MSERConfig, "from_string", classmethod(
            lambda cls, spec, _p=parse: dataclasses.replace(_p(cls, spec), max_regions=96)))
        mp.setattr(rec_mod, "extract_train_proposals",
                   functools.partial(rec_mod.extract_train_proposals, batch_size=2))
        mp.setattr(cfg_mod, "PipelineConfig",
                   functools.partial(cfg_mod.PipelineConfig, batch_size=1))
        if hasattr(cli, "PipelineConfig"):
            mp.setattr(cli, "PipelineConfig", functools.partial(cli.PipelineConfig, batch_size=1))


@pytest.fixture(scope="module")
def cli_runs(dirs):
    """Both CLIs train, validate and run the test set, each with its own
    proposal cache and model directory."""
    train, test, root = dirs
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TSD_PALLAS_INTERPRET", "1")
        _cut_scale(mp)
        for name, main, extra in [("ref", main_recognition.main, []),
                                  ("port", main_recognition_torch.main, ["--device", "cpu"])]:
            jax.clear_caches()
            argv = ["--train_path", train, "--test_path", test, "--proposals", "MSER",
                    "--cache", str(root / f"{name}_cache.npz"), "--model_out",
                    str(root / f"{name}_model"), "--out", str(root / f"{name}.txt"),
                    "--run_test", "--validation_pct", "0.5", *extra]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(argv) == 0
            outs[name] = buf.getvalue()
    jax.clear_caches()
    return outs


def test_run_test_writes_same_results(dirs, cli_runs):
    _, _, root = dirs
    with open(root / "ref.txt") as a, open(root / "port.txt") as b:
        ref, port = a.read(), b.read()
    assert ref == port
    assert ref.strip(), "no recognitions to compare; pick another seed"
    assert sorted(os.listdir(root / "port_model")) == sorted(os.listdir(root / "ref_model"))


def test_validation_output_equal(cli_runs):
    def report(out):
        keep = [l for l in out.splitlines()
                if not re.search(r"took|proposals:|saved|validating|detections in", l)]
        return "\n".join(keep)

    assert "validation accuracy" in cli_runs["port"]
    assert report(cli_runs["port"]) == report(cli_runs["ref"])


def test_sweep_configs_same_summary(dirs, cli_runs, capsys):
    """Both CLIs validate the four classifier configs from the port's
    proposal cache (each package reads the other's)."""
    train, _, root = dirs
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        _cut_scale(mp)
        rows = _sweep(train, root, capsys)
    assert len(rows["port"]) == 4
    assert rows["port"] == rows["ref"]


def _sweep(train, root, capsys):
    rows = {}
    for name, main, extra in [("ref", main_recognition.main, []),
                              ("port", main_recognition_torch.main, ["--device", "cpu"])]:
        assert main(["--train_path", train, "--sweep_configs", "--validation_pct", "0.5",
                     "--cache", str(root / "port_cache.npz"), *extra]) == 0
        out = capsys.readouterr().out
        rows[name] = [re.sub(r"\(.*s\)", "", l).strip() for l in
                      out.split("== summary (validation accuracy) ==")[1].splitlines() if l]
    return rows


def test_proposals_auto_default():
    ns = argparse.Namespace(proposals="auto", cnn_params="/nonexistent/params.npz")
    assert main_recognition_torch._parse_cnn_proposals(ns, "cpu") is None
    ns = argparse.Namespace(proposals="auto", cnn_params=CNN_PARAMS)
    det = main_recognition_torch._parse_cnn_proposals(ns, "cpu")
    assert det is not None and ns.proposals == "CNN"
    assert abs(det.cfg.score_threshold - 0.10) < 1e-9
    ns = argparse.Namespace(proposals="CNN_0.25", cnn_params=CNN_PARAMS)
    assert abs(main_recognition_torch._parse_cnn_proposals(ns, "cpu").cfg.score_threshold
               - 0.25) < 1e-9
    ns = argparse.Namespace(proposals="MSER", cnn_params=CNN_PARAMS)
    assert main_recognition_torch._parse_cnn_proposals(ns, "cpu") is None
    with pytest.raises(SystemExit):
        main_recognition_torch._parse_cnn_proposals(
            argparse.Namespace(proposals="SIFT", cnn_params=CNN_PARAMS), "cpu")


@pytest.mark.parametrize("argv", [["--classifier", "SIFT_PCA_SVM"],
                                  ["--detector", "MSER_0_200_2000_0.5"]])
def test_both_clis_reject_bad_spec(argv, capsys):
    assert main_recognition.main(argv) == 2
    ref = capsys.readouterr().out
    assert main_recognition_torch.main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().out == ref
    assert "Invalid spec" in ref


def test_cli_rejects_unported_and_missing_card(dirs, cli_runs, capsys):
    """``--n_devices 2 --device cpu``, once refused, fits the heads over 2
    CPU shards and prints the reference's report (``main_recognition.py
    --n_devices 2`` on 2 of its virtual devices), both from the port's
    proposal cache; without a card ``--device cuda`` exits 2."""
    train, _, root = dirs
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        _cut_scale(mp)
        for name, main, extra in [("ref", main_recognition.main, []),
                                  ("port", main_recognition_torch.main, ["--device", "cpu"])]:
            assert main(["--train_path", train, "--proposals", "MSER", "--n_devices", "2",
                         "--validation_pct", "0.5", "--cache", str(root / "port_cache.npz"),
                         "--model_out", str(root / f"{name}_mesh_model"), *extra]) == 0
            outs[name] = [ln for ln in capsys.readouterr().out.splitlines()
                          if not re.search(r"took|saved|validating", ln)]
    assert "fitting LDABAYES ... (SPMD over 2 devices)" in outs["port"]
    assert "validation accuracy" in "\n".join(outs["port"])
    assert outs["port"] == outs["ref"]
    if not torch.cuda.is_available():
        assert main_recognition_torch.main([]) == 2
        assert "torch.cuda.is_available() is false" in capsys.readouterr().out


def test_evaluate_results_same_ap(dirs, tmp_path):
    """A detections file with hits, misses, near boxes and an unmapped
    class, scored with and without the golden overlay."""
    _, test, _ = dirs
    rng = np.random.default_rng(4)
    with open(os.path.join(test, "gt.txt")) as f:
        gt = [l.split(";") for l in f.read().split()]
    lines = []
    for name, x1, y1, x2, y2, cls in gt:
        x1, y1, x2, y2 = (int(v) + int(rng.integers(-4, 5)) for v in (x1, y1, x2, y2))
        lines.append(f"{name};{x1};{y1};{x2};{y2};{cls};{rng.random():.2f}")
    lines += [f"00000.ppm;{x};{x};{x + 20};{x + 20};1;{rng.random():.2f}" for x in (3, 50, 120)]
    dets = tmp_path / "dets.txt"
    dets.write_text("\n".join(lines) + "\n")
    for flags in (["--no_golden"], []):
        outs = []
        for main in (evaluate_results.main, evaluate_results_torch.main):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(["--test_path", test, "--detections_file", str(dets), *flags]) == 0
            outs.append(buf.getvalue())
        assert outs[1] == outs[0]
        assert "AP=" in outs[0]
    draw = tmp_path / "draw"
    assert evaluate_results_torch.main(["--test_path", test, "--detections_file", str(dets),
                                        "--no_golden", "--draw_dir", str(draw)]) == 0
    assert list(draw.glob("*.png"))
