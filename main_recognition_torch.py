#!/usr/bin/env python3
"""Práctica-2 CLI on the PyTorch/CUDA port: train + validate the
traffic-sign recognizer.

Same grammar and outputs as ``main_recognition.py`` (every flag:
``--proposals auto|MSER|CNN[_thr]``, ``--sweep_configs``, ``--run_test``,
``--rec_grows``, ``--proposal_positives``, ``--confusion_plot``), plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain PyTorch
versions; with no card and no ``--device cpu`` it exits 2):

    python main_recognition_torch.py --detector MSER_7_200_2000_1 \
        --classifier HOG_LDA_BAYES --train_path train_jpg [--run_test]

Builds the training set (GT positives + mined negatives, proposal cache on
disk, readable by either package), trains the classifier, runs the 10%
held-out validation, prints the confusion matrix and classification report,
and saves the model (a directory either package loads).  ``--n_devices``
above 1 fits the LDABAYES heads over a mesh of that many shards of
``--device`` (cards, or shards run in turn on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from opencv_traffic_sign_detector_tpu_torch.config import (
    ClassifierConfig,
    ConfigError,
    MSERConfig,
    PipelineConfig,
)
from opencv_traffic_sign_detector_tpu_torch.constants import SIGN_NAMES
from opencv_traffic_sign_detector_tpu_torch.models.recognizer import run_validation
from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card
from opencv_traffic_sign_detector_tpu_torch.utils.stages import StageError, stage


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Trains a classifier on train data and validates it")
    parser.add_argument("--train_path", type=str, default="./train_jpg")
    parser.add_argument("--test_path", type=str, default="./test_alumnos_jpg")
    parser.add_argument("--detector", type=str, default="MSER_7_200_2000_1")
    parser.add_argument("--classifier", type=str, default="HOG_LDA_BAYES")
    parser.add_argument("--validation_pct", type=float, default=0.1)
    parser.add_argument("--no_sign_tol", type=float, default=0.5)
    parser.add_argument("--cache", default="mser_proposals_cache.npz",
                        help="proposal cache artifact (replaces MSERTrain.val)")
    parser.add_argument("--model_out", default="sign_classifier",
                        help="directory to save the trained model")
    parser.add_argument("--limit", type=int, default=None,
                        help="limit training frames (debugging)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda launches the CUDA kernels, "
                             "cpu runs their plain PyTorch versions")
    parser.add_argument("--run_test", action="store_true",
                        help="after training, run the recognizer over "
                             "test_path and write resultado.txt")
    parser.add_argument("--out", default="resultado.txt")
    parser.add_argument("--confusion_plot", default=None,
                        help="write the validation confusion matrix PNG here")
    parser.add_argument("--downscale", type=int, default=1,
                        help="MSER-stage downscale for negative mining "
                             "(2 = fast mode)")
    parser.add_argument("--sweep_configs", action="store_true",
                        help="validate all four classifier configs "
                             "(HOG/GRAY x LDABAYES/KNN) and print an "
                             "accuracy summary")
    parser.add_argument("--rec_grows", default="1.15",
                        help="comma list of proposal grow factors; the "
                             "union of grown proposal sets is classified "
                             "(reference: single 1.15)")
    parser.add_argument("--proposal_positives", action="store_true",
                        help="also label train-set proposals with IoU>0.5 "
                             "vs GT as positives of that class")
    parser.add_argument("--proposals", default="auto",
                        help="proposal source: CNN[_<thr>] (the detector's "
                             "low-threshold boxes, default thr 0.10) or MSER "
                             "(the reference-parity source); 'auto' = CNN if "
                             "--cnn_params exists, else MSER")
    parser.add_argument("--cnn_params", default="artifacts/cnn_detector/params.npz",
                        help="CNN weights for --proposals CNN")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="fit the classifier over an N-device mesh of "
                             "--device (SPMD statistics fit)")
    args = parser.parse_args(argv)

    try:
        mser = MSERConfig.from_string(args.detector)
        clf_cfg = ClassifierConfig.from_string(args.classifier)
    except ConfigError as e:
        print(f"Invalid spec: {e}")
        return 2
    why = missing_card(args.device)
    if why:
        print(why)
        return 2
    if args.downscale > 1:
        # recognition mining favours proposal coverage over sweep speed:
        # auto level step + iters 8
        mser = dataclasses.replace(mser, downscale=args.downscale, ccl_iters=8, ccl_jumps=0)

    try:
        return _run(args, mser, clf_cfg)
    except StageError:
        return 1


def _parse_cnn_proposals(args, device="cuda"):
    """--proposals CNN[_thr] -> a loaded CNNDetector at that threshold on
    ``device`` (None when the source is MSER).  "auto" resolves to CNN
    when the weights exist."""
    spec = args.proposals.upper()
    if spec == "AUTO":
        if os.path.exists(args.cnn_params):
            spec = "CNN"
            args.proposals = "CNN"
        else:
            print("note: CNN weights not found at "
                  f"{args.cnn_params}; falling back to --proposals MSER")
            return None
    if not spec.startswith("CNN"):
        if spec != "MSER":
            raise SystemExit(f"Invalid --proposals spec: {args.proposals!r} "
                             "(MSER or CNN[_<thr>])")
        return None
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import CNNDetector

    parts = args.proposals.split("_")
    thr = float(parts[1]) if len(parts) == 2 and parts[1] else 0.10
    det = CNNDetector.load(args.cnn_params, device=device)
    det.cfg = dataclasses.replace(det.cfg, score_threshold=thr)
    return det


def _grows(args) -> tuple[float, ...]:
    return tuple(float(g) for g in args.rec_grows.split(","))


def _run(args, mser, clf_cfg) -> int:
    if args.sweep_configs:
        return _run_sweep(args, mser)
    print(f"validating {clf_cfg.to_string()} with detector {mser.to_string()} "
          f"on {args.device}")
    t0 = time.time()
    mesh = None
    if args.n_devices > 1:
        from opencv_traffic_sign_detector_tpu_torch.parallel.mesh import data_mesh

        try:
            mesh = data_mesh(args.n_devices, device=args.device)
        except ValueError as e:
            print(e)
            return 2
    cnn_det = _parse_cnn_proposals(args, args.device)
    proposals = None
    if cnn_det is not None:
        from opencv_traffic_sign_detector_tpu_torch.models.recognizer import (
            extract_train_proposals_cnn,
        )

        with stage("mine CNN proposals over the train set"):
            proposals = extract_train_proposals_cnn(
                args.train_path.replace("\\", "/"), cnn_det,
                cache_path=args.cache, limit=args.limit)
        n_props = sum(len(b) for b, _ in proposals.values())
        print(f"{n_props} CNN proposals at thr {cnn_det.cfg.score_threshold:g}")
    with stage("train + validate classifier"):
        result = run_validation(
            args.train_path.replace("\\", "/"),
            mser_cfg=mser,
            clf_cfg=clf_cfg,
            validation_pct=args.validation_pct,
            no_sign_tol=args.no_sign_tol,
            cache_path=args.cache,
            limit=args.limit,
            seed=args.seed,
            verbose=True,
            mesh=mesh,
            # CNN proposals are only useful with matched-distribution
            # positives, so they imply the flag
            proposal_positives=args.proposal_positives or cnn_det is not None,
            grows=_grows(args),
            proposals=proposals,
            device=args.device,
        )
    print(f"\ntraining + validation took {time.time() - t0:.1f}s")
    print("\nconfusion matrix (rows = true, cols = predicted):")
    header = " ".join(f"{n[:6]:>7}" for n in SIGN_NAMES)
    print(f"{'':>15}{header}")
    for i, row in enumerate(result.confusion):
        print(f"{SIGN_NAMES[i]:>15}" + " ".join(f"{v:7d}" for v in row))
    print("\n" + result.report)
    print(f"\nvalidation accuracy: {result.accuracy:.4f}")

    if args.confusion_plot:
        _write_confusion_plot(args, result)

    with stage("save trained model"):
        result.classifier.save(args.model_out)
        print(f"model saved to {args.model_out}/")

    if args.run_test:
        with stage("recognizer test-set inference"):
            _run_test(args, mser, result, cnn_det)
    return 0


def _run_sweep(args, mser) -> int:
    """Validate every classifier config (the reference's commented-out
    multi-config loop, `Reconocimiento de Objetos/main.py:96-103`)."""
    rows = []
    for spec in ("HOG_LDA_BAYES", "HOG_LDA_KNN", "GRAY_LDA_BAYES", "GRAY_LDA_KNN"):
        cfg = ClassifierConfig.from_string(spec)
        print(f"\n=== {spec} ===")
        t0 = time.time()
        with stage(f"train + validate {spec}"):
            result = run_validation(
                args.train_path.replace("\\", "/"),
                mser_cfg=mser,
                clf_cfg=cfg,
                validation_pct=args.validation_pct,
                no_sign_tol=args.no_sign_tol,
                cache_path=args.cache,  # proposal cache shared across configs
                limit=args.limit,
                seed=args.seed,
                verbose=False,
                proposal_positives=args.proposal_positives,
                grows=_grows(args),
                device=args.device,
            )
        rows.append((spec, result.accuracy, time.time() - t0))
        print(result.report)
    print("\n== summary (validation accuracy) ==")
    for spec, acc, dt in rows:
        print(f"  {spec:<16} {acc:.4f}  ({dt:.1f}s)")
    return 0


def _write_confusion_plot(args, result) -> None:
    import matplotlib  # imported here: hosts without matplotlib run the rest

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(result.confusion, cmap="Blues")
    ax.set_xticks(range(len(SIGN_NAMES)))
    ax.set_yticks(range(len(SIGN_NAMES)))
    ax.set_xticklabels(SIGN_NAMES, rotation=45, ha="right")
    ax.set_yticklabels(SIGN_NAMES)
    ax.set_xlabel("Predicted label")
    ax.set_ylabel("True label")
    for i in range(result.confusion.shape[0]):
        for j in range(result.confusion.shape[1]):
            ax.text(j, i, str(result.confusion[i, j]), ha="center", va="center", fontsize=8)
    ax.set_title(f"clasificador {args.classifier}")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(args.confusion_plot, dpi=120)
    print(f"confusion matrix plot saved to {args.confusion_plot}")


def _run_test(args, mser, result, cnn_det=None) -> None:
    from opencv_traffic_sign_detector_tpu_torch.models.rec_pipeline import RecognitionPipeline
    from opencv_traffic_sign_detector_tpu_torch.utils.serialization import write_results_file

    test_path = args.test_path.replace("\\", "/")
    src = "CNN proposals" if cnn_det is not None else "MSER proposals"
    print(f"\nrunning recognizer over {test_path} ({src}) ...")
    pipe = RecognitionPipeline(
        cfg=PipelineConfig(mser=mser, no_sign_tol=args.no_sign_tol, rec_grows=_grows(args)),
        classifier=result.classifier,
        cnn=cnn_det,
        device=args.device,
    )
    t0 = time.time()
    dets = pipe.run_directory(test_path, progress=True)
    print(f"{len(dets)} detections in {time.time() - t0:.1f}s; writing {args.out}")
    write_results_file(args.out, dets)


if __name__ == "__main__":
    sys.exit(main())
