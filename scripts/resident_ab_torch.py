#!/usr/bin/env python3
"""A/B of the CNN dispatch's constants on one card, in one process.

    python scripts/resident_ab_torch.py [--data_root D] [bench_torch.py flags]

Runs ``bench_torch.main`` four times, in the order A B B A, and prints each
JSON line after its label: A makes every constant and weight matrix a
dispatch needs on the card at every call (a blocking copy, so the host
waits for the card each dispatch: the code before ``ops/resident.py``), B
makes each once (``ops/resident.py``).  The bench's flags pass through;
the default is ``--model cnn --frames 32 --skip_e2e``.  ``--data_root``
points the bench at a GTSDB-style tree (``bench_torch.DET_DATA``).  The CNN
dispatches run eagerly (``CNNDetector.eager``): a graph replay makes no
constant, and A's blocking copies cannot be captured.  Without a visible
card it exits 2.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    import bench_torch
    from opencv_traffic_sign_detector_tpu_torch.models.cnn_detector import CNNDetector
    from opencv_traffic_sign_detector_tpu_torch.ops import resident as res
    from opencv_traffic_sign_detector_tpu_torch.runtime.build import missing_card

    why = missing_card("cuda")
    if why:
        print(why)
        return 2
    if "--data_root" in argv:
        i = argv.index("--data_root")
        bench_torch.DET_DATA = argv[i + 1]
        del argv[i:i + 2]
    argv = argv or ["--model", "cnn", "--frames", "32", "--skip_e2e"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    made_once = res._resident
    CNNDetector.eager = True
    try:
        for label in ("A", "B", "B", "A"):
            res._resident = made_once.__wrapped__ if label == "A" else made_once
            made_once.cache_clear()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = bench_torch.main(argv)
            if rc:
                return rc
            print(label, out.getvalue().strip(), flush=True)
    finally:
        res._resident = made_once
        CNNDetector.eager = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
