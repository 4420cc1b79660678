"""The readings a cell's limits are set from, on a card:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... \
        --control_seeds 21,22,23 --seconds 3 --out control.json

For each seed of ``--seeds`` the program runs a window of ``--seconds``
through the harness's own loop, and its records are compared with the
plain reference (the lower readings).  For each of ``--control_seeds`` the
control takes the program's place: the reference itself with TF32 on for
its float32 products, over every batch of the pool (the upper readings).
One process, one program: a seed changes only the frames.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from benchmark.traffic import make_pool  # noqa: E402


def readings(name: str, seeds: list[int], control_seeds: list[int], seconds: float,
             device: str = "cuda", traffic: dict | None = None) -> dict:
    """{"program": [{seed, numbers, failed, batches}], "control": [...]}."""
    c = harness.cell(name)
    config, mix = c["config_data"], traffic or c["traffic_data"]
    drv = harness.driver(config["family"])
    reference = drv.Reference(config, mix, device)
    out = {"cell": name, "program": [], "control": []}

    def judge(kind, seed, tally, refs):
        nums, failed = drv.numbers(config, mix, tally.frames, refs)
        out[kind].append({"seed": seed, "numbers": nums, "failed": failed,
                          "batches": tally.batches})
        print(f"[{kind}] {name} seed {seed}: {nums} failed frames {failed} "
              f"of {tally.batches * mix['batch']}", flush=True)

    prog = drv.Program(config, mix, device)
    for seed in seeds:
        pool = make_pool(mix, seed)
        harness.closed_loop(prog, pool, harness.Tally(), n=len(pool))
        tally = harness.Tally()
        harness.closed_loop(prog, pool, tally, seconds=seconds)
        judge("program", seed, tally, {k: reference.records(pool[k])
                                       for k in tally.pool_batches()})
    prog.close()
    lower = drv.Reference(config, mix, device, control=True)
    for seed in control_seeds:
        pool = make_pool(mix, seed)
        tally = harness.Tally()
        for k in range(len(pool)):
            tally.add(k, lower.records(pool[k]))
        judge("control", seed, tally, {k: reference.records(pool[k])
                                       for k in range(len(pool))})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                   [int(s) for s in args.control_seeds.split(",")], args.seconds)
    for kind in ("program", "control"):
        for key in out[kind][0]["numbers"] if out[kind] else []:
            vals = [r["numbers"][key] for r in out[kind]]
            print(f"[{kind} {key}] min {min(vals)!r} max {max(vals)!r} over {len(vals)} seeds")
    print(f"[control] {time.perf_counter() - t0:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
