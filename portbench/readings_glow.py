"""The readings that the limits of ``correct`` in a Glow cell are set
from, on the card, at the cell's own size, many seeds in one process:

    python3 portbench/readings_glow.py --workload <cell> --seeds 1 2 3 ... \\
        [--control 4 5 6] [--out readings.jsonl]

For each ``--seeds`` seed: the program's numbers, as a run computes them
(set-up, the init and the checked first steps through the program's loop,
no window), against the f32 reference. For each ``--control`` seed also:
the control (the reference with its bf16 operands rounded to fp8, init and
steps, in the program's place) and each fault of ``faults_glow`` planted
in the program. A state left unchanged reads ``change_gap`` 1 and needs no
run. One JSON line per seed and kind (``drivers/train_stream.readings``).
"""
import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from portbench import faults_glow, harness, readings  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = harness.find_cell(args.workload)
    dev = torch.device("cuda", 0)
    drv = cell.module("drivers", cell.traffic["driver"])
    for seed in args.seeds + [s for s in args.control
                              if s not in args.seeds]:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, 0.0, False, dev, t0)
        for kind, vals in drv.readings(ctx, seed in args.control,
                                       faults_glow.FAULTS):
            readings._emit(args.out, {"workload": cell.name, "seed": seed,
                                      "kind": kind, **vals,
                                      "s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
