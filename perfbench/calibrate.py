"""The readings that each cell's limits are set from, on the card at the
cell's own size: the program's numbers on many seeds, the control's (the
reference in float8 in the program's place) and each planted fault's.
The benchmark's own runs never run this.

    python perfbench/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --fault-seeds 3 [--first-seed N] [--out FILE]

One process reads every seed: set-up is paid once for the build and
cuDNN's search.  Prints one JSON line a reading, and the largest and
smallest of each kind at the end."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run as entry
    entry._environment()
    import torch
    from perfbench.lib import faults, harness
    cell = harness.Cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = bool(
        cell.workload.get("cudnn_benchmark", False))
    drv = cell.driver
    out = open(args.out, "a") if args.out else None
    seeds = [args.first_seed + 7919 * i for i in range(
        max(args.seeds, args.control_seeds, args.fault_seeds))]
    summary: dict = {}

    def emit(kind, seed, gaps, extra=None):
        line = {"cell": args.workload, "kind": kind, "seed": seed,
                "gaps": gaps, **(extra or {})}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for k, v in gaps.items():
            lo, hi = summary.setdefault(kind, {}).get(k, (v, v))
            summary[kind][k] = (min(lo, v), max(hi, v))

    def program(seed):
        t0 = time.perf_counter()
        prog = drv.Run(cell.config, cell.workload, seed, dev)
        prog.finish()
        return prog, time.perf_counter() - t0

    for i, seed in enumerate(seeds):
        prog, setup = program(seed)
        t0 = time.perf_counter()
        want = prog.reference_readings()
        ref_s = time.perf_counter() - t0
        if i < args.seeds:
            emit("program", seed, drv.gaps(prog.program_readings(), want),
                 {"setup_s": setup, "reference_s": ref_s,
                  "readings": prog.program_readings(), "reference": want})
        if i < args.control_seeds:
            emit("control", seed, drv.gaps(prog.control_readings(), want))
        if i < args.fault_seeds:
            for name in faults.FAULTS:
                with faults.planted(name):
                    bad, _ = program(seed)
                emit(f"fault.{name}", seed,
                     drv.gaps(bad.program_readings(), want))
        del prog
    for kind, nums in summary.items():
        print(json.dumps({"summary": kind, **{k: list(v) for k, v in
                                              nums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
