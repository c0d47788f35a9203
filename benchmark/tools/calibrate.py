"""Readings that a cell's limits are set from, in one process: the
program's sound runs on many seeds, the control's, and a planted fault's.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--faults half_batch,... --fault-seeds 4,5,6] \\
        [--seconds 3] [--out <file>.jsonl]

A sound or faulty reading runs the cell's driver through set-up, a short
window at the cell's own load (``--seconds``), and the check, exactly as a
run does; the control is the driver's ``control`` after such a run. One
JSON line per reading goes to ``--out`` and to standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def seeds(text: str | None) -> list[int]:
    return [int(s) for s in text.split(",")] if text else []


def main(argv=None) -> int:
    import os

    os.environ["TPU_CC_CACHE_DIR"] = str(ROOT / "build")
    import torch

    from benchmark import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="comma-separated names of faults.py")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    driver = harness.driver_class(cell)

    def emit(kind, seed, checks, failed=0):
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed, "failed": failed,
                           "checks": dict(checks)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def program(seed):
        drv = driver(cell, seed, device)
        drv.setup()
        drv.window(args.seconds)
        drv.release()
        harness.free_card(device)
        return drv

    def sound(seed, planted=None):
        ctx = faults.plant(cell.traffic["driver"], planted) if planted else contextlib.nullcontext()
        with ctx:
            checks, failed = program(seed).check()
        emit(planted or "program", seed, checks, failed)

    for seed in seeds(args.seeds):
        sound(seed)
    for seed in seeds(args.control_seeds):
        emit("control", seed, program(seed).control())
    for fault in filter(None, args.faults.split(",")):
        for seed in seeds(args.fault_seeds):
            sound(seed, fault)
    harness.close_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
