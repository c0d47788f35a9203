"""Run one cell several times, one process a run, and report the spread.

    python3 benchmark/tools/series.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 20] [--trace 0] [--out <file>.jsonl]

Each run is ``benchmark/run.py`` as the benchmark's command runs it; its
exit code, wall time, result line and the end of its standard error are
appended to ``--out`` as one JSON line. At the end every metric's values
are printed with their median and spread: the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) over the
median.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out) if args.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    values: dict[str, list[float]] = {}
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        cmd = [sys.executable, "benchmark/run.py", "--workload", args.workload, "--seed",
               str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        record = {"workload": args.workload, "seed": seed, "trace": args.trace,
                  "rc": proc.returncode, "wall_s": wall, "result": result,
                  "stderr_tail": proc.stderr[-3000:]}
        if out:
            with out.open("a") as f:
                f.write(json.dumps(record) + "\n")
        if proc.returncode or result is None or not result.get("correct"):
            bad += 1
            print(f"seed {seed}: rc {proc.returncode} wall {wall:.1f}s\n{proc.stderr[-3000:]}")
            if result is None:
                continue
        metrics = {k: v["value"] for k, v in result["metrics"].items()}
        checks = {k: v["value"] for k, v in result.get("checks", {}).items()}
        for k, v in metrics.items():
            values.setdefault(k, []).append(v)
        print(f"seed {seed}: rc {proc.returncode} wall {wall:.1f}s correct {result['correct']} "
              f"peak {result['device'].get('memory_peak_bytes')} metrics {metrics} checks {checks}",
              flush=True)
    for k, vs in values.items():
        print(f"{k}: median {statistics.median(vs)!r} spread {spread(vs)!r} values {vs}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
