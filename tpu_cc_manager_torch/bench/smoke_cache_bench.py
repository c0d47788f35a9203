"""Cold-vs-warm smoke kernel-cache bench of the port: one JSON line, ok-gated.

A copy of the repository's ``hack/smoke_cache_bench.py``; each line that
differs is a seam and says so in a comment. Proves the kernel build cache
(``ops/_build.py``) holds the smoke phase down across a CC bounce as a
standalone evidence stage: the cold run starts from an empty kernel build
directory and builds its library with nvcc, the warm run reuses it from a
FRESH subprocess — exactly what a CC bounce does to the verify phase (the
runtime restart kills the process; only the disk cache survives). The
delta is the build time the cache saves. A failed preflight prints
``"ok": false`` and exits 1: there is no CPU fallback.

Usage:
  python -m tpu_cc_manager_torch.bench.smoke_cache_bench [--workload matmul] [--out FILE]

Prints exactly one JSON line (also written to --out when given) with
``ok`` true only when both runs passed, the cold run actually populated
the cache and the warm run built nothing.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", default="matmul")
    parser.add_argument("--timeout-s", type=float, default=600.0)
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)

    # Seam: the port's bench module, by its package path.
    from tpu_cc_manager_torch.bench import bench

    cuda_usable = bench._cuda_preflight()
    if not cuda_usable:
        return bench.preflight_failed("smoke_cache_cold_warm_s")
    result = bench.measure_smoke_cache(
        cuda_usable, workload=args.workload, timeout_s=args.timeout_s,
    )
    result["metric"] = "smoke_cache_cold_warm_s"
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
