"""Run one cell of the port's benchmark and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``tpu_cc_manager_torch``),
on a machine with the CUDA cards the cell asks for. Set-up time is counted
from the start of this script. Kernel libraries build into the checkout's
``build/`` and are found there by the next run.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Every cache of the program inside the checkout, at fixed paths.
os.environ["TPU_CC_CACHE_DIR"] = str(ROOT / "build")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
# Keep libraries that could load JAX on their own from doing so.
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
