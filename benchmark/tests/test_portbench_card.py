"""On the card, at each cell's own size: the control (the precision below
the configuration's) fails the cell's limits on three seeds, and a run
through the benchmark's command is correct and names the card.

    python3 -m pytest benchmark/tests -m card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTROL_SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_three_seeds(cuda_card, name):
    cell = harness.find_cell(name)
    driver = harness.driver_class(cell)
    try:
        for seed in CONTROL_SEEDS:
            drv = driver(cell, seed, cuda_card)
            drv.setup()
            drv.window(3)
            drv.release()
            harness.free_card(cuda_card)
            readings = drv.control()
            assert any(value > cell.limits[check] for check, value in readings), (seed, readings)
    finally:
        harness.close_process_group()


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct(cuda_card, name):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           str(2**31 + 17), "--seconds", "3"], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
