"""A whole run at a tiny size on the CPU, past the harness's look for a
card: sound, it is correct; with the timed path broken underneath by each
fault its cell can have, ``correct`` comes out false. The tiny model runs
in float32, so its sound gaps sit far under the cells' own limits."""

from __future__ import annotations

import io
import json
import time

import pytest
import torch
from conftest import tiny_cell

from benchmark import faults, harness

TRAIN = "smollm2-1.7b.train-16x512"
TRAIN_LONG = "smollm2-1.7b.train-1x8192"
PREFILL = "mistral-7b-v0.3.prefill-4x4096"
SEED = 2**31 + 7


def run(cell, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, SEED, 0.3, trace, torch.device("cpu"), time.perf_counter(),
                     out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return result


@pytest.mark.parametrize("name, batch", [(TRAIN, 2), (TRAIN_LONG, 1), (PREFILL, 2)])
def test_sound_runs_are_correct(name, batch):
    result = run(tiny_cell(name, batch=batch))
    assert result["correct"] and result["failed"] == 0
    reported = {m["name"] for m in harness.find_cell(name).end_to_end}
    assert set(result["metrics"]) == reported
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_traced_runs_are_correct_and_carry_a_breakdown(name):
    result = run(tiny_cell(name), trace=True)
    assert result["correct"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["attempted"] == harness.find_cell(name).traffic.get(
        "trace_steps", harness.find_cell(name).traffic.get("trace_passes"))


@pytest.mark.parametrize("name, batch, fault", [
    *[(TRAIN, 2, f) for f in faults.TRAIN],
    *[(TRAIN_LONG, 1, f) for f in faults.TRAIN],
    *[(PREFILL, 2, f) for f in faults.PREFILL],
])
def test_each_fault_makes_the_run_incorrect(name, batch, fault):
    cell = tiny_cell(name, batch=batch)
    with faults.plant(cell.traffic["driver"], fault):
        result = run(cell)
    assert not result["correct"], result["checks"]


def test_a_step_that_goes_stale_after_set_up_fails_only_the_window_numbers():
    """Set-up's steps are sound, so only the step after the window can show it."""
    cell = tiny_cell(TRAIN)
    with faults.plant("train", "stale_after_warmup"):
        checks = run(cell)["checks"]
    over = {name for name, c in checks.items() if c["value"] > c["limit"]}
    assert over == {"window_change_gap"}, checks


@pytest.mark.parametrize("name", [TRAIN, TRAIN_LONG])
def test_the_control_fails_the_limits(name):
    """bf16 master weights leave the norm scales unmoved (an update of
    lr is under half a bf16 step at 1), in set-up's steps and in the step
    after the window. The prefill control is held at the
    cell's own size on the card (test_portbench_card.py)."""
    cell = tiny_cell(name, batch=1 if name == TRAIN_LONG else 2)
    drv = harness.driver_class(cell)(cell, SEED, torch.device("cpu"))
    drv.setup()
    drv.window(0.3)
    drv.release()
    readings = dict(drv.control())
    assert set(readings) == set(cell.limits)
    for after in (False, True):
        assert any(value > cell.limits[check] for check, value in readings.items()
                   if check.startswith("window_") == after), readings


def test_the_launch_counters_start_after_the_profilers_warm_up(tmp_path):
    """``warmed`` runs once the untraced warm-up step has ended and before
    the first traced one, so what it resets covers the traced steps alone."""
    from benchmark import devtrace

    order = []
    devtrace.capture(lambda i: order.append(i), 3, tmp_path / "trace.json", lambda: None,
                     lambda: order.append("warmed"))
    assert order == [0, "warmed", 1, 2, 3]
