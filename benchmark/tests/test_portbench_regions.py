"""``regions.py``: every device operation of a traced stretch put down to the
program region that caused it, on a small hand-written Chrome trace; and on
the card, the regions of a traced run of each cell.

    python3 -m pytest benchmark/tests -m card
"""

from __future__ import annotations

import io
import json
import re

import pytest

from benchmark import devtrace, harness, regions

MAIN, AUTOGRAD = 1, 2
NODE = regions.NODE


def region(tid, ts, dur, name):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts, "dur": dur}


def cpu_op(tid, ts, dur, name):
    return {"ph": "X", "cat": "cpu_op", "name": name, "tid": tid, "ts": ts, "dur": dur}


def launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def kernel(ts, dur, corr, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def flow(ph, flow_id, tid, ts):
    return {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": flow_id, "tid": tid, "ts": ts}


# One step: a forward on the main thread with layer regions, a backward on
# the autograd thread (four nodes with their forward ops, one without, one
# whose hook opens a region of its own, and a callback after the last node),
# and launches before and after.
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "tid": MAIN, "ts": 0,
     "dur": 1000},
    region(MAIN, 5, 140, "train.forward"),
    region(MAIN, 10, 30, "llama.attention"),
    region(MAIN, 40, 30, "llama.mlp"),
    region(MAIN, 42, 10, "llama.layer_weights"),
    region(MAIN, 45, 4, "bench.forward"),  # a harness span, not a region
    cpu_op(MAIN, 15, 5, "_FlashAttention"), flow("s", 1, MAIN, 15),
    cpu_op(MAIN, 44, 2, "aten::select"), flow("s", 2, MAIN, 44),
    cpu_op(MAIN, 60, 3, "aten::mm"), flow("s", 3, MAIN, 60),
    cpu_op(MAIN, 130, 3, "aten::add"), flow("s", 4, MAIN, 130),  # no region inside forward
    launch(MAIN, 20, 101),  # llama.attention
    launch(MAIN, 46, 102),  # llama.layer_weights, innermost
    launch(MAIN, 61, 103),  # llama.mlp
    launch(MAIN, 100, 104),  # train.forward
    region(MAIN, 150, 400, "train.backward"),
    cpu_op(AUTOGRAD, 200, 20, NODE + "_FlashAttentionBackward"),
    cpu_op(AUTOGRAD, 201, 18, "_FlashAttentionBackward"), flow("f", 1, AUTOGRAD, 201),
    launch(AUTOGRAD, 205, 105), launch(AUTOGRAD, 210, 106),  # K3, K4: llama.attention
    cpu_op(AUTOGRAD, 230, 20, NODE + "SelectBackward0"),
    cpu_op(AUTOGRAD, 231, 18, "SelectBackward0"), flow("f", 2, AUTOGRAD, 231),
    launch(AUTOGRAD, 235, 107),  # its full-size zero: llama.layer_weights
    cpu_op(AUTOGRAD, 260, 20, NODE + "MmBackward0"),
    cpu_op(AUTOGRAD, 261, 18, "MmBackward0"), flow("f", 3, AUTOGRAD, 261),
    launch(AUTOGRAD, 265, 108),  # llama.mlp
    cpu_op(AUTOGRAD, 290, 20, NODE + "AddBackward0"),
    cpu_op(AUTOGRAD, 291, 18, "AddBackward0"), flow("f", 4, AUTOGRAD, 291),
    launch(AUTOGRAD, 295, 109),  # forward op outside regions but train.forward: train.forward
    cpu_op(AUTOGRAD, 320, 20, NODE + "torch::autograd::AccumulateGrad"),
    launch(AUTOGRAD, 325, 110),  # no forward op: open at the launch, another thread
    cpu_op(AUTOGRAD, 350, 40, NODE + "PostBackwardFunctionBackward"),
    region(AUTOGRAD, 355, 30, "FSDP::post_backward_reduce"),
    launch(AUTOGRAD, 360, 111),  # a region opened inside the node wins
    region(AUTOGRAD, 500, 20, "FSDP::root_post_backward_callback"),
    launch(AUTOGRAD, 505, 113),  # after the last node: backward all the same
    launch(MAIN, 700, 112),  # no region open anywhere
    # kernels, in launch order; an idle gap of 200 before the one of 111
    kernel(30, 10, 101, "flash_fwd_sm90_kernel"),
    kernel(50, 5, 102, "FillFunctor", cat="gpu_memset"),
    kernel(70, 20, 103, "nvjet_gemm"),
    kernel(110, 10, 104),
    kernel(220, 8, 105, "flash_bwd_dq_sm90_kernel"),
    kernel(228, 12, 106, "flash_bwd_dkv_sm90_kernel"),
    kernel(240, 30, 107, "CUDAFunctor_add"),
    kernel(270, 20, 108, "nvjet_gemm"),
    kernel(300, 4, 109),
    kernel(330, 2, 110, "Memcpy DtoD", cat="gpu_memcpy"),
    kernel(532, 8, 111, "ncclKernel"),
    kernel(545, 5, 113, "CatArrayBatchedCopy"),
    kernel(710, 6, 112),
    kernel(716, 3, 999),  # its launch is not in the trace
]

WANT = {  # correlation id -> (region, launched in a backward node)
    101: ("llama.attention", False), 102: ("llama.layer_weights", False),
    103: ("llama.mlp", False), 104: ("train.forward", False),
    105: ("llama.attention", True), 106: ("llama.attention", True),
    107: ("llama.layer_weights", True), 108: ("llama.mlp", True),
    109: ("train.forward", True), 110: ("train.backward", True),
    111: ("FSDP::post_backward_reduce", True), 112: (regions.UNATTRIBUTED, False),
    113: ("FSDP::root_post_backward_callback", True),
    999: (regions.UNATTRIBUTED, False),
}


def assigned(steps: int = 1) -> regions.Regions:
    return regions.assign(EVENTS, steps, 0.0)


@pytest.mark.parametrize("corr", sorted(WANT))
def test_each_operation_goes_to_its_region(corr):
    starts = {e["args"]["correlation"]: e["ts"] for e in EVENTS
              if e.get("cat") in devtrace.DEVICE_CATEGORIES}
    (op,) = [op for op in assigned().ops if op.start_us == starts[corr]]
    assert (op.region, op.backward) == WANT[corr]


def test_self_times_and_unattributed_sum_to_the_total():
    found = assigned(steps=2)
    table = found.table()
    assert sum(r["ms"] for r in table) == pytest.approx(found.total_ms(), rel=1e-12)
    total_us = sum(e["dur"] for e in EVENTS if e.get("cat") in devtrace.DEVICE_CATEGORIES)
    assert found.total_ms() == pytest.approx(total_us / 1e3 / 2)
    attention = next(r for r in table if r["region"] == "llama.attention")
    assert (attention["forward_ms"], attention["backward_ms"], attention["launches"]) == (
        pytest.approx(10 / 1e3 / 2), pytest.approx(20 / 1e3 / 2), 1.5)
    assert found.self_ms(regions.UNATTRIBUTED) == pytest.approx(9 / 1e3 / 2)
    assert found.self_ms("llama.rope") is None


def test_idle_gaps_go_to_the_region_of_the_operation_that_ends_them():
    gaps = dict(assigned().gaps)
    # the stretch starts at 0: 30 us before the first kernel
    assert gaps["llama.attention"] == pytest.approx(30e-6)
    assert gaps["FSDP::post_backward_reduce"] == pytest.approx(200e-6)
    assert assigned().gaps[0][0] == "FSDP::post_backward_reduce"
    assert gaps[regions.UNATTRIBUTED] == pytest.approx(160e-6)


class Reading:
    def __init__(self, trace, steps=1):
        self.trace, self.facts = trace, {"steps": steps}


def write(tmp_path, events=EVENTS):
    path = tmp_path / "cell.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_a_run_reads_its_own_trace_once_and_prints_the_table(tmp_path, monkeypatch):
    path = write(tmp_path)
    reading = Reading(devtrace.parse(EVENTS, 0.001))
    err = io.StringIO()
    monkeypatch.setattr(regions.sys, "stderr", err)
    monkeypatch.setattr(regions, "TRACES", tmp_path)
    assert regions.region_ms(reading, "llama.mlp") == pytest.approx(40 / 1e3)
    path.unlink()  # a second reader of the run reads the same parse
    assert regions.region_ms(reading, "llama.attention") == pytest.approx(30 / 1e3)
    assert regions.region_ms(reading, "llama.norm") is None
    printed = err.getvalue()
    assert printed.count("regions: device ms a step") == 1
    assert "llama.layer_weights" in printed and "unattributed share" in printed


@pytest.mark.parametrize("change", ["one op fewer", "another first start", "another last start"])
def test_a_trace_that_is_not_the_runs_is_refused(tmp_path, change):
    trace = devtrace.parse(EVENTS, 0.001)
    ops = list(trace.ops)
    if change == "one op fewer":
        ops = ops[:-1]
    else:
        k = 0 if change == "another first start" else -1
        ops[k] = devtrace.DeviceOp(ops[k].name, ops[k].start_us + 1, ops[k].dur_us, ops[k].span)
    other = devtrace.Trace(ops, trace.window_s, trace.start_us)
    with pytest.raises(RuntimeError, match="not this run's trace"):
        regions.of(Reading(other), write(tmp_path))


def test_a_program_without_regions_reads_nothing(tmp_path):
    bare = [e for e in EVENTS if not (e.get("cat") == "user_annotation"
                                      and e["name"].startswith(regions.PREFIXES))]
    reading = Reading(devtrace.parse(bare, 0.001))
    found = regions.of(reading, write(tmp_path, bare))
    assert [r["region"] for r in found.table()] == [regions.UNATTRIBUTED]
    assert regions.region_ms(reading, "llama.attention") is None


# K2-K4's kernels, either variant (``sm90`` or ``simt``).
FLASH = {"K2": re.compile(r"flash_fwd_(sm90_)?kernel"),
         "K3": re.compile(r"flash_bwd_dq_(sm90_)?kernel"),
         "K4": re.compile(r"flash_bwd_dkv_(sm90_)?kernel")}


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_traced_run_puts_its_kernels_down_to_their_regions(cuda_card, name, tmp_path):
    """At the cell's own size: K2-K4 launches in ``llama.attention`` equal the
    program's launch counters over the stretch, every operation of a
    ``SelectBackward0`` node lands in ``llama.layer_weights``, and the named
    regions hold at least 95% of the device time."""
    cell = harness.find_cell(name)
    drv = harness.driver_class(cell)(cell, 2**31 + 29, cuda_card)
    path = tmp_path / f"{name}.json"
    try:
        drv.setup()
        trace, facts = drv.traced(path)
        found = regions.of(harness.Reading(trace, facts, None), path)
    finally:
        drv.release()
        harness.free_card(cuda_card)
        harness.close_process_group()
    for k, by_variant in facts["launches"].items():
        got = sum(1 for op in found.ops
                  if op.region == "llama.attention" and FLASH[k].search(op.name))
        anywhere = sum(1 for op in found.ops if FLASH[k].search(op.name))
        assert got == anywhere == sum(by_variant.values()) > 0, (k, got, anywhere, by_variant)
    select = [op for op in found.ops if op.node == "SelectBackward0"]
    assert {op.region for op in select} == ({"llama.layer_weights"} if "train" in name else set())
    left = found.self_ms(regions.UNATTRIBUTED) or 0.0
    assert left <= 0.05 * found.total_ms(), found.table()
