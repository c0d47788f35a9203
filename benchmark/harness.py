"""One run of one cell: set-up, the measured window (or, with ``trace``, a
traced stretch), the check against the reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix (``traffic/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``, a class ``Driver``); the cell's limits are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``'s ``read(reading)``. A later cell, mix, driver or
metric is a file added beside these, and no file here changes for it.

A driver has ``setup()``, ``window(seconds)``, ``traced(path)``,
``release()`` and ``check()``, and ``control()``: the control's readings
after a run, which the card tests and ``tools/calibrate.py`` take and a
run does not; see ``drivers/train.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
# Compared with the whole top-level name of every loaded module: the port,
# tpu_cc_manager_torch, shares a prefix with the JAX package and passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_cc_manager")


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among the module names ``names``."""
    return sorted({name.partition(".")[0] for name in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # limits/<cell>.json: check name -> limit
    end_to_end: list[dict]  # BENCHMARK.json's entries the cell reports
    per_layer: list[dict]


def phase(label: str, since: float) -> float:
    """Print ``label`` and the seconds since ``since`` on standard error;
    return the time now."""
    now = time.perf_counter()
    print(f"{label} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def find_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with everything it names."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=entry["chips"], conf=load_json(ROOT / config["file"]),
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def driver_class(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}").Driver


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py`` (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the traced stretch and the facts the
    driver states about it (``steps``, ``step_flops``, ``attention_shape``,
    ...), with the card's peaks (None for a card not in the table)."""

    trace: object  # devtrace.Trace
    facts: dict
    peaks: dict | None


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def card(device) -> dict:
    """The ``device`` entry of the result line."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def free_card(device) -> None:
    """Hand back the card memory of a released driver's state, which may sit
    in reference cycles until a collection."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def close_process_group() -> None:
    """Destroy the default process group a driver's mesh created, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        out=sys.stdout, err=sys.stderr, driver_cls=None) -> int:
    """One run; prints the result line to ``out`` and returns the exit code."""
    from benchmark import peaks

    import tpu_cc_manager_torch

    if ROOT not in pathlib.Path(tpu_cc_manager_torch.__file__).resolve().parents:
        raise RuntimeError(f"the port was loaded from {tpu_cc_manager_torch.__file__}, "
                           f"not from this checkout ({ROOT})")
    drv = (driver_cls or driver_class(cell))(cell, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s", file=err)
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
    extra = {}
    if trace:
        path = HERE / "traces" / f"{cell.name}.json"
        t_trace = time.perf_counter()
        tr, facts = drv.traced(path)
        print(f"traced stretch and its reading {time.perf_counter() - t_trace:.3f} s", file=err)
        dev = card(device)
        reading = Reading(tr, facts, peaks.for_card(dev["kind"]))
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        extra["breakdown"] = tr.breakdown()
        attempted = facts["steps"]
        extra["launches"] = facts.get("launches")
    else:
        values, attempted = drv.window(seconds)
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        dev = card(device)
    drv.release()
    free_card(device)
    t_check = time.perf_counter()
    checks, failed = drv.check()
    print(f"check's reference {time.perf_counter() - t_check:.3f} s", file=err)
    checks = [Check(name, value, cell.limits[name]) for name, value in checks]
    close_process_group()
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"forbidden modules loaded in the run's process: {found}", file=err)
        return 3
    correct = failed == 0 and all(c.ok for c in checks)
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'OVER'}", file=err)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev, **extra,
              "card": power_limit() if device.type == "cuda" else None,
              "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv: list[str] | None, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        return run(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    except Exception:  # the run's boundary: report, print no result, fail
        traceback.print_exc()
        return 1
    finally:
        close_process_group()
