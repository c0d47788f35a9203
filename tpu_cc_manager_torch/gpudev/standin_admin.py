"""A stand-in for gpu-admin-tools that records every call and touches no
device.

It has the API ``admin.py`` wraps (SURVEY.md §1 L1): ``find_gpus() ->
(devices, count)``, ``GpuError``, and on each device ``.bdf``, ``.name``,
``.is_gpu()``, ``.is_nvswitch()``, ``.is_cc_query_supported``,
``.is_ppcie_query_supported``, ``query_/set_cc_mode``,
``query_/set_ppcie_mode``, ``reset_with_os`` and ``wait_for_boot``. As on
the device, a set mode is pending until the device's reset commits it.

Its state is the JSON file ``standin_admin.json`` beside the module: copy
this file into a directory, write the state there with
:func:`write_state`, and load it with ``AdminTools(path=<dir>,
module="standin_admin")``. The state holds the devices, each call as
``[op, bdf, argument]`` in order, and ``fail``: ``{"<op>:<bdf>": n}``
makes the next n such calls raise GpuError.
"""

from __future__ import annotations

import json
import os
import threading

STATE_FILE = "standin_admin.json"
_lock = threading.Lock()


class GpuError(Exception):
    pass


def state_path(directory: str | None = None) -> str:
    return os.path.join(directory or os.path.dirname(os.path.abspath(__file__)), STATE_FILE)


def device_state(bdf: str, name: str, kind: str = "gpu", cc: str = "off",
                 ppcie: str = "off", cc_supported: bool = True,
                 ppcie_supported: bool = True) -> dict:
    return {"bdf": bdf, "name": name, "kind": kind, "cc": cc, "ppcie": ppcie,
            "pending_cc": None, "pending_ppcie": None, "booted": True,
            "cc_supported": cc_supported and kind == "gpu", "ppcie_supported": ppcie_supported}


def write_state(directory: str, devices: list[dict], fail: dict | None = None) -> None:
    with open(state_path(directory), "w", encoding="utf-8") as f:
        json.dump({"devices": devices, "calls": [], "fail": fail or {}}, f, indent=1)


def read_state(directory: str | None = None) -> dict:
    with open(state_path(directory), "r", encoding="utf-8") as f:
        return json.load(f)


def cc_state(directory: str | None = None) -> dict:
    """The system CC state NVML would report for the stand-in's committed
    modes: the fields of ``nvmlSystemGetConfComputeSettings``."""
    gpus = [d for d in read_state(directory)["devices"] if d["kind"] == "gpu"]
    modes = {d["cc"] for d in gpus}
    feature = int(bool(modes & {"on", "devtools"}))
    return {"environment": 2 if feature else 0, "feature": feature,
            "devtools": int("devtools" in modes),
            "multi_gpu": int(any(d["ppcie"] == "on" for d in gpus))}


class _Device:
    def __init__(self, bdf: str, info: dict) -> None:
        self.bdf = bdf
        self.name = info["name"]
        self._kind = info["kind"]
        self.is_cc_query_supported = info["cc_supported"]
        self.is_ppcie_query_supported = info["ppcie_supported"]

    def is_gpu(self) -> bool:
        return self._kind == "gpu"

    def is_nvswitch(self) -> bool:
        return self._kind == "nvswitch"

    def _op(self, op: str, arg=None, change=None):
        with _lock:
            state = read_state()
            state["calls"].append([op, self.bdf, arg])
            key = f"{op}:{self.bdf}"
            failing = state["fail"].get(key, 0)
            if failing:
                state["fail"][key] = failing - 1
            dev = next(d for d in state["devices"] if d["bdf"] == self.bdf)
            if not failing and change is not None:
                change(dev)
            with open(state_path() + ".tmp", "w", encoding="utf-8") as f:
                json.dump(state, f, indent=1)
            os.replace(state_path() + ".tmp", state_path())
        if failing:
            raise GpuError(f"{op} failed on {self.bdf} (stand-in fault)")
        return dev

    def query_cc_mode(self) -> str:
        return self._op("query_cc_mode")["cc"]

    def set_cc_mode(self, mode: str) -> None:
        self._op("set_cc_mode", mode, lambda d: d.update(pending_cc=mode))

    def query_ppcie_mode(self) -> str:
        return self._op("query_ppcie_mode")["ppcie"]

    def set_ppcie_mode(self, mode: str) -> None:
        self._op("set_ppcie_mode", mode, lambda d: d.update(pending_ppcie=mode))

    def reset_with_os(self) -> None:
        def commit(d):
            d.update(cc=d["pending_cc"] or d["cc"], ppcie=d["pending_ppcie"] or d["ppcie"],
                     pending_cc=None, pending_ppcie=None, booted=False)
        self._op("reset_with_os", None, commit)

    def wait_for_boot(self) -> None:
        self._op("wait_for_boot", None, lambda d: d.update(booted=True))


def find_gpus():
    """Every device of the state file, in its order."""
    with _lock:
        devices = [_Device(d["bdf"], d) for d in read_state()["devices"]]
    return devices, len(devices)
