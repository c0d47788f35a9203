"""The operator's gpu-admin-tools checkout, behind the port's error type.

The reference imports NVIDIA's gpu-admin-tools from a checkout on
``sys.path`` (main.py:30-40, SURVEY.md §1 L1). This module loads that
checkout from a directory and module name the operator gives; it is never
vendored or fetched. It wraps exactly the API the survey lists:
``find_gpus() -> (devices, count)``; on each device ``.bdf``, ``.name``,
``.is_gpu()``, ``.is_nvswitch()``, ``.is_cc_query_supported``,
``.is_ppcie_query_supported``, ``query_cc_mode`` / ``set_cc_mode``,
``query_ppcie_mode`` / ``set_ppcie_mode``, ``reset_with_os`` and
``wait_for_boot``; and the library's ``GpuError``, which becomes the
port's. A checkout laid out otherwise is a change to this one file.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading

from tpu_cc_manager_torch.gpudev.contract import GpuError
from tpu_cc_manager_torch.gpudev.pci import normalize_bdf

# Where the reference's image puts the checkout, and its main module.
DEFAULT_PATH = "/usr/local/gpu-admin-tools"
DEFAULT_MODULE = "nvidia_gpu_tools"
PATH_ENV = "CC_GPU_ADMIN_TOOLS_PATH"
MODULE_ENV = "CC_GPU_ADMIN_TOOLS_MODULE"


def load_module(path: str, module: str):
    """Import ``<path>/<module>.py`` as a module of its own (no change to
    ``sys.path``). Raises GpuError when it is missing or fails to import."""
    file = os.path.join(path, module + ".py")
    if not os.path.isfile(file):
        raise GpuError(f"gpu-admin-tools not found: no {file} (set {PATH_ENV} to the "
                       "operator's checkout)")
    spec = importlib.util.spec_from_file_location(module, file)
    mod = importlib.util.module_from_spec(spec)
    # A module that imports its own helpers finds them beside it.
    added = path not in sys.path
    if added:
        sys.path.insert(0, path)
    try:
        spec.loader.exec_module(mod)
    except Exception as e:  # the checkout's own import-time failure
        raise GpuError(f"gpu-admin-tools {file} failed to import: {e!r}") from e
    finally:
        if added:
            sys.path.remove(path)
    for name in ("find_gpus", "GpuError"):
        if not hasattr(mod, name):
            raise GpuError(f"gpu-admin-tools {file} has no {name}")
    return mod


class AdminDevice:
    """One device of the library, every call's library error turned into
    the port's GpuError naming the device and the call."""

    def __init__(self, raw, lib_error: type) -> None:
        self._raw = raw
        self._lib_error = lib_error
        self.bdf = normalize_bdf(str(raw.bdf))
        self.name = str(getattr(raw, "name", ""))

    def _call(self, what: str, *args):
        try:
            return getattr(self._raw, what)(*args)
        except self._lib_error as e:
            raise GpuError(f"{what}{args!r} on {self.bdf} failed: {e}") from e

    def is_gpu(self) -> bool:
        return bool(self._raw.is_gpu())

    def is_nvswitch(self) -> bool:
        return bool(self._raw.is_nvswitch())

    @property
    def cc_supported(self) -> bool:
        return bool(getattr(self._raw, "is_cc_query_supported", False))

    @property
    def ppcie_supported(self) -> bool:
        return bool(getattr(self._raw, "is_ppcie_query_supported", False))

    def query_cc_mode(self) -> str:
        return str(self._call("query_cc_mode"))

    def set_cc_mode(self, mode: str) -> None:
        self._call("set_cc_mode", mode)

    def query_ppcie_mode(self) -> str:
        return str(self._call("query_ppcie_mode"))

    def set_ppcie_mode(self, mode: str) -> None:
        self._call("set_ppcie_mode", mode)

    def reset_with_os(self) -> None:
        self._call("reset_with_os")

    def wait_for_boot(self) -> None:
        self._call("wait_for_boot")


class AdminTools:
    """The library, loaded at first use from ``path``/``module`` (default
    ``$CC_GPU_ADMIN_TOOLS_PATH`` / ``$CC_GPU_ADMIN_TOOLS_MODULE``, else the
    reference image's ``/usr/local/gpu-admin-tools/nvidia_gpu_tools.py``),
    or the already imported ``module``."""

    def __init__(self, path: str | None = None, module: str | None = None,
                 lib=None) -> None:
        self.path = path or os.environ.get(PATH_ENV) or DEFAULT_PATH
        self.module = module or os.environ.get(MODULE_ENV) or DEFAULT_MODULE
        self._lib = lib
        self._lock = threading.Lock()

    @property
    def lib(self):
        with self._lock:
            if self._lib is None:
                self._lib = load_module(self.path, self.module)
            return self._lib

    def find_devices(self) -> dict[str, AdminDevice]:
        """``{bdf: device}`` for every GPU and NVSwitch the library finds."""
        lib = self.lib
        try:
            found = lib.find_gpus()
        except lib.GpuError as e:
            raise GpuError(f"find_gpus failed: {e}") from e
        devices = found[0] if isinstance(found, tuple) else found
        out = {}
        for raw in devices:
            dev = AdminDevice(raw, lib.GpuError)
            if dev.is_gpu() or dev.is_nvswitch():
                out[dev.bdf] = dev
        return out
