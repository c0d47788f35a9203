"""NVIDIA PCI devices from sysfs, and their torch device indices.

The reference's find_gpus (main.py:144-155, SURVEY.md §1 L1) lists every
NVIDIA PCI function: GPUs by class 0x030000 (VGA) or 0x030200 (3D
controller), NVSwitches by class 0x068000 (bridge, other). This module
reads the same from ``<sysfs>/bus/pci/devices/*/{vendor,class}``
and touches no device: no driver call, no CUDA context.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from tpu_cc_manager_torch.gpudev.contract import KIND_GPU, KIND_NVSWITCH, GpuError

NVIDIA_VENDOR = 0x10DE
GPU_CLASSES = (0x030000, 0x030200)
NVSWITCH_CLASS = 0x068000


@dataclass(frozen=True)
class PciFunction:
    bdf: str
    class_code: int
    kind: str  # KIND_GPU | KIND_NVSWITCH


def normalize_bdf(bdf: str) -> str:
    """``dddd:bb:dd.f`` in lower case from any of the spellings sysfs,
    NVML ("00000000:19:00.0") or a user gives. Raises GpuError on
    anything else."""
    try:
        rest, _, function = bdf.strip().rpartition(".")
        parts = rest.split(":")
        if len(parts) == 2:
            parts = ["0", *parts]
        domain, bus, device = (int(p, 16) for p in parts)
        fn = int(function, 16)
    except ValueError as e:
        raise GpuError(f"not a PCI address: {bdf!r}") from e
    if not (0 <= domain <= 0xFFFF and 0 <= bus <= 0xFF and 0 <= device <= 0x1F
            and 0 <= fn <= 7) or len(parts) != 3:
        raise GpuError(f"not a PCI address: {bdf!r}")
    return f"{domain:04x}:{bus:02x}:{device:02x}.{fn:x}"


def _read_hex(path: str) -> int | None:
    try:
        with open(path, "r", encoding="ascii") as f:
            return int(f.read().strip(), 16)
    except (OSError, ValueError):
        return None


def pci_bus_present(sysfs_root: str = "/sys") -> bool:
    """Whether this kernel shows a PCI bus in sysfs at all (a sandboxed
    kernel may show none)."""
    return os.path.isdir(os.path.join(sysfs_root, "bus", "pci", "devices"))


def scan(sysfs_root: str = "/sys") -> list[PciFunction]:
    """Every NVIDIA GPU and NVSwitch under ``sysfs_root``, in PCI order.
    Other vendors and other NVIDIA classes (audio, USB-C) are left out."""
    root = os.path.join(sysfs_root, "bus", "pci", "devices")
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return []
    found = []
    for entry in entries:
        path = os.path.join(root, entry)
        if _read_hex(os.path.join(path, "vendor")) != NVIDIA_VENDOR:
            continue
        cls = _read_hex(os.path.join(path, "class"))
        if cls in GPU_CLASSES:
            kind = KIND_GPU
        elif cls == NVSWITCH_CLASS:
            kind = KIND_NVSWITCH
        else:
            continue
        try:
            bdf = normalize_bdf(entry)
        except GpuError:
            continue
        found.append(PciFunction(bdf=bdf, class_code=cls, kind=kind))
    return sorted(found, key=lambda f: f.bdf)


def bdf_of_torch_device(index: int) -> str:
    """The PCI address of torch's CUDA device ``index``. CUDA reports the
    domain, bus and device but not the function, which is 0 for a GPU."""
    import torch

    p = torch.cuda.get_device_properties(index)
    return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"


def torch_index_by_bdf() -> dict[str, int]:
    """``{bdf: torch device index}`` for every visible card. Imports torch
    (and initialises CUDA) only when called: the agent's device layer never
    calls it, because it must not hold a device it is about to reset."""
    import torch

    return {bdf_of_torch_device(i): i for i in range(torch.cuda.device_count())}
