"""The device-layer contract for NVIDIA H100 nodes.

Port of ``tpu_cc_manager/tpudev/contract.py``. The reference's device layer
is gpu-admin-tools (SURVEY.md §1 L1): per-device GPU and NVSwitch objects
whose CC and Protected-PCIe (PPCIe) modes are staged, committed by a reset
and verified after boot. The methods and their call sequence are the JAX
contract's (``TpuCcBackend``), so the unchanged ``CCManager`` drives this
layer through a thin adapter; the unit of state is the device. A real H100
node is one host of a one-host slice (Protected PCIe spans one node's GPUs
and NVSwitches); the fake node can be one host of a slice of several, as
the JAX fake's TPU host can.

Two kinds of device meet here. GPUs carry the CC mode (``on``, ``off``,
``devtools``); NVSwitches have no CC mode and take part only in PPCIe, the
fabric-wide mode in which every GPU and switch of the node is staged and
reset together (SURVEY.md §3.3). On Hopper the two exclude each other:
``on`` and ``devtools`` run with PPCIe off, ``ppcie`` with CC off.
"""

from __future__ import annotations

import abc
import os
from dataclasses import dataclass, field

MODE_ON = "on"
MODE_OFF = "off"
MODE_DEVTOOLS = "devtools"
MODE_PPCIE = "ppcie"
# The CC modes of one GPU, and every mode this layer speaks. The agent's
# labels call PPCIe ``slice``; the adapter in front of CCManager maps it.
CC_MODES = (MODE_ON, MODE_OFF, MODE_DEVTOOLS)
VALID_MODES = CC_MODES + (MODE_PPCIE,)

KIND_GPU = "gpu"
KIND_NVSWITCH = "nvswitch"

# Bounded worker-pool width for the per-device reset fan-out, as in the JAX
# contract: 1 restores the serial walk.
DEFAULT_RESET_PARALLELISM = 4
RESET_PARALLELISM_ENV = "CC_RESET_PARALLELISM"


def reset_parallelism(default: int = DEFAULT_RESET_PARALLELISM) -> int:
    """The configured per-device reset fan-out width (>=1)."""
    try:
        value = int(os.environ.get(RESET_PARALLELISM_ENV, "") or default)
    except ValueError:
        value = default
    return max(1, value)


class GpuError(Exception):
    """Device-layer failure (reference: gpu-admin-tools' GpuError,
    main.py:40). The control loop labels the node ``failed`` and keeps
    watching."""


def raise_pool_errors(errors: list, what: str = "per-device reset") -> None:
    """Re-raise the errors of a per-device pool: a BaseException that is
    not an Exception unwinds first as it is; device errors become one
    GpuError naming every failed worker."""
    if not errors:
        return
    for e in errors:
        if not isinstance(e, Exception):
            raise e
    if len(errors) == 1 and isinstance(errors[0], GpuError):
        raise errors[0]
    detail = "; ".join(str(e)[:256] for e in errors)
    raise GpuError(f"{what} failed on {len(errors)} worker(s): {detail}")


# Runtime-health probe tiers, strongest first: the JAX contract's names and
# ranks, so the watchdog's metric reads the same on both device layers.
HEALTH_TIER_STRENGTH = {
    "health-port": 4,
    "probe-cmd": 3,
    "systemd": 2,
    "device-node": 1,
    "none": 0,
}


@dataclass(frozen=True)
class HealthProbe:
    tier: str
    healthy: bool
    detail: str = ""

    @property
    def strength(self) -> int:
        return HEALTH_TIER_STRENGTH.get(self.tier, 0)


@dataclass(frozen=True)
class GpuDevice:
    """One NVIDIA PCI device of the node: a GPU or an NVSwitch."""

    index: int             # node-local, PCI order: GPUs first, then switches
    bdf: str               # PCI address, "dddd:bb:dd.f"
    name: str              # e.g. "NVIDIA H100 80GB HBM3"
    kind: str              # KIND_GPU | KIND_NVSWITCH
    cc_supported: bool     # the device has a CC mode (GPUs only)
    ppcie_supported: bool  # the device can join the node's PPCIe domain

    @property
    def is_gpu(self) -> bool:
        return self.kind == KIND_GPU


@dataclass(frozen=True)
class NodeTopology:
    """This node's NVIDIA devices: ``devices`` are the GPUs (the CC set the
    manager selects from), ``switches`` the NVSwitches. The node is host
    ``host_index`` of ``num_hosts`` of the slice ``slice_id``, which reads
    as ``node_id`` when unset: a one-host slice named by its node."""

    node_id: str
    variant: str
    devices: tuple[GpuDevice, ...] = field(default_factory=tuple)
    switches: tuple[GpuDevice, ...] = field(default_factory=tuple)
    num_hosts: int = 1
    host_index: int = 0
    slice_id: str | None = None

    def __post_init__(self) -> None:
        if self.slice_id is None:
            object.__setattr__(self, "slice_id", self.node_id)

    @property
    def all_devices(self) -> tuple[GpuDevice, ...]:
        return self.devices + self.switches

    def cc_capable_devices(self) -> tuple[GpuDevice, ...]:
        return tuple(d for d in self.devices if d.cc_supported)

    def ppcie_capable_devices(self) -> tuple[GpuDevice, ...]:
        return tuple(d for d in self.all_devices if d.ppcie_supported)


@dataclass(frozen=True)
class AttestationQuote:
    """The JAX ``AttestationQuote``'s fields, so a quote serializes to the
    same bytes on both device layers (``slice_id`` holds the topology's
    slice id: the node id on a one-host node)."""

    slice_id: str
    nonce: str
    mode: str
    measurements: dict[str, str]
    signature: str
    platform: str  # "fake" | "h100"
    host_evidence: dict[str, str] = field(default_factory=dict)


class GpuCcBackend(abc.ABC):
    """What the reconciler calls; every method may raise GpuError.

    The JAX contract's call sequence for a mode change:

        topo = discover()
        stage_cc_mode(devices, mode)   # record or write the mode, no reset
        reset(devices)                 # commit: every device reset together
        wait_ready(devices, timeout)   # wait_for_boot on each
        query_cc_mode(device) == mode  # verify, per device
        fetch_attestation(nonce)       # the platform agrees
        set_gpus_ready()               # CC modes only, after the quote verified

    The last step has no JAX counterpart: on Hopper in a CC mode CUDA work
    is held back until the GPUs' ready state is set, and the agent
    sets it only once the node's quote has verified.
    """

    @abc.abstractmethod
    def discover(self) -> NodeTopology:
        """Enumerate the node's GPUs and NVSwitches (reference find_gpus,
        main.py:144-155)."""

    @abc.abstractmethod
    def query_cc_mode(self, device: GpuDevice) -> str:
        """The device's committed mode: on|off|devtools|ppcie, read from
        the device (reference main.py:441)."""

    @abc.abstractmethod
    def stage_cc_mode(self, devices: tuple[GpuDevice, ...], mode: str) -> None:
        """Stage ``mode`` on ``devices`` without a reset (reference
        set_cc_mode, main.py:511, batched by the caller). ``ppcie`` adds
        the node's NVSwitches itself."""

    def clear_staged(self, devices: tuple[GpuDevice, ...]) -> None:
        """Withdraw a staged, uncommitted mode (the intent journal's
        rollback before a reset). Idempotent."""

    @abc.abstractmethod
    def reset(self, devices: tuple[GpuDevice, ...]) -> None:
        """Commit the staged modes: every device is reset together
        (reference main.py:514-519, :362-368). Pending markers for every
        device land before any reset starts, and a device promotes to
        committed only after its own reset finished."""

    @abc.abstractmethod
    def wait_ready(self, devices: tuple[GpuDevice, ...], timeout_s: float) -> None:
        """Block until every device booted, or raise GpuError (reference
        wait_for_boot, main.py:523)."""

    @abc.abstractmethod
    def fetch_attestation(self, nonce: str) -> AttestationQuote:
        """A quote of the node's current state bound to ``nonce``."""

    @abc.abstractmethod
    def set_gpus_ready(self) -> None:
        """Let the node's GPUs accept CUDA work in a CC mode (NVML's
        ``nvmlSystemSetConfComputeGpusReadyState``). A reset into a CC mode
        leaves them not ready; the caller sets this only after a verified
        quote, and never for ``off``."""

    def prepare_attestation(self) -> None:
        """Warm what ``fetch_attestation`` can precompute; advisory."""

    def probe_runtime_health(self) -> HealthProbe:
        return HealthProbe(tier="none", healthy=True, detail="no probe available")

    def restart_runtime(self) -> None:
        """A reset of the discovered devices with nothing staged."""
        self.reset(self.discover().devices)

    def preemption_notice(self) -> bool:
        return False
