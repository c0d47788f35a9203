"""Where the agent meets the device layer: an H100 node as a host of the
manager's slice.

The manager, the watchdog and the remediation ladder are copies of the JAX
package's, written against ``tpudev/contract.py``: a slice of chips, a
backend that stages, resets, waits and quotes that slice, and one device
error. :class:`NodeBackend` shows a port :class:`GpuCcBackend` to them that
way, and is the only place they touch ``gpudev``:

- the GPUs become the chips (NVSwitches have no CC mode); a chip's
  ``device_path`` is its PCI address;
- a GPU is ``slice_cc_supported`` only when it and every NVSwitch of the
  node can join Protected PCIe, so the manager's all-chips rule covers the
  switches it never sees;
- the node is host ``host_index`` of the ``num_hosts`` hosts of the slice
  its topology names: on hardware a one-host slice named by the node id
  (Protected PCIe spans one node), on the fake any host of a slice of
  several, so the slice commit barrier and peer fencing run;
- the label mode ``slice`` is the device layer's ``ppcie``, both ways; a
  fake quote's HMAC covers the mode, so it is signed again under the label
  mode (the ``h100`` evidence does not cover it);
- :class:`GpuError` is the error the manager catches;
- ``set_gpus_ready`` has no JAX counterpart: the manager calls it after a
  verified quote of a CC mode, because an H100 in a CC mode holds CUDA work
  back until the GPUs' ready state is set.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from tpu_cc_manager_torch.gpudev.contract import (
    MODE_PPCIE,
    AttestationQuote,
    GpuCcBackend,
    GpuDevice,
    GpuError,
    HealthProbe,
)
from tpu_cc_manager_torch.labels import MODE_SLICE

__all__ = ["AttestationQuote", "ChipView", "GpuError", "HealthProbe", "NodeBackend",
           "SliceView", "is_fake_backend", "to_gpu_mode", "to_label_mode"]


def to_gpu_mode(mode: str) -> str:
    """The device layer's name of a label mode."""
    return MODE_PPCIE if mode == MODE_SLICE else mode


def to_label_mode(mode: str) -> str:
    """The label name of a device-layer mode."""
    return MODE_SLICE if mode == MODE_PPCIE else mode


@dataclass(frozen=True)
class ChipView:
    """One GPU as the manager reads it (the JAX ``TpuChip``'s fields)."""

    index: int
    device_path: str           # the GPU's PCI address
    chip_type: str             # the node's variant, e.g. "h100"
    cc_supported: bool
    slice_cc_supported: bool   # the GPU and every NVSwitch support PPCIe

    @property
    def name(self) -> str:
        return f"{self.chip_type}:{self.device_path}"


@dataclass(frozen=True)
class SliceView:
    """The node as the manager reads it (the JAX ``SliceTopology``'s
    fields): one host of a slice, the only one on hardware."""

    slice_id: str
    accelerator_type: str
    num_hosts: int
    host_index: int
    chips: tuple[ChipView, ...] = field(default_factory=tuple)

    @property
    def is_multi_host(self) -> bool:
        return self.num_hosts > 1

    def cc_capable_chips(self) -> tuple[ChipView, ...]:
        return tuple(c for c in self.chips if c.cc_supported)

    def slice_cc_capable_chips(self) -> tuple[ChipView, ...]:
        return tuple(c for c in self.chips if c.slice_cc_supported)


class NodeBackend:
    """The manager's backend over a port :class:`GpuCcBackend` (``gpu``).
    Every method may raise :class:`GpuError`."""

    def __init__(self, gpu: GpuCcBackend) -> None:
        self.gpu = gpu
        # The intent journal and the verified-digest record live where the
        # device layer keeps its state (the h100 backend has a state dir).
        self.state_dir = getattr(gpu, "state_dir", None)
        self._devices: dict[str, GpuDevice] = {}

    def _devs(self, chips: tuple[ChipView, ...]) -> tuple[GpuDevice, ...]:
        """The devices of chips from this backend's last ``discover`` (the
        manager discovers before every other call)."""
        return tuple(self._devices[c.device_path] for c in chips)

    def discover(self) -> SliceView:
        topo = self.gpu.discover()
        self._devices = {d.bdf: d for d in topo.all_devices}
        fabric = all(s.ppcie_supported for s in topo.switches)
        chips = tuple(ChipView(index=d.index, device_path=d.bdf, chip_type=topo.variant,
                               cc_supported=d.cc_supported,
                               slice_cc_supported=d.ppcie_supported and fabric)
                      for d in topo.devices)
        return SliceView(slice_id=topo.slice_id, accelerator_type=topo.variant,
                         num_hosts=topo.num_hosts, host_index=topo.host_index, chips=chips)

    def query_cc_mode(self, chip: ChipView) -> str:
        return to_label_mode(self.gpu.query_cc_mode(self._devs((chip,))[0]))

    def stage_cc_mode(self, chips: tuple[ChipView, ...], mode: str) -> None:
        self.gpu.stage_cc_mode(self._devs(chips), to_gpu_mode(mode))

    def clear_staged(self, chips: tuple[ChipView, ...]) -> None:
        self.gpu.clear_staged(self._devs(chips))

    def reset(self, chips: tuple[ChipView, ...]) -> None:
        self.gpu.reset(self._devs(chips))

    def wait_ready(self, chips: tuple[ChipView, ...], timeout_s: float) -> None:
        self.gpu.wait_ready(self._devs(chips), timeout_s)

    def fetch_attestation(self, nonce: str) -> AttestationQuote:
        quote = self.gpu.fetch_attestation(nonce)
        mode = to_label_mode(quote.mode)
        if mode == quote.mode:
            return quote
        measurements = {**quote.measurements, "cc_mode": mode}
        signature = quote.signature
        if quote.platform == "fake":
            from tpu_cc_manager_torch.gpudev.fake import sign_fake_quote

            signature = sign_fake_quote(quote.slice_id, nonce, mode, measurements)
        return dataclasses.replace(quote, mode=mode, measurements=measurements,
                                   signature=signature)

    def set_gpus_ready(self) -> None:
        self.gpu.set_gpus_ready()

    def prepare_attestation(self) -> None:
        self.gpu.prepare_attestation()

    def probe_runtime_health(self) -> HealthProbe:
        return self.gpu.probe_runtime_health()

    def restart_runtime(self) -> None:
        self.gpu.restart_runtime()

    def preemption_notice(self) -> bool:
        return self.gpu.preemption_notice()

    def set_brownout(self, factor: float) -> None:
        """Arm or clear a brownout on a device layer that models one (the
        fake, ``FakeGpuBackend.set_brownout``)."""
        self.gpu.set_brownout(factor)


def is_fake_backend(backend) -> bool:
    """Whether the operator chose the fake device layer, whose HMAC quotes
    the verifier then admits."""
    from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend

    return isinstance(getattr(backend, "gpu", backend), FakeGpuBackend)
