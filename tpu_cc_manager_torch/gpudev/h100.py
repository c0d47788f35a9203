"""The real H100 backend: gpu-admin-tools for modes and resets, sysfs for
discovery, NVML for the system CC state, boot checks and attestation.

Port of ``tpu_cc_manager/tpudev/tpuvm.py``'s role for NVIDIA nodes. The
flip follows the reference's phases (SURVEY.md §3.2, main.py:449-542):

1. a device still in Protected PCIe (PPCIe) is first set PPCIe off, reset,
   booted and verified (main.py:471-500);
2. the new mode is set on every device;
3. every device is reset;
4. every device runs ``wait_for_boot`` and is verified.

The contract says staging disrupts nothing, so ``stage_cc_mode`` writes
the mode through gpu-admin-tools only when no pre-phase is needed; else it
records the pending mode in the state directory and ``reset`` runs the
pre-phase before the writes. CC and PPCIe exclude each other on Hopper:
``on`` and ``devtools`` run with PPCIe off, ``ppcie`` with CC off, and
``ppcie`` stages and resets the node's NVSwitches with its GPUs.

The backend never creates a CUDA context (the agent must not hold a device
it is about to reset): it reads devices through sysfs and NVML only.
Every environment-touching part is injectable: the sysfs root, the NVML
object, the admin library, the state directory and the metadata URL.

The node is always a one-host slice named by its node id (``num_hosts=1,
host_index=0``, and ``slice_id`` the node id in its topology and its
quotes): Hopper's Protected PCIe spans one node's GPUs and NVSwitches, so
no CC domain reaches across hosts, and the JAX ``TpuVmBackend``'s
multi-host discovery from TPU-VM metadata has no counterpart here.

Runtime-health tiers (the JAX contract's names): ``probe-cmd`` is NVML
answering for every GPU of the node (a handle by PCI address and its name,
the driver's own management path); ``device-node`` is ``/dev/nvidia<N>``
existing when NVML cannot be loaded; ``none`` is neither.
"""

from __future__ import annotations

import base64
import glob
import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from tpu_cc_manager_torch.gpudev import attestation, pci
from tpu_cc_manager_torch.gpudev.admin import AdminDevice, AdminTools
from tpu_cc_manager_torch.gpudev.contract import (
    CC_MODES,
    KIND_GPU,
    KIND_NVSWITCH,
    MODE_OFF,
    MODE_PPCIE,
    VALID_MODES,
    AttestationQuote,
    GpuCcBackend,
    GpuDevice,
    GpuError,
    HealthProbe,
    NodeTopology,
    raise_pool_errors,
    reset_parallelism,
)
from tpu_cc_manager_torch.gpudev.nvml import (
    NVML_CC_ACCEPTING_CLIENT_REQUESTS_TRUE,
    Nvml,
    NvmlError,
)
from tpu_cc_manager_torch.obs import trace as obs_trace
from tpu_cc_manager_torch.utils.gpu_info import variant_from_name

log = logging.getLogger(__name__)

METADATA_URL = "http://metadata.google.internal/computeMetadata/v1"
DEFAULT_STATE_DIR = "/var/lib/tpu-cc-manager/gpudev"
PPCIE_ON, PPCIE_OFF = "on", "off"


class H100Backend(GpuCcBackend):
    def __init__(
        self,
        state_dir: str = DEFAULT_STATE_DIR,
        admin: AdminTools | None = None,
        nvml: Nvml | None = None,
        sysfs_root: str = "/sys",
        dev_root: str = "/dev",
        metadata_url: str = METADATA_URL,
        node_id: str | None = None,
        reset_parallelism_override: int | None = None,
    ) -> None:
        self.state_dir = state_dir
        self.admin = admin or AdminTools()
        self.nvml = nvml or Nvml()
        self.sysfs_root = sysfs_root
        self.dev_root = dev_root
        self.metadata_url = metadata_url
        self.node_id = node_id
        self.reset_parallelism_override = reset_parallelism_override
        self._lock = threading.Lock()
        self._topology: NodeTopology | None = None
        self._devices: dict[str, AdminDevice] = {}
        self._awaiting_boot: set[str] = set()
        # (op, payload) in call order; each device's reset and boot seconds.
        self.op_log: list[tuple[str, object]] = []

    # ---- helpers ------------------------------------------------------------

    def _log(self, op: str, payload: object = None) -> None:
        with self._lock:
            self.op_log.append((op, payload))

    def _state_path(self, name: str) -> str:
        return os.path.join(self.state_dir, name)

    def _read_state(self, name: str) -> dict:
        try:
            with open(self._state_path(name), "r", encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, json.JSONDecodeError) as e:
            raise GpuError(f"corrupt device state file {name}: {e}") from e

    def _write_state(self, name: str, payload: dict) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = self._state_path(name) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path(name))

    def _device(self, bdf: str) -> AdminDevice:
        dev = self._devices.get(bdf)
        if dev is None:
            self._devices = self.admin.find_devices()
            dev = self._devices.get(bdf)
        if dev is None:
            raise GpuError(f"gpu-admin-tools does not list {bdf}")
        return dev

    def _topo(self) -> NodeTopology:
        return self._topology or self.discover()

    def _pool(self, fn, devices, what: str) -> None:
        """``fn(device)`` for every device on the bounded pool, each in the
        caller's trace context."""
        if not devices:
            return
        workers = self.reset_parallelism_override or reset_parallelism()
        with ThreadPoolExecutor(max_workers=max(1, min(workers, len(devices)))) as pool:
            futures = [pool.submit(obs_trace.in_current_context(fn, d)) for d in devices]
        raise_pool_errors([f.exception() for f in futures if f.exception()], what)

    def _nvml_mode(self) -> str | None:
        """The CC mode of NVML's system state, or None where this driver's
        NVML has no CC state."""
        try:
            with self.nvml as nvml:
                return nvml.cc_mode()
        except NvmlError as e:
            if e.function.startswith("nvmlSystemGetConfCompute"):
                return None
            raise

    # ---- contract -------------------------------------------------------------

    def discover(self) -> NodeTopology:
        functions = pci.scan(self.sysfs_root)
        if not functions:
            raise GpuError(f"no NVIDIA GPU or NVSwitch under {self.sysfs_root}/bus/pci/devices")
        devices = self.admin.find_devices()
        seen = {f.bdf for f in functions}
        if set(devices) != seen:
            raise GpuError(f"sysfs lists {sorted(seen)} but gpu-admin-tools lists "
                           f"{sorted(devices)}")
        gpus, switches = [], []
        ordered = ([f for f in functions if f.kind == KIND_GPU]
                   + [f for f in functions if f.kind == KIND_NVSWITCH])
        for index, f in enumerate(ordered):
            dev = devices[f.bdf]
            is_gpu = f.kind == KIND_GPU
            if dev.is_gpu() != is_gpu:
                raise GpuError(f"{f.bdf}: sysfs class {f.class_code:#08x} and "
                               "gpu-admin-tools disagree on what it is")
            (gpus if is_gpu else switches).append(GpuDevice(
                index=index, bdf=f.bdf, name=dev.name, kind=f.kind,
                cc_supported=is_gpu and dev.cc_supported,
                ppcie_supported=dev.ppcie_supported))
        if not gpus:
            raise GpuError("the node has NVSwitches but no GPU")
        variant = variant_from_name(gpus[0].name) or gpus[0].name
        node_id = self.node_id or os.environ.get("NODE_NAME") or socket.gethostname()
        topo = NodeTopology(node_id=node_id, variant=variant, devices=tuple(gpus),
                            switches=tuple(switches))
        self._devices, self._topology = devices, topo
        self._log("discover", len(ordered))
        return topo

    def _ppcie_mode(self, device: GpuDevice) -> str:
        if not device.ppcie_supported:
            return PPCIE_OFF
        return self._device(device.bdf).query_ppcie_mode()

    def _query_device(self, device: GpuDevice) -> str:
        if self._ppcie_mode(device) == PPCIE_ON:
            return MODE_PPCIE
        if not device.is_gpu:
            return MODE_OFF
        mode = self._device(device.bdf).query_cc_mode()
        if mode not in CC_MODES:
            raise GpuError(f"{device.bdf}: gpu-admin-tools reports CC mode {mode!r}")
        return mode

    def query_cc_mode(self, device: GpuDevice) -> str:
        """The mode read from the device, never the staged one; a reset
        that started and never finished reads ``resetting``. Where NVML
        has the system CC state, a GPU's mode must agree with it."""
        if device.bdf in self._read_state("pending.json"):
            return "resetting"
        mode = self._query_device(device)
        if device.is_gpu:
            nvml_mode = self._nvml_mode()
            if nvml_mode is not None and nvml_mode != mode:
                raise GpuError(f"{device.bdf}: gpu-admin-tools reads CC mode {mode!r} but "
                               f"NVML's system CC state says {nvml_mode!r}")
        return mode

    def _targets(self, devices: tuple[GpuDevice, ...], ppcie: bool) -> tuple[GpuDevice, ...]:
        if not ppcie:
            return tuple(devices)
        return tuple(devices) + tuple(s for s in self._topo().switches if s not in devices)

    def _write_mode(self, device: GpuDevice, mode: str) -> None:
        dev = self._device(device.bdf)
        if mode == MODE_PPCIE:
            if device.is_gpu and dev.query_cc_mode() != MODE_OFF:
                dev.set_cc_mode(MODE_OFF)
                self._log("set_cc", (device.bdf, MODE_OFF))
            dev.set_ppcie_mode(PPCIE_ON)
            self._log("set_ppcie", (device.bdf, PPCIE_ON))
        else:
            dev.set_cc_mode(mode)
            self._log("set_cc", (device.bdf, mode))

    def stage_cc_mode(self, devices: tuple[GpuDevice, ...], mode: str) -> None:
        if mode not in VALID_MODES:
            raise GpuError(f"unknown mode {mode!r} (expected one of {VALID_MODES})")
        targets = self._targets(devices, mode == MODE_PPCIE)
        if mode == MODE_PPCIE:
            lacking = [d.bdf for d in targets if not d.ppcie_supported]
            if lacking:
                raise GpuError(f"PPCIe needs every device of the node; {len(lacking)} "
                               f"lack it: {', '.join(lacking)}")
        for d in targets:
            if mode != MODE_PPCIE and not d.is_gpu:
                raise GpuError(f"{d.bdf} is an NVSwitch: it has no CC mode")
            if mode not in (MODE_OFF, MODE_PPCIE) and not d.cc_supported:
                raise GpuError(f"{d.bdf} has no CC mode to set to {mode}")
        prephase = any(self._ppcie_mode(d) == PPCIE_ON for d in self._topo().all_devices)
        staged = self._read_state("staged.json")
        for d in targets:
            staged[d.bdf] = {"mode": mode, "written": not prephase,
                             "cc": self._device(d.bdf).query_cc_mode() if d.is_gpu else None,
                             "ppcie": self._ppcie_mode(d)}
        self._write_state("staged.json", staged)
        if not prephase:
            for d in targets:
                self._write_mode(d, mode)
        self._log("stage", (tuple(d.bdf for d in targets), mode, "written" if not prephase
                            else "recorded"))

    def clear_staged(self, devices: tuple[GpuDevice, ...]) -> None:
        """Drop a staged mode; where it was already written, write the
        committed mode recorded at staging back."""
        staged = self._read_state("staged.json")
        ppcie = any(staged.get(d.bdf, {}).get("mode") == MODE_PPCIE for d in devices)
        dropped = []
        for d in self._targets(devices, ppcie):
            entry = staged.pop(d.bdf, None)
            if entry is None:
                continue
            dropped.append(d.bdf)
            if entry["written"]:
                dev = self._device(d.bdf)
                if entry["mode"] == MODE_PPCIE:
                    dev.set_ppcie_mode(entry["ppcie"])
                if d.is_gpu:
                    dev.set_cc_mode(entry["cc"])
                self._log("unstage", d.bdf)
        if dropped:
            self._write_state("staged.json", staged)
        self._log("clear_staged", tuple(dropped))

    def _reset_one(self, device: GpuDevice, op: str = "reset.dev") -> None:
        """One device's reset, in its own span (the contract's per-device
        ``reset.chip``)."""
        t0 = time.monotonic()
        with obs_trace.span("reset.chip", chip=device.index):
            self._device(device.bdf).reset_with_os()
        self._log(op, (device.bdf, time.monotonic() - t0))

    def _boot_one(self, device: GpuDevice, op: str = "wait.dev") -> None:
        t0 = time.monotonic()
        self._device(device.bdf).wait_for_boot()
        self._log(op, (device.bdf, time.monotonic() - t0))

    def _ppcie_off_prephase(self) -> None:
        """Reference phase 1: every device still in PPCIe is set off,
        reset, booted and verified before any new mode is written."""
        on = [d for d in self._topo().all_devices if self._ppcie_mode(d) == PPCIE_ON]
        for d in on:
            self._device(d.bdf).set_ppcie_mode(PPCIE_OFF)
            self._log("set_ppcie", (d.bdf, PPCIE_OFF))
        self._pool(lambda d: self._reset_one(d, "reset.pre"), on, "PPCIe-off reset")
        self._pool(lambda d: self._boot_one(d, "wait.pre"), on, "PPCIe-off boot")
        for d in on:
            if self._ppcie_mode(d) != PPCIE_OFF:
                raise GpuError(f"{d.bdf} still reports PPCIe on after the PPCIe-off reset")
        self._log("verify.pre", tuple(d.bdf for d in on))

    def reset(self, devices: tuple[GpuDevice, ...]) -> None:
        staged = self._read_state("staged.json")
        ppcie = any(staged.get(d.bdf, {}).get("mode") == MODE_PPCIE for d in devices)
        targets = self._targets(devices, ppcie)
        # Crash safety: every device reads "resetting" before any is reset,
        # until all of them finished.
        self._write_state("pending.json", {
            d.bdf: staged.get(d.bdf, {}).get("mode") for d in targets})
        if any(d.bdf in staged and not staged[d.bdf]["written"] for d in targets):
            self._ppcie_off_prephase()
            for d in targets:
                entry = staged.get(d.bdf)
                if entry and not entry["written"]:
                    self._write_mode(d, entry["mode"])
                    entry["written"] = True
            self._write_state("staged.json", staged)
        self._pool(self._reset_one, targets, "per-device reset")
        with self._lock:
            self._awaiting_boot.update(d.bdf for d in targets)
        for d in targets:
            staged.pop(d.bdf, None)
        self._write_state("staged.json", staged)
        self._write_state("pending.json", {})
        self._log("reset", tuple(d.bdf for d in targets))

    def wait_ready(self, devices: tuple[GpuDevice, ...], timeout_s: float) -> None:
        """``wait_for_boot`` on every device (and the switches reset with
        them), then an NVML handle for every GPU."""
        with self._lock:
            targets = tuple(devices) + tuple(
                s for s in self._topo().switches
                if s not in devices and s.bdf in self._awaiting_boot)
        t0 = time.monotonic()
        self._pool(self._boot_one, targets, "wait_for_boot")
        if time.monotonic() - t0 > timeout_s:
            raise GpuError(f"devices booted after {time.monotonic() - t0:.1f}s, "
                           f"past the {timeout_s:g}s limit")
        with self.nvml as nvml:
            for d in targets:
                if not d.is_gpu:
                    continue
                try:
                    nvml.handle_by_bdf(d.bdf)
                except NvmlError as e:
                    raise GpuError(f"{d.bdf} booted but NVML has no handle for it: {e}") from e
        with self._lock:
            self._awaiting_boot.difference_update(d.bdf for d in targets)
        self._log("wait_ready", tuple(d.bdf for d in targets))

    def set_gpus_ready(self) -> None:
        """NVML's CC ready state set to accept work and read back. With CC
        off NVML refuses: NvmlError with its code."""
        with self.nvml as nvml:
            nvml.set_gpus_ready_state(NVML_CC_ACCEPTING_CLIENT_REQUESTS_TRUE)
            state = nvml.gpus_ready_state()
        if state != NVML_CC_ACCEPTING_CLIENT_REQUESTS_TRUE:
            raise GpuError(f"NVML reads the CC ready state as {state} after setting it")
        self._log("set_ready", state)

    def probe_runtime_health(self) -> HealthProbe:
        gpus = self._topology.devices if self._topology else ()
        try:
            with self.nvml as nvml:
                names = [nvml.name(nvml.handle_by_bdf(d.bdf)) for d in gpus]
                count = nvml.device_count()
            return HealthProbe("probe-cmd", count > 0,
                               f"NVML answers for {len(names)} GPU(s) of {count}")
        except NvmlError as e:
            return HealthProbe("probe-cmd", False, str(e))
        except GpuError as e:  # NVML cannot be loaded at all
            nodes = glob.glob(os.path.join(self.dev_root, "nvidia[0-9]*"))
            if nodes:
                return HealthProbe("device-node", True,
                                   f"{len(nodes)} device node(s); NVML unavailable: {e}")
            return HealthProbe("none", False, f"no NVML and no device node: {e}")

    def preemption_notice(self) -> bool:
        """GCE's ``instance/preempted`` flag; an unreachable metadata
        server reads as not preempted (tpuvm.py's rule)."""
        req = urllib.request.Request(f"{self.metadata_url}/instance/preempted",
                                     headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=2) as resp:
                value = resp.read().decode("utf-8")
        except (urllib.error.URLError, OSError, TimeoutError):
            return False
        return value.strip().upper() == "TRUE"

    def fetch_attestation(self, nonce: str) -> AttestationQuote:
        """Each GPU's SPDM report over the nonce's 32-byte challenge and its
        attestation certificate chain, from NVML. With CC off NVML refuses
        the report: NvmlError with its return code, and no quote."""
        topo = self._topo()
        modes = sorted({self._query_device(d) for d in topo.devices})
        mode = modes[0] if len(modes) == 1 else "mixed"
        challenge = attestation.nonce_challenge(nonce)
        evidence, records, vbios = [], [], set()
        with self.nvml as nvml:
            driver = nvml.driver_version()
            for d in topo.devices:
                handle = nvml.handle_by_bdf(d.bdf)
                report = nvml.attestation_report(handle, challenge)
                certs = nvml.attestation_cert_chain(handle)
                vbios.add(nvml.vbios_version(handle))
                records.append(attestation.parse_spdm_report(report).measurement_record)
                evidence.append({"bdf": d.bdf,
                                 "report": base64.b64encode(report).decode("ascii"),
                                 "certs": base64.b64encode(certs).decode("ascii")})
        vbios_version = ",".join(sorted(vbios))
        measurements = {
            "accelerator_type": topo.variant,
            "num_gpus": str(len(topo.devices)),
            "cc_mode": mode,
            "driver_version": driver,
            "vbios_version": vbios_version,
            "runtime_digest": attestation.runtime_digest(driver, vbios_version, records),
        }
        self._log("attest", nonce)
        return AttestationQuote(
            slice_id=topo.node_id, nonce=nonce, mode=mode, measurements=measurements,
            signature=json.dumps(evidence, sort_keys=True, separators=(",", ":")),
            platform="h100")
