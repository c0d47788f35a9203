"""Fake H100 node: in-memory GPUs and NVSwitches with latency and faults.

Port of ``tpu_cc_manager/tpudev/fake.py`` for a node of GPUs behind
NVSwitches. It implements the whole contract with:

- per-device CC and PPCIe capability flags (mixed-capability cases,
  reference main.py:237-240, and the all-devices PPCIe rule, :279-282);
- staged and committed modes kept apart, so tests can assert the
  stage-all/reset-all order (reference main.py:502-519); CC and PPCIe
  exclude each other, and a reset with a device still in PPCIe first runs
  the PPCIe-off pre-phase (reference main.py:471-500);
- ``fail_next(op, times)`` fault injection, with the JAX fake's op names;
- scalar or per-device reset and boot latencies, the per-device ones
  fanned out on a bounded pool, each device's reset seconds in ``op_log``;
- quotes HMAC-signed with the JAX fake's key and message, byte for byte,
  so the JAX verifier accepts them.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from tpu_cc_manager_torch.gpudev.contract import (
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

# The JAX fake's shared secret (tpudev/fake.py): the verifiers of both
# device layers recompute the same HMAC.
FAKE_ATTESTATION_KEY = b"tpu-cc-manager-fake-attestation-key"

PPCIE_ON, PPCIE_OFF = "on", "off"


def sign_fake_quote(slice_id: str, nonce: str, mode: str, measurements: dict) -> str:
    msg = json.dumps(
        {"slice_id": slice_id, "nonce": nonce, "mode": mode, "m": measurements},
        sort_keys=True,
    ).encode()
    return hmac.new(FAKE_ATTESTATION_KEY, msg, hashlib.sha256).hexdigest()


def _flags(spec, n: int) -> list:
    return list(spec) if isinstance(spec, (list, tuple)) else [spec] * n


class FakeGpuBackend(GpuCcBackend):
    """An HGX-style node by default: 8 H100 GPUs behind 4 NVSwitches."""

    def __init__(
        self,
        num_gpus: int = 8,
        num_switches: int = 4,
        name: str = "NVIDIA H100 80GB HBM3",
        variant: str = "h100-sxm",
        node_id: str = "fake-node-0",
        cc_supported: bool | list[bool] = True,
        ppcie_supported: bool | list[bool] = True,
        initial_mode: str = MODE_OFF,
        reset_latency_s: float | list[float] = 0.0,
        boot_latency_s: float | list[float] = 0.0,
        reset_parallelism_override: int | None = None,
    ) -> None:
        if initial_mode not in VALID_MODES:
            raise ValueError(f"unknown initial mode {initial_mode!r}")
        cc_flags = _flags(cc_supported, num_gpus)
        ppcie_flags = _flags(ppcie_supported, num_gpus + num_switches)
        gpus = tuple(
            GpuDevice(index=i, bdf=f"0000:{0x18 + 0x10 * i:02x}:00.0", name=name,
                      kind=KIND_GPU, cc_supported=cc_flags[i],
                      ppcie_supported=ppcie_flags[i])
            for i in range(num_gpus)
        )
        switches = tuple(
            GpuDevice(index=num_gpus + j, bdf=f"0000:{0x05 + j:02x}:00.0",
                      name="NVIDIA NVSwitch", kind=KIND_NVSWITCH, cc_supported=False,
                      ppcie_supported=ppcie_flags[num_gpus + j])
            for j in range(num_switches)
        )
        self._topology = NodeTopology(node_id=node_id, variant=variant,
                                      devices=gpus, switches=switches)
        self._lock = threading.Lock()
        ppcie_on = initial_mode == MODE_PPCIE
        self.committed_cc: dict[int, str] = {
            d.index: MODE_OFF if ppcie_on else initial_mode for d in gpus}
        self.committed_ppcie: dict[int, str] = {
            d.index: PPCIE_ON if ppcie_on else PPCIE_OFF for d in gpus + switches}
        self.staged: dict[int, str] = {}
        self.booted: dict[int, bool] = {d.index: True for d in gpus + switches}
        self._boot_done_at: dict[int, float] = {}
        self.reset_latency_s = reset_latency_s
        self.boot_latency_s = boot_latency_s
        self.reset_parallelism_override = reset_parallelism_override
        # Fault injection: op name -> remaining failures (-1 = always).
        self.fail: dict[str, int] = {}
        # Ordered (op, payload) log for ordering assertions.
        self.op_log: list[tuple[str, object]] = []
        self.healthy = True
        self.health_tier = "probe-cmd"
        self.preempted = False

    # ---- fault injection ----------------------------------------------------

    def fail_next(self, op: str, times: int = 1) -> None:
        self.fail[op] = times

    def _maybe_fail(self, op: str) -> None:
        n = self.fail.get(op, 0)
        if n:
            if n > 0:
                self.fail[op] = n - 1
            raise GpuError(f"injected fault in {op}")

    # ---- helpers ------------------------------------------------------------

    def _mode_of(self, index: int) -> str:
        if self.committed_ppcie[index] == PPCIE_ON:
            return MODE_PPCIE
        return self.committed_cc.get(index, MODE_OFF)

    def _with_switches(self, devices: tuple[GpuDevice, ...]) -> tuple[GpuDevice, ...]:
        """``devices`` plus the node's NVSwitches when PPCIe is staged on
        any of them: the fabric is staged and reset as one."""
        if any(self.staged.get(d.index) == MODE_PPCIE for d in devices):
            extra = tuple(s for s in self._topology.switches if s not in devices)
            return tuple(devices) + extra
        return tuple(devices)

    def _latency_for(self, spec: float | list[float], index: int) -> float:
        if isinstance(spec, (list, tuple)):
            if not spec:
                return 0.0
            return float(spec[index] if index < len(spec) else spec[-1])
        return float(spec)

    # ---- contract -------------------------------------------------------------

    def discover(self) -> NodeTopology:
        self._maybe_fail("discover")
        self.op_log.append(("discover", None))
        return self._topology

    def query_cc_mode(self, device: GpuDevice) -> str:
        self._maybe_fail("query")
        with self._lock:
            return self._mode_of(device.index)

    def stage_cc_mode(self, devices: tuple[GpuDevice, ...], mode: str) -> None:
        self._maybe_fail("stage")
        if mode not in VALID_MODES:
            raise GpuError(f"unknown mode {mode!r} (expected one of {VALID_MODES})")
        if mode == MODE_PPCIE:
            targets = tuple(devices) + tuple(
                s for s in self._topology.switches if s not in devices)
            lacking = [d.bdf for d in targets if not d.ppcie_supported]
            if lacking:
                raise GpuError(f"PPCIe needs every device of the node; {len(lacking)} "
                               f"lack it: {', '.join(lacking)}")
        else:
            targets = tuple(devices)
            for d in targets:
                if not d.is_gpu:
                    raise GpuError(f"{d.bdf} is an NVSwitch: it has no CC mode")
                if mode != MODE_OFF and not d.cc_supported:
                    raise GpuError(f"{d.bdf} has no CC mode to set to {mode}")
        with self._lock:
            for d in targets:
                self.staged[d.index] = mode
            self.op_log.append(("stage", (tuple(d.index for d in targets), mode)))

    def clear_staged(self, devices: tuple[GpuDevice, ...]) -> None:
        self._maybe_fail("clear_staged")
        with self._lock:
            targets = self._with_switches(devices)
            for d in targets:
                self.staged.pop(d.index, None)
            self.op_log.append(("clear_staged", tuple(d.index for d in targets)))

    def _ppcie_off_prephase(self) -> None:
        """Reference phase 1 (main.py:471-500): every device still in PPCIe
        is set off, reset and booted before any new mode is written."""
        on = [i for i, m in self.committed_ppcie.items() if m == PPCIE_ON]
        if not on:
            return
        for i in on:
            self.op_log.append(("set_ppcie", (i, PPCIE_OFF)))
        for i in on:
            self.committed_ppcie[i] = PPCIE_OFF
            self.op_log.append(("reset.pre", i))
        self.op_log.append(("wait.pre", tuple(on)))

    def _commit(self, index: int) -> None:
        mode = self.staged.pop(index, None)
        if mode is None:
            return
        if mode == MODE_PPCIE:
            self.committed_ppcie[index] = PPCIE_ON
            if index in self.committed_cc:
                self.committed_cc[index] = MODE_OFF
        else:
            self.committed_ppcie[index] = PPCIE_OFF
            self.committed_cc[index] = mode

    def _reset_one(self, device: GpuDevice) -> None:
        """One device's share of a per-device reset: its fault point, its
        latency, its own committed promotion and its seconds in the log."""
        self._maybe_fail(f"reset.dev{device.index}")
        t0 = time.monotonic()
        delay = self._latency_for(self.reset_latency_s, device.index)
        if delay:
            time.sleep(delay)
        with self._lock:
            self._commit(device.index)
            self.booted[device.index] = False
            self._boot_done_at[device.index] = time.monotonic() + self._latency_for(
                self.boot_latency_s, device.index)
            self.op_log.append(("reset.dev", (device.index, time.monotonic() - t0)))

    def reset(self, devices: tuple[GpuDevice, ...]) -> None:
        self._maybe_fail("reset")
        with self._lock:
            targets = self._with_switches(devices)
            if any(d.index in self.staged for d in targets):
                self._ppcie_off_prephase()
        if isinstance(self.reset_latency_s, (list, tuple)):
            workers = self.reset_parallelism_override or reset_parallelism()
            with ThreadPoolExecutor(max_workers=max(1, min(workers, len(targets)))) as pool:
                futures = [pool.submit(self._reset_one, d) for d in targets]
            raise_pool_errors([f.exception() for f in futures if f.exception()])
        else:
            wall = self._latency_for(self.reset_latency_s, 0)
            if wall:
                time.sleep(wall)
            with self._lock:
                now = time.monotonic()
                for d in targets:
                    self._commit(d.index)
                    self.booted[d.index] = False
                    self._boot_done_at[d.index] = now + self._latency_for(
                        self.boot_latency_s, d.index)
        with self._lock:
            self.op_log.append(("reset", tuple(d.index for d in targets)))

    def wait_ready(self, devices: tuple[GpuDevice, ...], timeout_s: float) -> None:
        self._maybe_fail("wait_ready")
        deadline = time.monotonic() + timeout_s
        with self._lock:
            # Switches reset with the fabric boot with it.
            targets = tuple(devices) + tuple(
                s for s in self._topology.switches
                if s not in devices and not self.booted[s.index])
        for d in targets:
            while True:
                with self._lock:
                    if time.monotonic() >= self._boot_done_at.get(d.index, 0.0):
                        self.booted[d.index] = True
                        break
                if time.monotonic() >= deadline:
                    raise GpuError(f"device {d.bdf} did not boot within {timeout_s:g}s")
                time.sleep(0.01)
        self.op_log.append(("wait_ready", tuple(d.index for d in targets)))

    def restart_runtime(self) -> None:
        self._maybe_fail("restart_runtime")
        with self._lock:
            now = time.monotonic()
            for d in self._topology.devices:
                self.booted[d.index] = False
                self._boot_done_at[d.index] = now + self._latency_for(
                    self.boot_latency_s, d.index)
            self.op_log.append(
                ("restart_runtime", tuple(d.index for d in self._topology.devices)))

    def set_preempted(self, preempted: bool = True) -> None:
        with self._lock:
            self.preempted = preempted

    def preemption_notice(self) -> bool:
        self._maybe_fail("preemption_notice")
        with self._lock:
            return self.preempted

    def probe_runtime_health(self) -> HealthProbe:
        self._maybe_fail("probe")
        with self._lock:
            return HealthProbe(self.health_tier, self.healthy,
                               "fake probe " + ("healthy" if self.healthy else "unhealthy"))

    def fetch_attestation(self, nonce: str) -> AttestationQuote:
        self._maybe_fail("attest")
        topo = self._topology
        with self._lock:
            modes = sorted({self._mode_of(d.index) for d in topo.devices})
        mode = modes[0] if len(modes) == 1 else "mixed"
        measurements = {
            "accelerator_type": topo.variant,
            "num_gpus": str(len(topo.devices)),
            "runtime_digest": hashlib.sha256(b"fake-h100-runtime").hexdigest(),
            "cc_mode": mode,
        }
        sig = sign_fake_quote(topo.node_id, nonce, mode, measurements)
        self.op_log.append(("attest", nonce))
        return AttestationQuote(slice_id=topo.node_id, nonce=nonce, mode=mode,
                                measurements=measurements, signature=sig, platform="fake")

