"""The port's device layer (tpu_cc_manager_torch/gpudev): the contract and
the fake H100 node, held against tests/test_tpudev.py's cases and the JAX
package's host-capability probe."""

import dataclasses
import os
import subprocess
import sys
import time

import pytest

from tpu_cc_manager.ccmanager import hostcaps as jax_hostcaps
from tpu_cc_manager_torch.gpudev import hostcaps, load_backend
from tpu_cc_manager_torch.gpudev.attestation import (
    AttestationError,
    fresh_nonce,
    verify_quote,
)
from tpu_cc_manager_torch.gpudev.contract import (
    HEALTH_TIER_STRENGTH,
    MODE_DEVTOOLS,
    MODE_OFF,
    MODE_ON,
    MODE_PPCIE,
    GpuError,
    raise_pool_errors,
)
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend
from tpu_cc_manager_torch.gpudev.h100 import H100Backend
from tpu_cc_manager.tpudev.contract import HEALTH_TIER_STRENGTH as JAX_TIERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fake_gpu():
    return FakeGpuBackend(num_gpus=4, num_switches=2)


def ops(backend):
    return [op for op, _ in backend.op_log]


# ---- tests/test_tpudev.py::TestFakeBackend -------------------------------------

def test_stage_then_reset_commits(fake_gpu):
    devices = fake_gpu.discover().devices
    fake_gpu.stage_cc_mode(devices, MODE_ON)
    assert all(fake_gpu.query_cc_mode(d) == MODE_OFF for d in devices)  # staged only
    fake_gpu.reset(devices)
    fake_gpu.wait_ready(devices, timeout_s=1)
    assert all(fake_gpu.query_cc_mode(d) == MODE_ON for d in devices)


def test_fault_injection(fake_gpu):
    fake_gpu.fail_next("reset")
    with pytest.raises(GpuError):
        fake_gpu.reset(fake_gpu.discover().devices)
    fake_gpu.reset(fake_gpu.discover().devices)  # the next call succeeds
    fake_gpu.fail_next("query", times=-1)
    for _ in range(3):
        with pytest.raises(GpuError, match="injected fault in query"):
            fake_gpu.query_cc_mode(fake_gpu.discover().devices[0])


def test_attestation_roundtrip(fake_gpu):
    topo = fake_gpu.discover()
    fake_gpu.stage_cc_mode(topo.devices, MODE_ON)
    fake_gpu.reset(topo.devices)
    nonce = fresh_nonce()
    quote = fake_gpu.fetch_attestation(nonce)
    assert verify_quote(quote, nonce, MODE_ON, topo.node_id, allow_fake=True) == []
    with pytest.raises(AttestationError, match="fake-platform quote rejected"):
        verify_quote(quote, nonce, MODE_ON, topo.node_id)


def test_attestation_rejects_tampering(fake_gpu):
    nonce = fresh_nonce()
    quote = fake_gpu.fetch_attestation(nonce)
    with pytest.raises(AttestationError, match="HMAC mismatch"):
        verify_quote(dataclasses.replace(quote, signature="0" * 64), nonce, MODE_OFF,
                     allow_fake=True)
    forged = dataclasses.replace(quote, measurements={**quote.measurements, "cc_mode": "on"})
    with pytest.raises(AttestationError, match="HMAC mismatch"):
        verify_quote(forged, nonce, MODE_OFF, allow_fake=True)


def test_attestation_rejects_stale_nonce(fake_gpu):
    quote = fake_gpu.fetch_attestation("nonce-a")
    with pytest.raises(AttestationError, match="nonce mismatch"):
        verify_quote(quote, "nonce-b", MODE_OFF, allow_fake=True)


def test_devtools_policy_logs_instead_of_raising(fake_gpu):
    quote = fake_gpu.fetch_attestation("nonce-a")
    problems = verify_quote(quote, "nonce-b", MODE_OFF, debug_policy=True, allow_fake=True)
    assert problems and "nonce mismatch" in problems[0]


# ---- tests/test_tpudev.py::TestPerChipReset, per device --------------------------

def test_per_device_parallel_wall_time():
    backend = FakeGpuBackend(num_gpus=4, num_switches=0, reset_latency_s=[0.15] * 4,
                             reset_parallelism_override=4)
    devices = backend.discover().devices
    backend.stage_cc_mode(devices, MODE_ON)
    t0 = time.monotonic()
    backend.reset(devices)
    wall = time.monotonic() - t0
    assert wall < 0.45, f"parallel reset took {wall:.3f}s"  # one device's latency, not 0.6
    assert all(backend.query_cc_mode(d) == MODE_ON for d in devices)
    timings = [payload for op, payload in backend.op_log if op == "reset.dev"]
    assert sorted(i for i, _ in timings) == [0, 1, 2, 3]
    assert all(seconds >= 0.15 for _, seconds in timings)


def test_per_device_serial_with_parallelism_one():
    backend = FakeGpuBackend(num_gpus=4, num_switches=0, reset_latency_s=[0.05] * 4,
                             reset_parallelism_override=1)
    devices = backend.discover().devices
    backend.stage_cc_mode(devices, MODE_ON)
    t0 = time.monotonic()
    backend.reset(devices)
    assert time.monotonic() - t0 >= 0.2


def test_per_device_boot_delays_independent():
    backend = FakeGpuBackend(num_gpus=4, num_switches=0, reset_latency_s=[0.0] * 4,
                             boot_latency_s=[0.0, 0.0, 0.0, 0.2], reset_parallelism_override=4)
    devices = backend.discover().devices
    backend.stage_cc_mode(devices, MODE_ON)
    backend.reset(devices)
    t0 = time.monotonic()
    backend.wait_ready(devices, timeout_s=2)
    assert 0.15 <= time.monotonic() - t0 < 1.0
    slow = FakeGpuBackend(num_gpus=2, num_switches=0, boot_latency_s=[0.0, 5.0])
    slow.reset(slow.discover().devices)
    with pytest.raises(GpuError, match="0000:28:00.0 did not boot"):
        slow.wait_ready(slow.discover().devices, timeout_s=0.05)


def test_per_device_failure_keeps_unreset_devices_staged():
    backend = FakeGpuBackend(num_gpus=4, num_switches=0, reset_latency_s=[0.0] * 4,
                             reset_parallelism_override=1)
    backend.fail_next("reset.dev2")
    devices = backend.discover().devices
    backend.stage_cc_mode(devices, MODE_ON)
    with pytest.raises(GpuError):
        backend.reset(devices)
    assert backend.committed_cc[2] == MODE_OFF and backend.staged.get(2) == MODE_ON
    backend.reset(devices)  # the retry converges
    assert all(backend.query_cc_mode(d) == MODE_ON for d in devices)


def test_pool_errors_name_every_worker():
    with pytest.raises(GpuError, match="2 worker"):
        raise_pool_errors([GpuError("a"), RuntimeError("b")])
    with pytest.raises(KeyboardInterrupt):
        raise_pool_errors([GpuError("a"), KeyboardInterrupt()])


# ---- H100 only --------------------------------------------------------------------

def test_nvswitches_out_of_the_cc_set_and_in_the_ppcie_set(fake_gpu):
    topo = fake_gpu.discover()
    assert [d.kind for d in topo.devices] == ["gpu"] * 4
    assert [d.kind for d in topo.switches] == ["nvswitch"] * 2
    assert topo.cc_capable_devices() == topo.devices
    assert topo.ppcie_capable_devices() == topo.devices + topo.switches
    with pytest.raises(GpuError, match="NVSwitch: it has no CC mode"):
        fake_gpu.stage_cc_mode(topo.switches, MODE_ON)
    # PPCIe staged on the GPUs takes the switches with it: staged and reset as one.
    fake_gpu.stage_cc_mode(topo.devices, MODE_PPCIE)
    assert ("stage", ((0, 1, 2, 3, 4, 5), MODE_PPCIE)) in fake_gpu.op_log
    fake_gpu.reset(topo.devices)
    fake_gpu.wait_ready(topo.devices, timeout_s=1)
    assert fake_gpu.op_log[-2] == ("reset", (0, 1, 2, 3, 4, 5))
    assert fake_gpu.op_log[-1] == ("wait_ready", (0, 1, 2, 3, 4, 5))
    assert all(fake_gpu.query_cc_mode(d) == MODE_PPCIE for d in topo.all_devices)


def test_the_all_devices_ppcie_rule():
    backend = FakeGpuBackend(num_gpus=4, num_switches=2,
                             ppcie_supported=[True] * 5 + [False])
    topo = backend.discover()
    with pytest.raises(GpuError, match="1 lack it: 0000:06:00.0"):
        backend.stage_cc_mode(topo.devices, MODE_PPCIE)
    assert backend.staged == {} and ops(backend) == ["discover"]


def test_cc_and_ppcie_exclude_each_other():
    backend = FakeGpuBackend(num_gpus=2, num_switches=1, initial_mode=MODE_DEVTOOLS)
    topo = backend.discover()
    backend.stage_cc_mode(topo.devices, MODE_PPCIE)
    backend.reset(topo.devices)
    assert backend.committed_cc == {0: MODE_OFF, 1: MODE_OFF}  # ppcie means CC off
    assert backend.query_cc_mode(topo.devices[0]) == MODE_PPCIE
    backend.stage_cc_mode(topo.devices, MODE_ON)
    backend.reset(topo.devices)
    assert set(backend.committed_ppcie.values()) == {"off"}  # on means PPCIe off
    assert [backend.query_cc_mode(d) for d in topo.all_devices] == [MODE_ON, MODE_ON, MODE_OFF]


def test_ppcie_off_prephase_runs_before_the_new_mode():
    """From PPCIe, every device (switch included) is set PPCIe off, reset
    and booted before the new CC mode commits; the CC reset follows."""
    backend = FakeGpuBackend(num_gpus=2, num_switches=1, initial_mode=MODE_PPCIE)
    topo = backend.discover()
    backend.stage_cc_mode(topo.devices, MODE_ON)
    assert backend.committed_ppcie == {0: "on", 1: "on", 2: "on"}  # staging touched nothing
    backend.reset(topo.devices)
    log = backend.op_log[2:]
    assert log == [("set_ppcie", (0, "off")), ("set_ppcie", (1, "off")), ("set_ppcie", (2, "off")),
                   ("reset.pre", 0), ("reset.pre", 1), ("reset.pre", 2), ("wait.pre", (0, 1, 2)),
                   ("reset", (0, 1))]
    assert [backend.query_cc_mode(d) for d in topo.all_devices] == [MODE_ON, MODE_ON, MODE_OFF]


def test_clear_staged_drops_the_fabric(fake_gpu):
    topo = fake_gpu.discover()
    fake_gpu.stage_cc_mode(topo.devices, MODE_PPCIE)
    fake_gpu.clear_staged(topo.devices)
    assert fake_gpu.staged == {} and fake_gpu.op_log[-1] == ("clear_staged", (0, 1, 2, 3, 4, 5))
    fake_gpu.reset(topo.devices)
    assert all(fake_gpu.query_cc_mode(d) == MODE_OFF for d in topo.all_devices)


def test_health_tiers_and_preemption(fake_gpu):
    assert HEALTH_TIER_STRENGTH == JAX_TIERS
    assert fake_gpu.probe_runtime_health().strength == 3
    fake_gpu.healthy = False
    assert not fake_gpu.probe_runtime_health().healthy
    assert fake_gpu.preemption_notice() is False
    fake_gpu.set_preempted()
    assert fake_gpu.preemption_notice() is True


def test_load_backend(tmp_path, monkeypatch):
    assert isinstance(load_backend("fake"), FakeGpuBackend)
    monkeypatch.setenv("GPU_CC_FAKE_NUM_GPUS", "2")
    monkeypatch.setenv("GPU_CC_FAKE_NUM_SWITCHES", "0")
    monkeypatch.setenv("GPU_CC_FAKE_NODE_ID", "node-7")
    topo = load_backend("fake").discover()
    assert (len(topo.devices), len(topo.switches), topo.node_id) == (2, 0, "node-7")
    assert load_backend("fake", num_gpus=3).discover().devices[-1].index == 2
    assert isinstance(load_backend("h100", state_dir=str(tmp_path)), H100Backend)
    with pytest.raises(ValueError):
        load_backend("tpuvm")


@pytest.mark.parametrize("files,expect", [
    ({}, False),
    ({"tdx_guest": None}, True),
    ({"tdx": "Y\n"}, True),
    ({"tdx": "N\n", "sev_snp": "y"}, True),
    ({"tdx": "N\n", "sev_snp": "0"}, False),
])
def test_hostcaps_matches_the_jax_probe(tmp_path, files, expect):
    paths = {name: str(tmp_path / name) for name in ("tdx_guest", "sev-guest", "tdx", "sev_snp")}
    for name, content in files.items():
        with open(paths[name], "w") as f:
            f.write(content or "")
    probes = (("TDX guest device", paths["tdx_guest"], None),
              ("SEV guest device", paths["sev-guest"], None),
              ("KVM Intel TDX host support", paths["tdx"], "Y"),
              ("KVM AMD SEV-SNP host support", paths["sev_snp"], "Y"))
    assert hostcaps.is_host_cc_enabled(probes) is expect
    assert jax_hostcaps.is_host_cc_enabled(probes) is expect
    assert [p[0] for p in hostcaps.DEFAULT_PROBES] == [p[0] for p in jax_hostcaps._DEFAULT_PROBES]
    assert [p[1:] for p in hostcaps.DEFAULT_PROBES] == [p[1:] for p in jax_hostcaps._DEFAULT_PROBES]


def test_importing_gpudev_neither_imports_torch_nor_touches_cuda():
    code = """
import importlib, pkgutil, sys
import tpu_cc_manager_torch.gpudev as g
for m in pkgutil.walk_packages(g.__path__, "tpu_cc_manager_torch.gpudev."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules if m == "torch" or m.startswith(("torch.", "jax", "tpu_cc_manager."))]
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
