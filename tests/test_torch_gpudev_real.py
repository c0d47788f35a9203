"""The real H100 backend (tpu_cc_manager_torch/gpudev/h100.py) on injected
parts: a sysfs tree in tmp_path, NVML as a Python library object behind the
port's ctypes bindings, and the stand-in gpu-admin-tools module copied to
tmp_path (gpudev/standin_admin.py), whose recorded calls show the
reference's phase order (SURVEY.md §3.2-3.3)."""

import ctypes
import http.server
import os
import shutil
import threading

import pytest

from tpu_cc_manager_torch.gpudev import nvml as nvml_mod
from tpu_cc_manager_torch.gpudev import pci, standin_admin
from tpu_cc_manager_torch.gpudev.admin import AdminTools, load_module
from tpu_cc_manager_torch.gpudev.contract import (
    MODE_DEVTOOLS,
    MODE_OFF,
    MODE_ON,
    MODE_PPCIE,
    GpuError,
)
from tpu_cc_manager_torch.gpudev.h100 import H100Backend
from tpu_cc_manager_torch.gpudev.nvml import Nvml, NvmlError

H100 = "NVIDIA H100 80GB HBM3"
GPU_BDFS = ["0000:18:00.0", "0000:2a:00.0"]
SWITCH_BDFS = ["0000:05:00.0"]
# Every class of device a node's sysfs shows: only NVIDIA GPUs (0x0302xx,
# 0x0300xx) and NVSwitches (0x068000) count.
SYSFS = [
    ("0000:2a:00.0", 0x10DE, 0x030200, 0x2330),
    ("0000:18:00.0", 0x10DE, 0x030000, 0x2330),
    ("0000:05:00.0", 0x10DE, 0x068000, 0x22A3),
    ("0000:18:00.1", 0x10DE, 0x040300, 0x22BA),  # NVIDIA HD audio
    ("0000:00:1f.0", 0x8086, 0x030000, 0x1234),  # another vendor's VGA
    ("0000:3b:00.0", 0x15B3, 0x020700, 0x1021),  # a NIC
]


def write_sysfs(root, entries=SYSFS):
    for bdf, vendor, cls, device in entries:
        d = root / "bus" / "pci" / "devices" / bdf
        d.mkdir(parents=True)
        (d / "vendor").write_text(f"{vendor:#06x}\n")
        (d / "class").write_text(f"{cls:#08x}\n")
        (d / "device").write_text(f"{device:#06x}\n")
    (root / "bus" / "pci" / "devices" / "garbage").mkdir()


class FakeNvmlLib:
    """NVML's C functions in Python, over the stand-in's state: the system
    CC state follows its committed modes (``override`` replaces it), the
    GPUs answer by PCI address, and the attestation calls refuse with
    NVML_ERROR_NOT_SUPPORTED while CC is off. ``signer(nonce) -> (report,
    certs)`` makes the evidence when CC is on."""

    def __init__(self, admin_dir, gpus=tuple(GPU_BDFS), signer=None):
        self.admin_dir = admin_dir
        self.gpus = list(gpus)
        self.signer = signer
        self.override = None
        self.missing = set()
        self.calls = []

    def _state(self):
        return self.override or standin_admin.cc_state(self.admin_dir)

    def nvmlInit_v2(self):
        self.calls.append("init")
        return 0

    def nvmlShutdown(self):
        self.calls.append("shutdown")
        return 0

    def nvmlErrorString(self, rc):
        return {3: b"Not Supported", 6: b"Not Found", 25: b"Argument Version Mismatch"}.get(
            rc, b"Unknown Error")

    def nvmlDeviceGetCount_v2(self, count):
        count.contents.value = len(self.gpus)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        if index >= len(self.gpus):
            return 2
        handle.contents.value = index + 1
        return 0

    def nvmlDeviceGetHandleByPciBusId_v2(self, bus_id, handle):
        bdf = bus_id.decode()
        if bdf not in self.gpus or bdf in self.missing:
            return 6
        handle.contents.value = self.gpus.index(bdf) + 1
        return 0

    def nvmlDeviceGetName(self, handle, buf, size):
        buf.value = H100.encode()
        return 0

    def nvmlDeviceGetVbiosVersion(self, handle, buf, size):
        buf.value = b"96.00.DA.00.0C"
        return 0

    def nvmlSystemGetDriverVersion(self, buf, size):
        buf.value = b"580.159.03"
        return 0

    def nvmlDeviceGetPciInfo_v3(self, handle, info):
        info.contents.busId = ("0000" + self.gpus[handle.value - 1].upper()).encode()
        return 0

    def nvmlSystemGetConfComputeCapabilities(self, caps):
        caps.contents.cpuCaps, caps.contents.gpusCaps = 0, 1
        return 0

    def nvmlSystemGetConfComputeState(self, state):
        s = self._state()
        state.contents.environment = s["environment"]
        state.contents.ccFeature = s["feature"]
        state.contents.devToolsMode = s["devtools"]
        return 0

    def nvmlSystemGetConfComputeSettings(self, settings):
        if settings.contents.version != nvml_mod.SYSTEM_CONF_COMPUTE_SETTINGS_V1:
            return 25
        s = self._state()
        settings.contents.environment = s["environment"]
        settings.contents.ccFeature = s["feature"]
        settings.contents.devToolsMode = s["devtools"]
        settings.contents.multiGpuMode = s["multi_gpu"]
        return 0

    def nvmlSystemGetConfComputeGpusReadyState(self, ready):
        ready.contents.value = 0
        return 0

    def nvmlDeviceGetConfComputeGpuAttestationReport(self, handle, out):
        if not self._state()["feature"] or self.signer is None:
            return 3
        report, _ = self.signer(bytes(out.contents.nonce))
        ctypes.memmove(out.contents.attestationReport, report, len(report))
        out.contents.attestationReportSize = len(report)
        return 0

    def nvmlDeviceGetConfComputeGpuCertificate(self, handle, out):
        if not self._state()["feature"] or self.signer is None:
            return 3
        _, certs = self.signer(b"\0" * 32)
        ctypes.memmove(out.contents.attestationCertChain, certs, len(certs))
        out.contents.attestationCertChainSize = len(certs)
        return 0


class Rig:
    """An H100 node on injected parts: the sysfs tree, the stand-in admin
    library and NVML over it, and the backend's state directory."""

    def __init__(self, tmp_path, mode=MODE_OFF, signer=None, switch_ppcie=True):
        self.tmp_path = tmp_path
        self.admin_dir = str(tmp_path / "admin")
        os.makedirs(self.admin_dir)
        shutil.copy(standin_admin.__file__, self.admin_dir)
        ppcie = "on" if mode == MODE_PPCIE else "off"
        cc = MODE_OFF if mode == MODE_PPCIE else mode
        standin_admin.write_state(self.admin_dir, [
            *(standin_admin.device_state(b, H100, cc=cc, ppcie=ppcie) for b in GPU_BDFS),
            *(standin_admin.device_state(b, "NVIDIA NVSwitch", kind="nvswitch", ppcie=ppcie,
                                         ppcie_supported=switch_ppcie) for b in SWITCH_BDFS)])
        write_sysfs(tmp_path / "sys")
        self.lib = FakeNvmlLib(self.admin_dir, signer=signer)
        self.backend = self.new_backend()

    def new_backend(self):
        return H100Backend(
            state_dir=str(self.tmp_path / "state"),
            admin=AdminTools(path=self.admin_dir, module="standin_admin"),
            nvml=Nvml(lib=self.lib), sysfs_root=str(self.tmp_path / "sys"),
            dev_root=str(self.tmp_path / "dev"), metadata_url="http://127.0.0.1:1",
            node_id="h100-node-0", reset_parallelism_override=2)

    def calls(self, ops=("set_cc_mode", "set_ppcie_mode", "reset_with_os", "wait_for_boot",
                         "query_ppcie_mode")):
        return [tuple(c) for c in standin_admin.read_state(self.admin_dir)["calls"]
                if c[0] in ops]

    def clear_calls(self):
        state = standin_admin.read_state(self.admin_dir)
        standin_admin.write_state(self.admin_dir, state["devices"], state["fail"])

    def flip(self, mode):
        """The manager's call sequence; returns the verified modes."""
        topo = self.backend.discover()
        devices = topo.devices if mode == MODE_OFF else topo.cc_capable_devices()
        self.backend.stage_cc_mode(devices, mode)
        self.backend.reset(devices)
        self.backend.wait_ready(devices, timeout_s=30)
        return [self.backend.query_cc_mode(d) for d in devices]


def test_discovery_by_class_code(tmp_path):
    write_sysfs(tmp_path / "sys")
    found = pci.scan(str(tmp_path / "sys"))
    assert [(f.bdf, f.kind) for f in found] == [
        ("0000:05:00.0", "nvswitch"), ("0000:18:00.0", "gpu"), ("0000:2a:00.0", "gpu")]
    assert pci.pci_bus_present(str(tmp_path / "sys"))
    assert pci.scan(str(tmp_path / "nothing")) == [] and not pci.pci_bus_present(
        str(tmp_path / "nothing"))
    rig = Rig(tmp_path / "rig")
    topo = rig.backend.discover()
    assert [(d.index, d.bdf, d.kind) for d in topo.all_devices] == [
        (0, "0000:18:00.0", "gpu"), (1, "0000:2a:00.0", "gpu"), (2, "0000:05:00.0", "nvswitch")]
    assert topo.variant == "h100-sxm" and topo.node_id == "h100-node-0"
    assert [d.cc_supported for d in topo.all_devices] == [True, True, False]
    assert topo.ppcie_capable_devices() == topo.all_devices


def test_discovery_refuses_disagreeing_sources(tmp_path):
    rig = Rig(tmp_path)
    shutil.rmtree(tmp_path / "sys" / "bus" / "pci" / "devices" / "0000:2a:00.0")
    with pytest.raises(GpuError, match="sysfs lists .* but gpu-admin-tools lists"):
        rig.backend.discover()
    empty = H100Backend(state_dir=str(tmp_path / "s2"), admin=rig.backend.admin,
                        nvml=rig.backend.nvml, sysfs_root=str(tmp_path / "none"))
    with pytest.raises(GpuError, match="no NVIDIA GPU or NVSwitch"):
        empty.discover()


def test_on_follows_the_reference_order(tmp_path):
    rig = Rig(tmp_path)
    assert rig.flip(MODE_ON) == [MODE_ON, MODE_ON]
    calls = rig.calls(("set_cc_mode", "set_ppcie_mode", "reset_with_os", "wait_for_boot"))
    assert calls[:2] == [("set_cc_mode", b, "on") for b in GPU_BDFS]  # staging writes through
    assert sorted(calls[2:4]) == [("reset_with_os", b, None) for b in GPU_BDFS]
    assert sorted(calls[4:]) == [("wait_for_boot", b, None) for b in GPU_BDFS]
    assert [op for op, _ in rig.backend.op_log][:4] == ["discover", "set_cc", "set_cc", "stage"]


def test_off_from_ppcie_runs_the_prephase_first(tmp_path):
    """No set before the PPCIe-off pre-phase verified, no reset before
    every set."""
    rig = Rig(tmp_path, mode=MODE_PPCIE)
    topo = rig.backend.discover()
    rig.backend.stage_cc_mode(topo.devices, MODE_OFF)
    assert rig.calls(("set_cc_mode", "set_ppcie_mode", "reset_with_os")) == []  # recorded only
    rig.clear_calls()
    rig.backend.reset(topo.devices)
    rig.backend.wait_ready(topo.devices, timeout_s=30)
    calls = rig.calls()
    all_bdfs = sorted(GPU_BDFS + SWITCH_BDFS)
    mutating = [c for c in calls if c[0] != "query_ppcie_mode"]
    assert sorted(mutating[:3]) == [("set_ppcie_mode", b, "off") for b in all_bdfs]
    assert sorted(mutating[3:6]) == [("reset_with_os", b, None) for b in all_bdfs]
    assert sorted(mutating[6:9]) == [("wait_for_boot", b, None) for b in all_bdfs]
    assert mutating[9:11] == [("set_cc_mode", b, "off") for b in GPU_BDFS]
    assert sorted(mutating[11:13]) == [("reset_with_os", b, None) for b in GPU_BDFS]
    assert sorted(mutating[13:]) == [("wait_for_boot", b, None) for b in GPU_BDFS]
    # The pre-phase's verify reads every device back between its boot and the first set.
    last_boot = calls.index(mutating[8])
    first_set = calls.index(mutating[9])
    assert sorted(c[1] for c in calls[last_boot + 1:first_set]) == all_bdfs
    assert all(c[0] == "query_ppcie_mode" for c in calls[last_boot + 1:first_set])
    assert [rig.backend.query_cc_mode(d) for d in topo.all_devices] == [MODE_OFF] * 3


def test_ppcie_stages_and_resets_the_switches(tmp_path):
    rig = Rig(tmp_path, mode=MODE_ON)
    assert rig.flip(MODE_PPCIE) == [MODE_PPCIE, MODE_PPCIE]
    calls = rig.calls(("set_cc_mode", "set_ppcie_mode", "reset_with_os", "wait_for_boot"))
    sets = [c for c in calls if c[0].startswith("set_")]
    assert sets == [("set_cc_mode", GPU_BDFS[0], "off"), ("set_ppcie_mode", GPU_BDFS[0], "on"),
                    ("set_cc_mode", GPU_BDFS[1], "off"), ("set_ppcie_mode", GPU_BDFS[1], "on"),
                    ("set_ppcie_mode", SWITCH_BDFS[0], "on")]
    assert calls[:5] == sets
    assert sorted(b for op, b, _ in calls if op == "reset_with_os") == sorted(
        GPU_BDFS + SWITCH_BDFS)
    assert sorted(b for op, b, _ in calls[-3:]) == sorted(GPU_BDFS + SWITCH_BDFS)
    assert rig.backend.query_cc_mode(rig.backend.discover().switches[0]) == MODE_PPCIE


def test_ppcie_needs_every_device(tmp_path):
    rig = Rig(tmp_path, switch_ppcie=False)
    topo = rig.backend.discover()
    with pytest.raises(GpuError, match="1 lack it: 0000:05:00.0"):
        rig.backend.stage_cc_mode(topo.devices, MODE_PPCIE)
    assert rig.calls(("set_cc_mode", "set_ppcie_mode")) == []


def test_clear_staged_writes_the_committed_mode_back(tmp_path):
    rig = Rig(tmp_path, mode=MODE_DEVTOOLS)
    topo = rig.backend.discover()
    rig.backend.stage_cc_mode(topo.devices, MODE_ON)
    rig.backend.clear_staged(topo.devices)
    assert rig.calls(("set_cc_mode",)) == [
        ("set_cc_mode", GPU_BDFS[0], "on"), ("set_cc_mode", GPU_BDFS[1], "on"),
        ("set_cc_mode", GPU_BDFS[0], "devtools"), ("set_cc_mode", GPU_BDFS[1], "devtools")]
    rig.backend.reset(topo.devices)  # nothing staged: the devices keep their mode
    assert [rig.backend.query_cc_mode(d) for d in topo.devices] == [MODE_DEVTOOLS] * 2
    rig.backend.clear_staged(topo.devices)  # idempotent
    assert rig.backend.op_log[-1] == ("clear_staged", ())


def test_failed_wait_for_boot_names_the_device(tmp_path):
    rig = Rig(tmp_path)
    state = standin_admin.read_state(rig.admin_dir)
    standin_admin.write_state(rig.admin_dir, state["devices"],
                              {f"wait_for_boot:{GPU_BDFS[1]}": 1})
    with pytest.raises(GpuError, match=f"wait_for_boot.* on {GPU_BDFS[1]} failed"):
        rig.flip(MODE_ON)


def test_a_booted_gpu_without_an_nvml_handle_fails_wait_ready(tmp_path):
    rig = Rig(tmp_path)
    rig.lib.missing.add(GPU_BDFS[0])
    with pytest.raises(GpuError, match=f"{GPU_BDFS[0]} booted but NVML has no handle.*code 6"):
        rig.flip(MODE_ON)


def test_nvml_and_admin_disagreement_is_caught(tmp_path):
    rig = Rig(tmp_path)
    device = rig.backend.discover().devices[0]
    assert rig.backend.query_cc_mode(device) == MODE_OFF
    rig.lib.override = {"environment": 2, "feature": 1, "devtools": 0, "multi_gpu": 0}
    with pytest.raises(GpuError, match="reads CC mode 'off' but NVML's system CC state says 'on'"):
        rig.backend.query_cc_mode(device)


def test_staged_state_survives_a_restart(tmp_path):
    rig = Rig(tmp_path, mode=MODE_PPCIE)
    topo = rig.backend.discover()
    rig.backend.stage_cc_mode(topo.devices, MODE_ON)  # recorded: the pre-phase is pending
    restarted = rig.new_backend()
    restarted.reset(restarted.discover().devices)
    assert [restarted.query_cc_mode(d) for d in topo.all_devices] == [MODE_ON, MODE_ON, MODE_OFF]
    # A reset that fails part way leaves every device reading "resetting",
    # for this process and the next, until a reset finishes.
    state = standin_admin.read_state(rig.admin_dir)
    standin_admin.write_state(rig.admin_dir, state["devices"],
                              {f"reset_with_os:{GPU_BDFS[0]}": 1})
    restarted.stage_cc_mode(topo.devices, MODE_DEVTOOLS)
    with pytest.raises(GpuError):
        restarted.reset(topo.devices)
    assert [rig.new_backend().query_cc_mode(d) for d in topo.devices] == ["resetting"] * 2
    assert rig.flip(MODE_DEVTOOLS) == [MODE_DEVTOOLS] * 2


def test_fetch_attestation_with_cc_off_raises(tmp_path):
    rig = Rig(tmp_path)
    rig.backend.discover()
    with pytest.raises(NvmlError) as err:
        rig.backend.fetch_attestation("nonce-a")
    assert err.value.code == nvml_mod.NVML_ERROR_NOT_SUPPORTED
    assert "nvmlDeviceGetConfComputeGpuAttestationReport" in str(err.value)
    assert "attest" not in [op for op, _ in rig.backend.op_log]


def test_nvml_bindings_follow_the_header(tmp_path):
    sizes = {nvml_mod.PciInfo: 16 + 5 * 4 + 32,
             nvml_mod.ConfComputeGpuAttestationReport: 3 * 4 + 0x20 + 0x2000 + 0x1000,
             nvml_mod.ConfComputeGpuCertificate: 2 * 4 + 0x1000 + 0x1400,
             nvml_mod.SystemConfComputeSettings: 5 * 4}
    assert {k: ctypes.sizeof(k) for k in sizes} == sizes
    assert nvml_mod.SYSTEM_CONF_COMPUTE_SETTINGS_V1 == 20 | (1 << 24)
    rig = Rig(tmp_path)
    with Nvml(lib=rig.lib) as nvml:
        handle = nvml.handle_by_index(1)
        assert (nvml.device_count(), nvml.name(handle), nvml.bdf(handle)) == (2, H100, GPU_BDFS[1])
        assert nvml.cc_capabilities() == {"cpu": 0, "gpus": 1}
        assert nvml.cc_mode() == MODE_OFF and nvml.gpus_ready_state() == 0
        with pytest.raises(NvmlError, match=r"nvmlDeviceGetHandleByPciBusId_v2 failed: NVML "
                                            r"return code 6 \(Not Found\)"):
            nvml.handle_by_bdf("0000:99:00.0")
    rig.lib.nvmlSystemGetConfComputeSettings = None  # an older driver's NVML
    assert Nvml(lib=rig.lib).cc_settings() is None
    assert nvml_mod.mode_from_state({"feature": 1, "devtools": 1}) == MODE_DEVTOOLS
    assert nvml_mod.mode_from_state({"feature": 0, "devtools": 0}, {"multi_gpu": 1}) == MODE_PPCIE


def test_health_probe_tiers(tmp_path):
    rig = Rig(tmp_path)
    rig.backend.discover()
    probe = rig.backend.probe_runtime_health()
    assert (probe.tier, probe.healthy) == ("probe-cmd", True)
    rig.lib.missing.add(GPU_BDFS[1])
    assert not rig.backend.probe_runtime_health().healthy
    rig.backend.nvml = Nvml(library=str(tmp_path / "no-libnvidia-ml.so.1"))
    assert rig.backend.probe_runtime_health().tier == "none"
    (tmp_path / "dev").mkdir()
    (tmp_path / "dev" / "nvidia0").touch()
    probe = rig.backend.probe_runtime_health()
    assert (probe.tier, probe.healthy, probe.strength) == ("device-node", True, 1)


def test_preemption_notice_reads_the_metadata_flag(tmp_path):
    rig = Rig(tmp_path)
    assert rig.backend.preemption_notice() is False  # unreachable: not preempted

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            ok = (self.path == "/instance/preempted"
                  and self.headers.get("Metadata-Flavor") == "Google")
            self.send_response(200 if ok else 404)
            self.end_headers()
            self.wfile.write(b"TRUE" if ok else b"")

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rig.backend.metadata_url = f"http://127.0.0.1:{server.server_port}"
        assert rig.backend.preemption_notice() is True
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


def test_admin_library_errors(tmp_path):
    with pytest.raises(GpuError, match="gpu-admin-tools not found"):
        load_module(str(tmp_path), "nvidia_gpu_tools")
    (tmp_path / "broken.py").write_text("raise ImportError('no pci access')\n")
    with pytest.raises(GpuError, match="failed to import"):
        load_module(str(tmp_path), "broken")
    (tmp_path / "partial.py").write_text("class GpuError(Exception):\n    pass\n")
    with pytest.raises(GpuError, match="has no find_gpus"):
        load_module(str(tmp_path), "partial")
