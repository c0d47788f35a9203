"""The port's device layer under the unchanged CCManager.

A small adapter (below) shows a port backend to the manager as a
``TpuCcBackend``: each GPU a ``TpuChip`` whose ``device_path`` is its PCI
address, the node a one-host slice, the label mode ``slice`` as ``ppcie``,
and every GpuError as a TpuError (the manager catches only TpuError).
Each case of one mode x fault matrix runs on the JAX ``FakeTpuBackend`` and
on the adapted ``FakeGpuBackend`` and must give the same result, the same
label sequence and the same order of backend calls. Then a flip verifies an
``h100`` quote from injected NVML through the JAX verifier, with the port's
checker registered, and one flip verifies through the port's CPU smoke."""

import contextlib
import dataclasses

import pytest

from test_torch_gpudev_real import GPU_BDFS, Rig
from tpu_cc_manager.ccmanager.manager import CCManager
from tpu_cc_manager.kubeclient.api import node_labels
from tpu_cc_manager.labels import (
    CC_FAILED_REASON_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    MODE_DEVTOOLS,
    MODE_OFF,
    MODE_ON,
    MODE_SLICE,
    STATE_FAILED,
)
from tpu_cc_manager.tpudev import attestation as jax_attestation
from tpu_cc_manager.tpudev.contract import (
    AttestationQuote,
    HealthProbe,
    SliceTopology,
    TpuCcBackend,
    TpuChip,
    TpuError,
)
from tpu_cc_manager.tpudev.fake import FakeTpuBackend
from tpu_cc_manager.utils.metrics import MetricsRegistry
from tpu_cc_manager_torch.gpudev import attestation
from tpu_cc_manager_torch.gpudev.contract import MODE_PPCIE, GpuError
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend, sign_fake_quote
from tpu_cc_manager_torch.smoke import runner as port_runner

NODE = "gpu-node-0"


def to_gpu_mode(mode: str) -> str:
    return MODE_PPCIE if mode == MODE_SLICE else mode


def to_label_mode(mode: str) -> str:
    return MODE_SLICE if mode == MODE_PPCIE else mode


class GpuAdapter(TpuCcBackend):
    """CCManager's ``TpuCcBackend`` over a port ``GpuCcBackend``. A GPU can
    join the node's PPCIe domain only when every NVSwitch can, so that is
    its ``slice_cc_supported``: the manager's all-chips rule then covers
    the switches it never sees."""

    def __init__(self, gpu) -> None:
        self.gpu = gpu
        self._devices = {}

    @contextlib.contextmanager
    def _as_tpu_errors(self):
        try:
            yield
        except GpuError as e:
            raise TpuError(str(e)) from e

    def _devs(self, chips):
        return tuple(self._devices[c.device_path] for c in chips)

    def discover(self):
        with self._as_tpu_errors():
            topo = self.gpu.discover()
        self._devices = {d.bdf: d for d in topo.all_devices}
        fabric = all(s.ppcie_supported for s in topo.switches)
        chips = tuple(TpuChip(index=d.index, device_path=d.bdf, chip_type=topo.variant,
                              cc_supported=d.cc_supported,
                              slice_cc_supported=d.ppcie_supported and fabric)
                      for d in topo.devices)
        return SliceTopology(slice_id=topo.node_id, accelerator_type=topo.variant,
                             num_hosts=1, host_index=0, chips=chips)

    def query_cc_mode(self, chip):
        with self._as_tpu_errors():
            return to_label_mode(self.gpu.query_cc_mode(self._devices[chip.device_path]))

    def stage_cc_mode(self, chips, mode):
        with self._as_tpu_errors():
            self.gpu.stage_cc_mode(self._devs(chips), to_gpu_mode(mode))

    def clear_staged(self, chips):
        with self._as_tpu_errors():
            self.gpu.clear_staged(self._devs(chips))

    def reset(self, chips):
        with self._as_tpu_errors():
            self.gpu.reset(self._devs(chips))

    def wait_ready(self, chips, timeout_s):
        with self._as_tpu_errors():
            self.gpu.wait_ready(self._devs(chips), timeout_s)

    def fetch_attestation(self, nonce):
        with self._as_tpu_errors():
            quote = self.gpu.fetch_attestation(nonce)
        mode = to_label_mode(quote.mode)
        if mode != quote.mode:
            measurements = {**quote.measurements, "cc_mode": mode}
            # The fake's HMAC covers the mode; the h100 evidence does not.
            signature = (sign_fake_quote(quote.slice_id, nonce, mode, measurements)
                         if quote.platform == "fake" else quote.signature)
            quote = dataclasses.replace(quote, mode=mode, measurements=measurements,
                                        signature=signature)
        return AttestationQuote(**dataclasses.asdict(quote))

    def prepare_attestation(self):
        with self._as_tpu_errors():
            self.gpu.prepare_attestation()

    def probe_runtime_health(self):
        with self._as_tpu_errors():
            probe = self.gpu.probe_runtime_health()
        return HealthProbe(probe.tier, probe.healthy, probe.detail)

    def restart_runtime(self):
        with self._as_tpu_errors():
            self.gpu.restart_runtime()

    def preemption_notice(self):
        with self._as_tpu_errors():
            return self.gpu.preemption_notice()


CONTRACT = ("discover", "query_cc_mode", "stage_cc_mode", "clear_staged", "reset",
            "wait_ready", "fetch_attestation", "prepare_attestation",
            "probe_runtime_health", "restart_runtime", "preemption_notice")


def record_calls(backend) -> list:
    """Log every contract call the manager makes on ``backend``."""
    calls = []
    for name in CONTRACT:
        def wrapper(*args, _fn=getattr(backend, name), _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)
        setattr(backend, name, wrapper)
    return calls


def drive(fake_kube, backend, mode, allow_fake=True, smoke_workload="none", smoke_runner=None):
    """One set_cc_mode through a fresh manager: (result, labels, calls)."""
    fake_kube.add_node(NODE)
    labels = []

    def on_patch(name, node):
        got = node_labels(node)
        step = tuple(got.get(k) for k in (CC_MODE_STATE_LABEL, CC_READY_STATE_LABEL,
                                          CC_FAILED_REASON_LABEL))
        if not labels or labels[-1] != step:
            labels.append(step)

    fake_kube.add_patch_reactor(on_patch)
    calls = record_calls(backend)
    mgr = CCManager(api=fake_kube, backend=backend, node_name=NODE,
                    operator_namespace="tpu-operator", evict_components=False,
                    smoke_workload=smoke_workload, smoke_runner=smoke_runner,
                    allow_fake_quotes=allow_fake, metrics=MetricsRegistry(),
                    eviction_timeout_s=1, eviction_poll_interval_s=0.01)
    try:
        result = mgr.set_cc_mode(mode)
    except SystemExit as e:  # the mixed-capability exit (manager.py:1040-1054)
        result = f"exit {e.code}"
    # prepare_attestation overlaps wait_ready on a thread: its place in the
    # order is not fixed, its count is.
    order = [c for c in calls if c != "prepare_attestation"]
    return result, labels, order, calls.count("prepare_attestation")


FAULTS = {"none": None, "stage": "stage", "reset": "reset", "wait": "wait_ready",
          "attest": "attest", "mixed-capability": None}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("mode", [MODE_ON, MODE_OFF, MODE_DEVTOOLS, MODE_SLICE])
def test_parity_with_the_jax_fake(fake_kube, mode, fault):
    """Four chips on both sides (the port's node also has two NVSwitches
    the manager never sees); smokes off, so each case runs in well under a
    second."""
    initial = MODE_ON if mode == MODE_OFF else MODE_OFF
    cc = [True, True, False, False] if fault == "mixed-capability" else True
    jax_backend = FakeTpuBackend(num_chips=4, cc_supported=cc, initial_mode=initial)
    port = FakeGpuBackend(num_gpus=4, num_switches=2, cc_supported=cc, initial_mode=initial)
    if FAULTS[fault]:
        jax_backend.fail_next(FAULTS[fault])
        port.fail_next(FAULTS[fault])
    want = drive(fake_kube, jax_backend, mode)
    from tpu_cc_manager.kubeclient.fake import FakeKube

    got = drive(FakeKube(), GpuAdapter(port), mode)
    assert got == want
    if fault == "none":
        assert want[0] is True and want[1][-1][0] == mode
        if mode == MODE_SLICE:  # the fabric went with the GPUs
            assert port.op_log[-3] == ("reset", (0, 1, 2, 3, 4, 5))
    elif fault == "mixed-capability":
        # CC modes exit as the reference does; off and slice select no CC set.
        assert want[0] == ("exit 1" if mode in (MODE_ON, MODE_DEVTOOLS) else True)
    elif fault == "attest" and mode == MODE_OFF:
        assert want[0] is True  # CC off attests nothing
    else:
        assert want[0] is False and want[1][-1][0] == STATE_FAILED


def test_a_switch_without_ppcie_refuses_slice_mode(fake_kube):
    port = FakeGpuBackend(num_gpus=4, num_switches=2, ppcie_supported=[True] * 5 + [False])
    result, labels, calls, _ = drive(fake_kube, GpuAdapter(port), MODE_SLICE)
    assert result is False
    assert labels[-1] == (STATE_FAILED, labels[-1][1], "slice-mode-unsupported")
    assert "stage_cc_mode" not in calls and "reset" not in calls


@pytest.mark.parametrize("root", ["operator's", "foreign"])
def test_an_h100_quote_verifies_through_the_jax_verifier(fake_kube, tmp_path, monkeypatch, root):
    pytest.importorskip("cryptography")
    from test_torch_gpudev_attestation import Signer

    signer = Signer()
    monkeypatch.setitem(jax_attestation._SIGNATURE_CHECKS, "h100",
                        attestation.check_h100_signature)
    chosen = signer if root == "operator's" else Signer()
    monkeypatch.setenv(attestation.ROOT_CERT_ENV, chosen.write_root(tmp_path / "root.pem"))
    rig = Rig(tmp_path / "rig", signer=signer)
    adapter = GpuAdapter(rig.backend)
    result, labels, calls, _ = drive(fake_kube, adapter, MODE_ON, allow_fake=False)
    nonces = [payload for op, payload in rig.backend.op_log if op == "attest"]
    assert len(nonces) == 1 and calls.count("fetch_attestation") == 1
    if root == "operator's":
        assert result is True and labels[-1][0] == MODE_ON
        assert [adapter.query_cc_mode(c) for c in adapter.discover().chips] == [MODE_ON] * 2
    else:
        assert result is False and labels[-1][0] == STATE_FAILED
    # The flip ran the reference's phases on the stand-in: sets, resets, boots.
    kinds = [op for op, _, _ in rig.calls(("set_cc_mode", "reset_with_os", "wait_for_boot"))]
    assert kinds[:len(GPU_BDFS)] == ["set_cc_mode"] * len(GPU_BDFS)
    assert kinds[len(GPU_BDFS):] == (["reset_with_os"] * len(GPU_BDFS)
                                     + ["wait_for_boot"] * len(GPU_BDFS))


def test_a_flip_verifies_through_the_port_smoke(fake_kube):
    results = []

    def smoke(workload):
        result = port_runner.run_workload_subprocess(
            workload, force_cpu=True, extra_env={"OMP_NUM_THREADS": "1"})
        results.append(result)
        return result

    port = FakeGpuBackend(num_gpus=2, num_switches=1)
    result, labels, calls, _ = drive(fake_kube, GpuAdapter(port), MODE_ON,
                                     smoke_workload="matmul", smoke_runner=smoke)
    assert result is True and labels[-1][0] == MODE_ON
    assert [r["workload"] for r in results] == ["matmul"]
    assert results[0]["ok"] is True and results[0]["per_device"][0]["bdf"] is None
