"""The GPUs' CC ready state (``CCManager`` over ``NodeBackend``).

On Hopper in a CC mode CUDA holds work back until the GPUs' ready
state is set (``nvmlSystemSetConfComputeGpusReadyState``). The port's
manager sets it right after a verified quote of a CC mode, on the apply
path and on the idempotent re-attestation path, before the smoke, the
warmup's release and the digest fast path. The fake models this: a
reset into a CC mode clears the state, and its stand-in smoke runner
(``FakeGpuBackend.run_smoke``) is refused while it is clear."""

import ctypes

import pytest

from test_torch_gpudev_real import GPU_BDFS, FakeNvmlLib, Rig
from tpu_cc_manager_torch.ccmanager.manager import CCManager
from tpu_cc_manager_torch.ccmanager.node import NodeBackend
from tpu_cc_manager_torch.gpudev import attestation, nvml as nvml_mod
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend
from tpu_cc_manager_torch.gpudev.nvml import Nvml, NvmlError
from tpu_cc_manager_torch.kubeclient.api import node_labels
from tpu_cc_manager_torch.kubeclient.fake import FakeKube
from tpu_cc_manager_torch.labels import (
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    MODE_DEVTOOLS,
    MODE_OFF,
    MODE_ON,
    MODE_SLICE,
    STATE_FAILED,
)
from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

NODE = "gpu-node-0"


def make_manager(kube, fake, **kw):
    kw.setdefault("smoke_workload", "matmul")
    kw.setdefault("smoke_runner", fake.run_smoke)
    kw.setdefault("allow_fake_quotes", True)
    kw.setdefault("metrics", MetricsRegistry())
    return CCManager(api=kube, backend=NodeBackend(fake), node_name=NODE,
                     operator_namespace="tpu-operator", evict_components=False, **kw)


def ops(fake) -> list[str]:
    return [op for op, _ in fake.op_log]


def assert_set_only_after_a_quote(fake) -> None:
    """Every ready-state set directly follows a fetched quote."""
    seq = ops(fake)
    for i, op in enumerate(seq):
        if op == "set_ready":
            assert i > 0 and seq[i - 1] == "attest", seq


def labels_of(kube):
    labels = node_labels(kube.get_node(NODE))
    return labels.get(CC_MODE_STATE_LABEL), labels.get(CC_READY_STATE_LABEL)


class GatedWarmup:
    """A warmup handle whose release runs the fake's stand-in smoke."""

    def __init__(self, fake, workload):
        self.fake, self.workload = fake, workload

    def died_during_warmup(self):
        return False

    def release_and_result(self):
        self.fake.op_log.append(("release", self.workload))
        return {**self.fake.run_smoke(self.workload), "warmup_overlap_s": 0.0,
                "warmup_dispatch_s": 0.0}

    def cancel(self, reason):
        self.fake.op_log.append(("cancel", reason))


@pytest.mark.parametrize("warmup", [False, True], ids=["sync-smoke", "warmup"])
@pytest.mark.parametrize("mode", [MODE_ON, MODE_DEVTOOLS])
def test_a_cc_flip_sets_the_ready_state_after_the_quote(mode, warmup):
    kube, fake = FakeKube(), FakeGpuBackend(num_gpus=2, num_switches=1)
    kube.add_node(NODE)
    kw = {}
    if warmup:
        kw = {"smoke_runner": None,
              "smoke_warmup_factory": lambda workload: GatedWarmup(fake, workload)}
    mgr = make_manager(kube, fake, **kw)
    assert mgr.set_cc_mode(mode) is True
    assert labels_of(kube)[0] == mode
    seq = ops(fake)
    assert seq.count("set_ready") == 1 and seq.count("smoke") == 1
    assert seq.index("reset") < seq.index("attest") < seq.index("set_ready") < seq.index("smoke")
    if warmup:
        assert seq.index("set_ready") < seq.index("release") < seq.index("smoke")
    assert_set_only_after_a_quote(fake)
    assert fake.gpus_ready


def test_slice_mode_sets_it_too():
    """PPCIe (the label mode ``slice``) is a CC mode of the node too."""
    kube, fake = FakeKube(), FakeGpuBackend(num_gpus=2, num_switches=1)
    kube.add_node(NODE)
    assert make_manager(kube, fake).set_cc_mode(MODE_SLICE) is True
    assert labels_of(kube) == (MODE_SLICE, "true")
    assert ops(fake).index("attest") < ops(fake).index("set_ready") < ops(fake).index("smoke")


@pytest.mark.parametrize("how", ["booted-in-cc", "reset-after-flip"])
def test_a_restarted_agent_sets_it_again_after_re_attesting(how):
    """A node that comes back in a CC mode reads its mode as set (no reset),
    but its GPUs are not ready: the restarted agent's re-attestation sets
    the state, so workloads are not left refused."""
    kube = FakeKube()
    kube.add_node(NODE)
    if how == "booted-in-cc":
        fake = FakeGpuBackend(num_gpus=2, num_switches=1, initial_mode=MODE_ON)
    else:
        fake = FakeGpuBackend(num_gpus=2, num_switches=1)
        assert make_manager(kube, fake).set_cc_mode(MODE_ON) is True
        fake.restart_runtime()  # a GPU reset in CC mode: not ready again
    assert not fake.gpus_ready
    before = len(fake.op_log)
    assert make_manager(kube, fake).set_cc_mode(MODE_ON) is True
    after = [op for op, _ in fake.op_log[before:]]
    assert "reset" not in after and "smoke" not in after  # the idempotent path
    assert after.index("attest") < after.index("set_ready")
    assert fake.gpus_ready and fake.run_smoke("matmul")["ok"]
    assert labels_of(kube) == (MODE_ON, "true")


def test_without_the_hunk_the_flip_fails_at_the_smoke(monkeypatch):
    """The parent's code path: nothing sets the ready state, so the verify
    smoke after a flip to on is refused and the node is labelled failed."""
    monkeypatch.setattr(NodeBackend, "set_gpus_ready", lambda self: None)
    kube, fake = FakeKube(), FakeGpuBackend(num_gpus=2, num_switches=1)
    kube.add_node(NODE)
    registry = MetricsRegistry()
    assert make_manager(kube, fake, metrics=registry).set_cc_mode(MODE_ON) is False
    assert labels_of(kube)[0] == STATE_FAILED
    assert [p.name for p in registry.last().phases if not p.ok] == ["smoke"]
    assert "set_ready" not in ops(fake) and "smoke" not in ops(fake)


def sabotage_reset(node):
    """The staged mode never lands: the mode reads back as it was."""
    real = node.gpu.reset

    def reset(devices):
        node.gpu.staged.clear()
        real(devices)

    node.gpu.reset = reset


@pytest.mark.parametrize("fault", ["quote-fetch", "quote-verify", "mode-read-back", "off"])
def test_no_verified_quote_no_ready_state(fault):
    kube, fake = FakeKube(), FakeGpuBackend(num_gpus=2, num_switches=1)
    kube.add_node(NODE)
    kw, mode = {}, MODE_ON
    if fault == "quote-fetch":
        fake.fail_next("attest")
    elif fault == "quote-verify":
        kw["allow_fake_quotes"] = False  # the HMAC quote does not verify
    elif fault == "off":
        fake = FakeGpuBackend(num_gpus=2, num_switches=1, initial_mode=MODE_ON)
        mode = MODE_OFF
    mgr = make_manager(kube, fake, **kw)
    if fault == "mode-read-back":
        sabotage_reset(mgr.backend)
    assert mgr.set_cc_mode(mode) is (fault == "off")
    assert "set_ready" not in ops(fake)
    if fault == "off":
        assert labels_of(kube) == (MODE_OFF, "false") and "smoke" in ops(fake)
    else:
        assert labels_of(kube)[0] == STATE_FAILED and "smoke" not in ops(fake)


def test_a_failed_re_attestation_runs_the_full_apply_before_setting_it():
    """The idempotent path's quote fails: no set there; the full apply's
    verified quote sets it."""
    kube = FakeKube()
    kube.add_node(NODE)
    fake = FakeGpuBackend(num_gpus=2, num_switches=1, initial_mode=MODE_ON)
    fake.fail_next("attest")
    assert make_manager(kube, fake).set_cc_mode(MODE_ON) is True
    seq = ops(fake)
    assert seq.index("reset") < seq.index("attest") < seq.index("set_ready") < seq.index("smoke")
    assert_set_only_after_a_quote(fake)


def test_the_fake_refuses_the_state_with_cc_off():
    fake = FakeGpuBackend(num_gpus=1, num_switches=0)
    assert fake.gpus_ready  # CC off: CUDA work runs
    with pytest.raises(Exception, match="CC off"):
        fake.set_gpus_ready()
    assert "set_ready" not in ops(fake)


class StubLib:
    """The one C entry, recording its argument."""

    def __init__(self, rc=0):
        self.rc, self.args = rc, []

    def nvmlSystemSetConfComputeGpusReadyState(self, state):
        self.args.append(state)
        return self.rc

    def nvmlErrorString(self, rc):
        return b"Insufficient Permissions"


def test_the_nvml_binding_passes_one_and_raises_on_failure():
    lib = StubLib()
    Nvml(lib=lib).set_gpus_ready_state(nvml_mod.NVML_CC_ACCEPTING_CLIENT_REQUESTS_TRUE)
    assert lib.args == [1] and nvml_mod.NVML_CC_ACCEPTING_CLIENT_REQUESTS_TRUE == 1
    lib = StubLib(rc=4)
    with pytest.raises(NvmlError, match="nvmlSystemSetConfComputeGpusReadyState") as e:
        Nvml(lib=lib).set_gpus_ready_state(1)
    assert e.value.code == 4 and "Insufficient Permissions" in str(e.value)
    # The ctypes signature the real library gets: one unsigned int.
    assert nvml_mod._SIGNATURES["nvmlSystemSetConfComputeGpusReadyState"] == [ctypes.c_uint]


class ReadyNvmlLib(FakeNvmlLib):
    """The stand-in NVML with a ready state that the setter changes; the
    setter refuses with CC off, as NVML does."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.ready, self.sets = 0, []

    def nvmlSystemGetConfComputeGpusReadyState(self, ready):
        ready.contents.value = self.ready
        return 0

    def nvmlSystemSetConfComputeGpusReadyState(self, state):
        self.sets.append(state)
        if not self._state()["feature"]:
            return nvml_mod.NVML_ERROR_NOT_SUPPORTED
        self.ready = state
        return 0


@pytest.mark.parametrize("root", ["operator's", "foreign"])
def test_the_h100_backend_sets_it_only_after_its_quote_verifies(tmp_path, monkeypatch, root):
    pytest.importorskip("cryptography")
    from test_torch_gpudev_attestation import Signer

    signer = Signer()
    chosen = signer if root == "operator's" else Signer()
    monkeypatch.setenv(attestation.ROOT_CERT_ENV, chosen.write_root(tmp_path / "root.pem"))
    rig = Rig(tmp_path / "rig", signer=signer)
    rig.lib = ReadyNvmlLib(rig.admin_dir, signer=signer)
    rig.backend = rig.new_backend()
    kube = FakeKube()
    kube.add_node(NODE)
    smokes = []
    mgr = CCManager(api=kube, backend=NodeBackend(rig.backend), node_name=NODE,
                    operator_namespace="tpu-operator", evict_components=False,
                    smoke_workload="matmul", smoke_runner=lambda w: smokes.append(
                        rig.lib.ready) or {"ok": True}, metrics=MetricsRegistry())
    result = mgr.set_cc_mode(MODE_ON)
    seq = [op for op, _ in rig.backend.op_log]
    if root == "operator's":
        assert result is True and rig.lib.sets == [1] and smokes == [1]
        assert seq.index("attest") < seq.index("set_ready")
        assert len(GPU_BDFS) == 2 and labels_of(kube) == (MODE_ON, "true")
    else:
        assert result is False and rig.lib.sets == [] and smokes == []
        assert "set_ready" not in seq and labels_of(kube)[0] == STATE_FAILED


class AtTheGate(Exception):
    """The smoke reached its dispatch gate."""


# CUDA calls that create no context: the runtime's device count and
# properties (cuInit and device queries, no cuCtxCreate or primary context).
CONTEXT_FREE = {"is_available", "device_count", "get_device_name"}


@pytest.mark.parametrize("workload", ["matmul", "llama", "resnet"])
def test_the_warmup_child_creates_no_cuda_context_before_its_gate(workload, monkeypatch):
    """Before its dispatch gate, which the agent opens only after the quote
    verified and the ready state is set, a smoke child may load its kernel
    libraries and query the cards, but must not create a CUDA context (CUDA
    refuses one while the GPUs are not ready). Here on a CPU build of
    torch, any other CUDA call raises, so reaching the gate proves it."""
    import torch

    from tpu_cc_manager_torch.ops import _build
    from tpu_cc_manager_torch.smoke import llama_infer, matmul, resnet_train

    calls = []

    def record(name, value):
        def fn(*args, **kwargs):
            calls.append(name)
            return value
        monkeypatch.setattr(torch.cuda, name, fn)

    record("is_available", True)
    record("device_count", 1)
    record("get_device_name", "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(_build, "load", lambda name: calls.append(f"load {name}"))

    def gate(compile_fns=()):
        for fn in compile_fns:
            fn()
        raise AtTheGate

    module, kwargs = {"matmul": (matmul, {"kernel": "cuda"}), "llama": (llama_infer, {}),
                      "resnet": (resnet_train, {})}[workload]
    monkeypatch.setattr(module, "await_dispatch_gate", gate)
    with pytest.raises(AtTheGate):
        module.run(device="cuda", **kwargs)
    assert set(calls) - {"load matmul", "load flash_attention"} <= CONTEXT_FREE
    loads = {"matmul": ["load matmul"], "llama": ["load flash_attention"], "resnet": []}
    assert [c for c in calls if c.startswith("load")] == loads[workload]
