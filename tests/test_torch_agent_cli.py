"""``python -m tpu_cc_manager_torch`` as a process against
``hack/mock_apiserver.py`` (``ccmanager/localrig.py``), as
``hack/demo_local.sh`` drives the JAX agent: a flip to ``on`` drains the
operator's components, flips the fake node, attests, runs the matmul smoke
on the CPU (the explicit ``CC_SMOKE_DEVICE=cpu`` request) and re-admits; a
bogus mode fails soft with the agent alive; SIGTERM exits 0; and the
``h100`` backend on a host with no GPU exits non-zero instead of carrying on
with the fake. The tests of this file share one agent and run in order."""

import signal

import pytest

from tpu_cc_manager_torch.ccmanager import localrig
from tpu_cc_manager_torch.labels import (
    CC_FAILED_REASON_LABEL,
    CC_MODE_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    DRAIN_COMPONENT_LABELS,
    STATE_FAILED,
)
from tpu_cc_manager_torch.utils.launch import free_port
from tpu_cc_manager_torch.utils.poll import poll_until

FLIP_S = 90  # deadline of one flip on the CPU (the smoke child takes a few s)
GRACE_S = 10  # the agent's CC_SHUTDOWN_GRACE_S here
# One intra-op thread for the agent's smoke child: the suite's workers share
# the cores with timing-sensitive tests.
AGENT_ENV = {"CC_SMOKE_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
             "CC_SHUTDOWN_GRACE_S": str(GRACE_S)}


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    with localrig.LocalRig(str(tmp_path_factory.mktemp("rig"))) as r:
        yield r


@pytest.fixture(scope="module")
def agent(rig):
    port = free_port()
    proc = rig.start_agent(["--gpu-backend", "fake", "--smoke-workload", "matmul"],
                           metrics_port=port, env=AGENT_ENV)
    if not poll_until(lambda: proc.poll() is not None or localrig.metrics_text(port),
                      60, 0.1) or proc.poll() is not None:
        pytest.fail(f"the agent did not start: {rig.log_of(proc)[-3000:]}")
    proc.metrics_port = port
    return proc


def test_the_agent_flips_the_node_to_on(rig, agent):
    assert all(rig.labels()[k] == "true" for k in DRAIN_COMPONENT_LABELS)
    rig.set_label(CC_MODE_LABEL, "on")
    done = rig.await_labels({CC_MODE_STATE_LABEL: "on", CC_READY_STATE_LABEL: "true"},
                            FLIP_S)
    log = rig.log_of(agent)
    assert done, log[-4000:]
    # Drained and re-admitted: every component label back, every pod back.
    assert poll_until(lambda: len(rig.state()["pods"]) == len(DRAIN_COMPONENT_LABELS), 30, 0.1)
    assert all(rig.labels()[k] == "true" for k in DRAIN_COMPONENT_LABELS)
    want = {"drain", "stage", "reset", "wait_ready", "attest", "smoke", "readmit"}
    phases, _ = localrig.await_phases(agent.metrics_port, "on", want, 30)
    assert want <= set(phases)
    # The port's smoke, on the CPU because the agent was asked for it.
    assert "tpu_cc_manager_torch.smoke --workload matmul --device cpu" in log
    assert "tpu_cc_manager.smoke" not in log


def test_a_bogus_mode_fails_soft_and_the_agent_recovers(rig, agent):
    rig.set_label(CC_MODE_LABEL, "bogus")
    assert rig.await_labels({CC_MODE_STATE_LABEL: STATE_FAILED,
                             CC_FAILED_REASON_LABEL: "invalid-mode"}, FLIP_S), \
        rig.log_of(agent)[-4000:]
    assert agent.poll() is None
    rig.set_label(CC_MODE_LABEL, "on")
    assert rig.await_labels({CC_MODE_STATE_LABEL: "on", CC_FAILED_REASON_LABEL: None},
                            FLIP_S), rig.log_of(agent)[-4000:]


def test_sigterm_exits_zero(rig, agent):
    assert rig.readiness_file().exists()
    agent.send_signal(signal.SIGTERM)  # to ``timeout``, which passes it on
    assert agent.wait(timeout=GRACE_S + 20) == 0
    assert not rig.readiness_file().exists()


def test_h100_without_a_gpu_exits_nonzero(rig):
    from tpu_cc_manager_torch.gpudev import pci

    if pci.scan("/sys"):
        pytest.skip("this host has NVIDIA PCI devices")
    proc = rig.start_agent(["--gpu-backend", "h100"], env=AGENT_ENV)
    assert proc.wait(timeout=60) == 1
    log = rig.log_of(proc)
    assert "h100 backend found no usable device" in log
    assert "fake" not in log.lower()
