"""``python -m tpu_cc_manager_torch`` as a process against
``hack/mock_apiserver.py`` (``ccmanager/localrig.py``), as
``hack/demo_local.sh`` drives the JAX agent: a flip to ``on`` drains the
operator's components, flips the fake node, attests, runs the verify smoke
on the CPU (the explicit ``CC_SMOKE_DEVICE=cpu`` request) through the
warmup path and re-admits, with each of the three smokes (matmul, llama and
resnet at their CPU sizes); a bogus mode fails soft with the agent alive;
SIGTERM exits 0; and the ``h100`` backend on a host with no GPU exits
non-zero instead of carrying on with the fake. The tests of this file share
one agent with the matmul smoke and run in order; the other smokes' flips
each start an agent on a rig of their own. Two agents as the two hosts of
one slice meet at the slice commit barrier on a rig of two nodes, as
``hack/demo_multihost.sh`` drives two JAX agents."""

import contextlib
import signal
import time

import pytest

from tpu_cc_manager_torch.ccmanager import localrig
from tpu_cc_manager_torch.labels import (
    CC_FAILED_REASON_LABEL,
    CC_MODE_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    DRAIN_COMPONENT_LABELS,
    MODE_SLICE,
    SLICE_ID_LABEL,
    SLICE_STAGED_LABEL,
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


def start_agent(rig, workload: str):
    """The agent CLI with ``workload`` as its verify smoke, serving /metrics."""
    port = free_port()
    proc = rig.start_agent(["--gpu-backend", "fake", "--smoke-workload", workload],
                           metrics_port=port, env=AGENT_ENV)
    if not poll_until(lambda: proc.poll() is not None or localrig.metrics_text(port),
                      60, 0.1) or proc.poll() is not None:
        pytest.fail(f"the agent did not start: {rig.log_of(proc)[-3000:]}")
    proc.metrics_port = port
    return proc


@pytest.fixture(scope="module")
def agent(rig):
    return start_agent(rig, "matmul")


@pytest.mark.parametrize("workload", ["matmul", "llama", "resnet"])
def test_the_agent_flips_the_node_to_on(workload, request, tmp_path):
    with contextlib.ExitStack() as stack:
        if workload == "matmul":
            rig, agent = request.getfixturevalue("rig"), request.getfixturevalue("agent")
        else:
            rig = stack.enter_context(localrig.LocalRig(str(tmp_path / "rig")))
            agent = start_agent(rig, workload)
        flip_to_on(rig, agent, workload)


def flip_to_on(rig, agent, workload: str) -> None:
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
    # The port's smoke, on the CPU because the agent was asked for it, started
    # by the warmup path (its dispatch gated until the node is ready).
    assert f"tpu_cc_manager_torch.smoke --workload {workload} --device cpu" in log
    assert "starting warmup smoke (gated dispatch)" in log
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


@contextlib.contextmanager
def deadline(seconds: float):
    """Raise ``TimeoutError`` in the test once ``seconds`` have passed."""
    def expired(signum, frame):
        raise TimeoutError(f"over {seconds:g} s")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


TWO_HOSTS_S = 150  # the whole demo: two agents' start, the hold, the flip, SIGTERM


def test_two_agents_meet_at_the_slice_barrier(tmp_path):
    """``hack/demo_multihost.sh`` on the port: host 0 labelled alone stages
    and holds at the barrier without committing; once host 1 is labelled
    both nodes read ``slice``, host 0 ready, host 0's ``barrier`` phase
    spans host 1's drain, and both agents exit 0 on SIGTERM."""
    with deadline(TWO_HOSTS_S), localrig.LocalRig(str(tmp_path / "rig"), nodes=2) as rig:
        agents = localrig.start_slice_agents(rig, ["none", "none"], env=AGENT_ENV)
        assert [rig.labels(a.node)[CC_MODE_STATE_LABEL] for a in agents] == ["off", "off"]
        flip = localrig.flip_slice(rig, agents, timeout_s=FLIP_S)
        logs = [rig.log_of(a)[-3000:] for a in agents]
        assert flip["problems"] == [], logs
        assert flip["alone"] == {SLICE_STAGED_LABEL: MODE_SLICE, CC_MODE_STATE_LABEL: "off"}
        for a in agents:
            labels = rig.labels(a.node)
            assert labels[CC_MODE_STATE_LABEL] == MODE_SLICE, logs
            assert labels[SLICE_ID_LABEL] == localrig.SLICE_ID
        phases, _ = localrig.await_phases(agents[0].metrics_port, MODE_SLICE,
                                          ("barrier", "readmit"), 30)
        host1, _ = localrig.await_phases(agents[1].metrics_port, MODE_SLICE,
                                         ("drain", "readmit"), 30)
        # Host 0 waited at the barrier at least while host 1, labelled after
        # the hold, drained.
        assert phases["barrier"] >= host1["drain"] > 0, (phases, host1)
        t0 = time.monotonic()
        for a in agents:
            a.send_signal(signal.SIGTERM)
        assert [a.wait(timeout=GRACE_S + 20) for a in agents] == [0, 0], logs
        assert time.monotonic() - t0 < GRACE_S + 20
        assert not any(rig.readiness_file(a.node).exists() for a in agents)
