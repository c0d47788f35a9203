"""The port's agent against the JAX agent.

The port's ``CCManager`` runs over the port's ``FakeGpuBackend`` behind
``ccmanager/node.py::NodeBackend`` and the port's ``FakeKube``; the JAX
``CCManager`` runs over the JAX ``FakeTpuBackend`` and the JAX ``FakeKube``.
Each case must give both sides the same result, the same label sequence
and the same order of backend calls: the mode x fault matrix of
``test_torch_gpudev_agent.py`` (which holds the JAX manager over the port's
backend), a drain of the operator's component pods, smoke failures, and a
crash replayed from the intent journal after a restart."""

import os
import sys
import threading
import types

import pytest

import tpu_cc_manager.ccmanager.intent_journal as jax_intent
import tpu_cc_manager.ccmanager.manager as jax_manager
import tpu_cc_manager.kubeclient.fake as jax_kube
import tpu_cc_manager.labels as jax_labels
import tpu_cc_manager.smoke.runner as jax_runner
import tpu_cc_manager.tpudev.fake as jax_fake
import tpu_cc_manager.utils.metrics as jax_metrics
import tpu_cc_manager_torch.ccmanager.intent_journal as port_intent
import tpu_cc_manager_torch.ccmanager.manager as port_manager
import tpu_cc_manager_torch.kubeclient.fake as port_kube
import tpu_cc_manager_torch.labels as port_labels
import tpu_cc_manager_torch.smoke.runner as port_runner
import tpu_cc_manager_torch.utils.metrics as port_metrics
from tpu_cc_manager.kubeclient.api import node_labels
from tpu_cc_manager.labels import (
    CC_FAILED_REASON_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    DRAIN_COMPONENT_LABELS,
    MODE_DEVTOOLS,
    MODE_OFF,
    MODE_ON,
    MODE_SLICE,
    STATE_FAILED,
)
from test_torch_gpudev_agent import CONTRACT
from tpu_cc_manager_torch.ccmanager.node import NodeBackend
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NODE = "gpu-node-0"
NS = "tpu-operator"
DP_LABEL = "google.com/tpu.deploy.device-plugin"
DP_APP = DRAIN_COMPONENT_LABELS[DP_LABEL]

JAX = types.SimpleNamespace(
    name="jax", manager=jax_manager, kube=jax_kube, metrics=jax_metrics,
    intent=jax_intent, runner=jax_runner, labels=jax_labels,
    backend=lambda num, cc=True, initial=MODE_OFF: jax_fake.FakeTpuBackend(
        num_chips=num, cc_supported=cc, initial_mode=initial))
PORT = types.SimpleNamespace(
    name="port", manager=port_manager, kube=port_kube, metrics=port_metrics,
    intent=port_intent, runner=port_runner, labels=port_labels,
    backend=lambda num, cc=True, initial=MODE_OFF: NodeBackend(FakeGpuBackend(
        num_gpus=num, num_switches=2, cc_supported=cc, initial_mode=initial)))


class Crash(BaseException):
    """A modeled SIGKILL: bypasses the manager's except-Exception paths."""


def fake_of(backend):
    return backend.gpu if isinstance(backend, NodeBackend) else backend


def record_calls(backend, crash_after: str | None = None) -> list:
    """Log every contract call; ``crash_after`` names a call that lands and
    then kills the agent."""
    calls = []
    for name in CONTRACT:
        def wrapper(*args, _fn=getattr(backend, name), _name=name, **kwargs):
            calls.append(_name)
            out = _fn(*args, **kwargs)
            if _name == crash_after:
                raise Crash(_name)
            return out
        setattr(backend, name, wrapper)
    return calls


class LabelLog:
    """The distinct tuples of ``keys`` a node's labels pass through, in the
    apiserver's order. The fake runs patch reactors on the patching thread
    outside its lock, and the manager re-admits on a thread of its own, so
    reactors may run out of order: each patch is placed by its
    resourceVersion."""

    def __init__(self, kube, keys=(CC_MODE_STATE_LABEL, CC_READY_STATE_LABEL,
                                   CC_FAILED_REASON_LABEL)):
        self.keys = keys
        self.patches = []  # (resourceVersion, tuple)
        kube.add_patch_reactor(self._on_patch)

    def _on_patch(self, name, node):
        self.patches.append((int(node["metadata"]["resourceVersion"]),
                             tuple(node_labels(node).get(k) for k in self.keys)))

    def steps(self, since: int = 0) -> list:
        """The distinct tuples of the patches after the first ``since``
        (a mark taken as ``len(log.patches)`` between two flips)."""
        ordered = [step for _, step in sorted(self.patches)]
        out, last = [], ordered[since - 1] if since else None
        for step in ordered[since:]:
            if step != last:
                out.append(step)
            last = step
        return out


def play_daemonsets(kube, node, components: dict, ns: str = NS) -> None:
    """The operator's DaemonSets: a paused component's pods go, a restored
    one's come back. Reactors act on the node as it is now, one at a time."""
    lock = threading.Lock()

    def on_patch(name, _snapshot):
        with lock:
            labels = node_labels(kube.get_node(node))
            for key, app in components.items():
                if labels.get(key) != "true":
                    kube.delete_pods_matching(ns, f"app={app}")
                elif not kube.list_pods(ns, f"app={app}"):
                    kube.add_pod(ns, app, node, labels={"app": app})

    kube.add_patch_reactor(on_patch)


def make_manager(side, kube, backend, **kw):
    kw.setdefault("evict_components", False)
    kw.setdefault("smoke_workload", "none")
    kw.setdefault("allow_fake_quotes", True)
    kw.setdefault("metrics", side.metrics.MetricsRegistry())
    return side.manager.CCManager(
        api=kube, backend=backend, node_name=NODE, operator_namespace=NS,
        eviction_timeout_s=1, eviction_poll_interval_s=0.01, **kw)


def set_mode(mgr, mode):
    try:
        return mgr.set_cc_mode(mode)
    except SystemExit as e:  # the mixed-capability exit (manager.py:1040-1054)
        return f"exit {e.code}"


def split_prepare(calls):
    """prepare_attestation overlaps wait_ready on a thread: its place in the
    order is not fixed, its count is."""
    return [c for c in calls if c != "prepare_attestation"], calls.count("prepare_attestation")


def drive(side, mode, fault=None, cc=True, initial=MODE_OFF):
    kube = side.kube.FakeKube()
    kube.add_node(NODE)
    log = LabelLog(kube)
    backend = side.backend(4, cc, initial)
    if fault:
        fake_of(backend).fail_next(fault)
    calls = record_calls(backend)
    result = set_mode(make_manager(side, kube, backend), mode)
    return (result, log.steps(), *split_prepare(calls))


FAULTS = {"none": None, "stage": "stage", "reset": "reset", "wait": "wait_ready",
          "attest": "attest", "mixed-capability": None}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("mode", [MODE_ON, MODE_OFF, MODE_DEVTOOLS, MODE_SLICE])
def test_matrix_matches_the_jax_agent(mode, fault):
    initial = MODE_ON if mode == MODE_OFF else MODE_OFF
    cc = [True, True, False, False] if fault == "mixed-capability" else True
    want = drive(JAX, mode, FAULTS[fault], cc, initial)
    got = drive(PORT, mode, FAULTS[fault], cc, initial)
    assert got == want
    if fault == "none":
        assert want[0] is True and want[1][-1][0] == mode
    elif fault == "mixed-capability":
        assert want[0] == ("exit 1" if mode in (MODE_ON, MODE_DEVTOOLS) else True)
    elif fault == "attest" and mode == MODE_OFF:
        assert want[0] is True  # CC off attests nothing
    else:
        assert want[0] is False and want[1][-1][0] == STATE_FAILED


def drain(side, mode, fault):
    """A flip with the operator's device plugin on the node, its DaemonSet
    played by a reactor: the device-plugin label's steps, its pods when the
    reset starts and after, and (last, not compared: the manager stages
    while it drains) the backend calls made before each step."""
    kube = side.kube.FakeKube()
    kube.add_node(NODE, {DP_LABEL: "true"})
    kube.add_pod(NS, DP_APP, NODE, labels={"app": DP_APP})
    backend = side.backend(4, initial=MODE_ON if mode == MODE_OFF else MODE_OFF)
    if fault:
        fake_of(backend).fail_next(fault)
    calls = record_calls(backend)

    def pods():
        return [p["metadata"]["name"] for p in kube.list_pods(NS, f"app={DP_APP}")]

    pods_at_reset = []
    reset = backend.reset

    def observed_reset(*args, **kwargs):
        pods_at_reset.append(pods())
        return reset(*args, **kwargs)

    backend.reset = observed_reset
    play_daemonsets(kube, NODE, {DP_LABEL: DP_APP})
    labels = LabelLog(kube)
    dp = LabelLog(kube, keys=(DP_LABEL,))
    calls_at = []
    kube.add_patch_reactor(lambda name, node: calls_at.append(
        (int(node["metadata"]["resourceVersion"]), len(calls))))
    result = set_mode(make_manager(side, kube, backend, evict_components=True), mode)
    made = dict(calls_at)
    steps = [(value, made[rv]) for rv, (value,) in sorted(dp.patches)]
    steps = [s for i, s in enumerate(steps) if i == 0 or s[0] != steps[i - 1][0]]
    return (result, labels.steps(), [value for value, _ in steps], pods_at_reset, pods(),
            *split_prepare(calls), [made for _, made in steps])


@pytest.mark.parametrize("mode,fault", [(MODE_ON, None), (MODE_OFF, None), (MODE_ON, "reset")])
def test_drain_pauses_and_readmits_as_the_jax_agent(mode, fault):
    want = drain(JAX, mode, fault)
    got = drain(PORT, mode, fault)
    assert got[:-1] == want[:-1]
    result, labels, steps, pods_at_reset, pods_after, order, prepared, made = got
    assert result is (fault is None)
    # Paused, pod gone, before the reset; re-admitted, pod back, after the
    # flip's last backend call (a failed flip too).
    assert steps == ["paused-for-tpu-cc-mode-change", "true"]
    assert made[0] <= order.index("reset") and pods_at_reset == [[]]
    assert made[1] == len(order) + prepared and pods_after == [DP_APP]


@pytest.mark.parametrize("error", ["SmokeError", "RuntimeError"])
def test_a_smoke_failure_fails_the_flip_as_the_jax_agent(error):
    def run(side):
        kube = side.kube.FakeKube()
        kube.add_node(NODE)
        log = LabelLog(kube)
        backend = side.backend(4)
        calls = record_calls(backend)
        workloads = []

        def smoke(workload):
            workloads.append(workload)
            exc = side.runner.SmokeError if error == "SmokeError" else RuntimeError
            raise exc("numerics mismatch")

        mgr = make_manager(side, kube, backend, smoke_workload="matmul", smoke_runner=smoke)
        return (set_mode(mgr, MODE_ON), log.steps(), workloads, *split_prepare(calls))

    want, got = run(JAX), run(PORT)
    assert got == want
    reason = "smoke-failed" if error == "SmokeError" else "apply-failed"
    assert got[0] is False and got[1][-1] == (STATE_FAILED, got[1][-1][1], reason)
    assert got[2] == ["matmul"]


def replay_records(side, state_dir):
    """The journal's records without their wall-clock stamps."""
    records = side.intent.IntentJournal.from_state_dir(state_dir).replay().records
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


@pytest.mark.parametrize("crash_after", ["stage_cc_mode", "reset"])
def test_a_crash_replays_from_the_intent_journal_as_the_jax_agent(tmp_path, crash_after):
    """The agent dies right after the stage (or the reset) landed; a new
    agent on the same state dir replays the journal: a staged mode is
    rolled back without a reset, a committed one completes without a
    second reset. Then the new agent converges to the desired mode."""

    def run(side):
        state_dir = str(tmp_path / side.name)
        kube = side.kube.FakeKube()
        kube.add_node(NODE)
        log = LabelLog(kube)
        backend = side.backend(4)
        calls = record_calls(backend, crash_after=crash_after)
        first = make_manager(side, kube, backend,
                             intent_journal=side.intent.IntentJournal.from_state_dir(state_dir))
        with pytest.raises(Crash):
            first.set_cc_mode(MODE_ON)
        crashed = replay_records(side, state_dir)
        for name in CONTRACT:  # the restarted agent: same hardware, no crash
            delattr(backend, name)
        calls_after = record_calls(backend)
        registry = side.metrics.MetricsRegistry()
        second = make_manager(side, kube, backend, metrics=registry,
                              intent_journal=side.intent.IntentJournal.from_state_dir(state_dir))
        second.recover_from_journal()
        replayed = registry.journal_replay_totals()
        mode_after_replay = backend.query_cc_mode(backend.discover().chips[0])
        result = second.set_cc_mode(MODE_ON)
        return (crashed, replayed, mode_after_replay, result, log.steps(),
                split_prepare(calls), split_prepare(calls_after),
                replay_records(side, state_dir))

    want, got = run(JAX), run(PORT)
    assert got == want
    crashed, replayed, mode_after_replay, result, labels, _, (after, _), _ = got
    phases = [(r["t"], r.get("phase")) for r in crashed]
    if crash_after == "stage_cc_mode":
        assert phases == [("desired", None), ("intent", "begun")]
        assert replayed == {"rolled-back": 1} and mode_after_replay == MODE_OFF
        # Rolled back without a reset; the new flip then resets once.
        assert after.index("clear_staged") < after.index("reset")
        assert after.count("reset") == 1
    else:
        assert phases[-2:] == [("mark", "staged"), ("mark", "reset")]
        assert replayed == {"completed": 1} and mode_after_replay == MODE_ON
        assert "reset" not in after  # no second reset
    assert result is True and labels[-1][0] == MODE_ON


def readmitted_smoke(kube, node):
    """A smoke that outlasts the re-admission, as the card's does: with the
    manager's pipelined flip the components come back while it runs."""
    from tpu_cc_manager_torch.utils.poll import poll_until

    def smoke(workload):
        assert poll_until(lambda: all(v == "true" for k, v in node_labels(
            kube.get_node(node)).items() if k in DRAIN_COMPONENT_LABELS), 30, 0.005)
        return {"ok": True}

    return smoke


def card_phase_labels(side, attest_fault: bool) -> list:
    """``chip_smoke.py`` phase 16 (a) on the CPU, for either agent: a node
    with the operator's component pods (their DaemonSets played), one chip,
    flips off -> on -> off, the distinct label tuples of each."""
    import chip_smoke

    kube = side.kube.FakeKube()
    components = side.labels.DRAIN_COMPONENT_LABELS
    kube.add_node(chip_smoke.AGENT_NODE, {key: "true" for key in components})
    play_daemonsets(kube, chip_smoke.AGENT_NODE, components, chip_smoke.AGENT_NS)
    log = LabelLog(kube, keys=chip_smoke.AGENT_LABEL_KEYS)
    backend = side.backend(1)
    if attest_fault:  # the card's NVML refuses the report: a device error
        fake_of(backend).fail_next("attest")
    mgr = side.manager.CCManager(
        api=kube, backend=backend, node_name=chip_smoke.AGENT_NODE,
        operator_namespace=chip_smoke.AGENT_NS, evict_components=True,
        eviction_poll_interval_s=0.01, smoke_workload="matmul",
        smoke_runner=readmitted_smoke(kube, chip_smoke.AGENT_NODE), allow_fake_quotes=True,
        metrics=side.metrics.MetricsRegistry())
    flips = []
    for mode in chip_smoke.AGENT_FLIPS:
        mark = len(log.patches)
        mgr.set_cc_mode(mode)
        flips.append(log.steps(mark))
    return flips


@pytest.mark.parametrize("name", ["h100", "fake"])
def test_the_card_phase_expects_the_jax_agents_labels(name, tmp_path):
    """The label sequences ``chip_smoke.py`` phase 16 requires of the port's
    agent on the card are the JAX agent's, and its pass gives them here."""
    import chip_smoke

    want = chip_smoke.AGENT_LABELS[name]
    assert card_phase_labels(JAX, name == "h100") == want
    assert card_phase_labels(PORT, name == "h100") == want
    gpu = FakeGpuBackend(num_gpus=1, num_switches=0)
    if name == "h100":
        gpu.fail_next("attest")
    kube = port_kube.FakeKube()
    flips = chip_smoke.agent_pass(name, gpu, readmitted_smoke(kube, chip_smoke.AGENT_NODE),
                                  tmp_path, allow_fake_quotes=True, kube=kube)
    assert [f["labels"] for f in flips] == want
    assert [f["result"] for f in flips] == [True, name == "fake", True]
    # The smoke verifies every flip that changed the mode and passed attestation.
    assert ["smoke" in f["phase_s"] for f in flips] == [False, name == "fake", True]
    assert [f["failed_phases"] for f in flips] == [[], ["attest"] if name == "h100" else [], []]


def test_label_sequences_hold_under_thread_switches():
    """The manager re-admits on a thread of its own and the fake runs patch
    reactors outside its lock: with the interpreter switching threads every
    microsecond, the drain and phase-16 sequences still match."""
    import chip_smoke

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            want = drain(JAX, MODE_ON, None)
            assert drain(PORT, MODE_ON, None)[:-1] == want[:-1]
            assert card_phase_labels(PORT, False) == chip_smoke.AGENT_LABELS["fake"]
    finally:
        sys.setswitchinterval(interval)
