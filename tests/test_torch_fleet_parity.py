"""The port's fleet rollout against the JAX package's, side by side.

Where ``test_torch_{slo,flight,failslow,rolling,...}.py`` run each JAX case
on each package, these cases give both packages the same inputs in one test
and require the same outputs: SLO windows, flight files byte for byte, fault
schedules, fail-slow verdicts, rollout records, serving schedules, and a
rolling flip's timeline, label steps and backend calls per node. Then a
rollout killed at a window boundary on one package is resumed by the other
package's successor, both ways, from the Lease object and the node objects
carried between their ``FakeKube``s.
"""

import json
import random
import threading
import time
import types

import pytest

import tpu_cc_manager.ccmanager.manager as jax_manager
import tpu_cc_manager.ccmanager.rolling as jax_rolling
import tpu_cc_manager.ccmanager.rollout_state as jax_state
import tpu_cc_manager.faults as jax_faults
import tpu_cc_manager.kubeclient.api as jax_api
import tpu_cc_manager.kubeclient.fake as jax_kube
import tpu_cc_manager.obs.failslow as jax_failslow
import tpu_cc_manager.obs.flight as jax_flight
import tpu_cc_manager.obs.slo as jax_slo
import tpu_cc_manager.serve.driver as jax_driver
import tpu_cc_manager.serve.sweep as jax_sweep
import tpu_cc_manager.utils.metrics as jax_metrics
import tpu_cc_manager_torch.ccmanager.manager as port_manager
import tpu_cc_manager_torch.ccmanager.rolling as port_rolling
import tpu_cc_manager_torch.ccmanager.rollout_state as port_state
import tpu_cc_manager_torch.faults as port_faults
import tpu_cc_manager_torch.kubeclient.api as port_api
import tpu_cc_manager_torch.kubeclient.fake as port_kube
import tpu_cc_manager_torch.obs.failslow as port_failslow
import tpu_cc_manager_torch.obs.flight as port_flight
import tpu_cc_manager_torch.obs.slo as port_slo
import tpu_cc_manager_torch.serve.driver as port_driver
import tpu_cc_manager_torch.serve.sweep as port_sweep
import tpu_cc_manager_torch.utils.metrics as port_metrics
from test_torch_agent_manager import LabelLog, record_calls, split_prepare
from test_torch_fleet_sides import FakeNode
from tpu_cc_manager.kubeclient.api import node_annotations, node_labels
from tpu_cc_manager.labels import CC_MODE_LABEL, CC_MODE_STATE_LABEL, MODE_OFF, MODE_ON
from tpu_cc_manager.tpudev.fake import FakeTpuBackend
from tpu_cc_manager_torch.utils.poll import poll_until

JAX = types.SimpleNamespace(
    name="jax", slo=jax_slo, flight=jax_flight, faults=jax_faults, failslow=jax_failslow,
    state=jax_state, rolling=jax_rolling, kube=jax_kube, api=jax_api, metrics=jax_metrics,
    driver=jax_driver, sweep=jax_sweep, manager=jax_manager, backend=FakeTpuBackend)
PORT = types.SimpleNamespace(
    name="port", slo=port_slo, flight=port_flight, faults=port_faults,
    failslow=port_failslow, state=port_state, rolling=port_rolling, kube=port_kube, api=port_api,
    metrics=port_metrics, driver=port_driver, sweep=port_sweep, manager=port_manager,
    backend=FakeNode)
SIDES = (JAX, PORT)

POOL = "pool=tpu"
NS = "tpu-operator"


class Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def both(fn):
    """``fn(side)`` on the JAX package, then on the port."""
    return [fn(side) for side in SIDES]


def test_slo_windows_and_verdicts_are_equal():
    def run(side):
        clk = Clock(0.0)
        ev = side.slo.SloEvaluator(windows_s=(5.0, 30.0), error_budget=0.01,
                                   p99_target_s=0.3, clock=clk)
        rng = random.Random(11)
        verdicts = []
        for i in range(400):
            clk.t = i * 0.1
            ev.observe(rng.uniform(0.001, 0.5), ok=rng.random() > 0.02)
            if i % 40 == 0:
                verdicts.append((ev.breached(max_burn_rate=1.0),
                                 ev.breached(max_burn_rate=3.0, window_s=30.0)))
        registry = side.metrics.MetricsRegistry()
        for w in ev.snapshot()["windows"]:
            registry.set_serve_slo(w["window_s"], w["p99_s"], w["burn_rate"])
        text = registry.render_prometheus()
        return ev.snapshot(), verdicts, side.slo.parse_serve_slo_text(text), text

    jax_out, port_out = both(run)
    assert port_out == jax_out
    assert jax_out[0]["total"] == 400


def write_flight(side, path):
    fr = side.flight.FlightRecorder(str(path), generation=2, trace_id="t")
    fr.record(side.flight.EVENT_PLAN, mode="on", groups=2, nodes=["a", "b"])
    for wave, node in enumerate(("a", "b")):
        fr.record(side.flight.EVENT_WINDOW_OPEN, wave=0, window=wave, groups=[node])
        fr.record(side.flight.EVENT_NODE_CONVERGED, node=node, state="on", wave=0)
        fr.record(side.flight.EVENT_WINDOW_CLOSE, wave=0, window=wave, seconds=0.5)


def test_flight_files_are_byte_equal_and_read_each_other(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    blobs = {}
    for side in SIDES:
        write_flight(side, tmp_path / f"{side.name}.jsonl")
        blobs[side.name] = (tmp_path / f"{side.name}.jsonl").read_bytes()
    assert blobs["port"] == blobs["jax"] and blobs["jax"].count(b"\n") == 7
    for reader in SIDES:
        for writer in SIDES:
            events, torn = reader.flight.read_events(str(tmp_path / f"{writer.name}.jsonl"))
            assert torn == 0 and len(events) == 7
    rec = [side.flight.reconstruct(side.flight.read_events(
        str(tmp_path / "jax.jsonl"))[0]) for side in SIDES]
    assert rec[1] == rec[0]
    assert {n: e["outcome"] for n, e in rec[0]["nodes"].items()} == {
        "a": "node-converged", "b": "node-converged"}
    assert port_flight.render_timeline(
        port_flight.read_events(str(tmp_path / "port.jsonl"))[0]) == jax_flight.render_timeline(
        jax_flight.read_events(str(tmp_path / "jax.jsonl"))[0])


def fault_schedule(side, seed):
    kube = side.kube.FakeKube()
    kube.add_node("n0", {"pool": "tpu"})
    plan = side.faults.FaultPlan(seed=seed, rate=0.35, watch_rate=0.5,
                                 blackout_rate=0.05, blackout_min_calls=2,
                                 blackout_max_calls=4, retry_after_s=0.0, slow_s=0.0)
    api = side.faults.FaultyKubeClient(kube, plan, sleep=lambda s: None)
    for i in range(60):
        try:
            if i % 4 == 0:
                api.get_node("n0")
            elif i % 4 == 1:
                api.list_nodes("pool=tpu")
            elif i % 4 == 2:
                api.patch_node_labels("n0", {"x": str(i)})
            else:
                list(api.watch_nodes("n0", None, 0))
        except side.api.KubeApiError:
            pass
    kill = side.faults.FaultPlan(seed=seed, kill_rate=0.3)
    kills = []
    for i in range(30):
        try:
            kill.decide_orchestrator_kill("window-boundary")
        except side.faults.OrchestratorKilled as e:
            kills.append((i, e.point, e.seq))
    return [(f.kind, f.op, f.seq, f.status) for f in plan.injected], kills


@pytest.mark.parametrize("seed", [7, 1234])
def test_fault_plans_schedule_the_same_faults(seed):
    jax_out, port_out = both(lambda side: fault_schedule(side, seed))
    assert port_out == jax_out
    assert jax_out[0]


def test_failslow_verdicts_are_equal():
    def run(side):
        vetter = side.failslow.FailslowVetter(window_s=1.0, threshold=2.0, min_windows=2,
                                              min_peers=3, min_samples=3, clear_windows=2)
        rng = random.Random(5)
        log = []
        for window in range(12):
            for node in ("n0", "n1", "n2", "n3"):
                slow = 6.0 if node == "n2" and 3 <= window < 7 else 1.0
                for _ in range(8):
                    vetter.observe(node, 0.02 * slow * rng.uniform(0.8, 1.2))
            vetter.vet()
            log.append((sorted(vetter.suspects()), round(vetter.deviation("n2") or 0.0, 9)))
        return log, [{k: v for k, v in e.items() if k != "ts"} for e in vetter.concluded()]

    jax_out, port_out = both(run)
    assert port_out == jax_out
    verdicts = [e["verdict"] for e in jax_out[1]]
    assert "confirmed" in verdicts and "cleared" in verdicts


def test_rollout_records_round_trip_across_packages():
    recs = []
    for side in SIDES:
        rec = side.state.RolloutRecord(mode="on", selector=POOL, generation=3,
                                       groups=[("s1", ("n0", "n1")), ("node/n2", ("n2",))],
                                       failure_budget=2)
        rec.note_group("s1", ok=True, states={"n0": "on", "n1": "on"}, seconds=1.5)
        rec.charge_budget(["n2"])
        recs.append(rec.to_json())
    assert recs[1] == recs[0]
    for reader in SIDES:
        back = reader.state.RolloutRecord.from_json(recs[0])
        assert back.to_json() == recs[0] and back.done["s1"]["ok"] is True


def test_serving_schedules_and_knee_slack_are_equal():
    def run(side):
        arrivals = side.driver.PoissonSchedule(rate_rps=50.0, seed=3)
        ramp = side.driver.RampSchedule(rate0_rps=10.0, rate1_rps=80.0, duration_s=4.0, seed=3)
        times = [[s.next_interarrival_s(0.1 * i) for i in range(50)] for s in (arrivals, ramp)]
        slack = [side.sweep.knee_slack_nodes(100.0, rate, 4)
                 for rate in (0.0, 20.0, 80.0, 150.0, 400.0)]
        return times, slack

    jax_out, port_out = both(run)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# A rolling flip over real agents, on each package
# ---------------------------------------------------------------------------


def rolling_flip(side, tmp_path):
    """Three nodes with real agents (watch loops on threads, the drain off),
    flipped to on one at a time: the flight timeline's events, each node's
    label steps and each node's backend calls."""
    kube = side.kube.FakeKube()
    nodes = [f"node-{i}" for i in range(3)]
    stop, threads, calls, logs = threading.Event(), [], {}, {}
    for name in nodes:
        kube.add_node(name, {"pool": "tpu"})
        backend = side.backend(num_chips=2, slice_id=name)
        calls[name] = record_calls(backend)
        logs[name] = LabelLog(kube)
        mgr = side.manager.CCManager(
            api=kube, backend=backend, node_name=name, default_mode=MODE_OFF,
            evict_components=False, smoke_workload="none", allow_fake_quotes=True,
            metrics=side.metrics.MetricsRegistry(), watch_timeout_s=1, reconnect_delay_s=0.0,
            readiness_file=str(tmp_path / f"{side.name}-ready-{name}"))
        threads.append(threading.Thread(target=mgr.watch_and_apply, args=(stop,), daemon=True))
    for t in threads:
        t.start()
    try:
        assert poll_until(lambda: all(
            node_labels(kube.get_node(n)).get(CC_MODE_STATE_LABEL) == MODE_OFF
            for n in nodes), 30, 0.02), "the agents never settled"
        flight = side.flight.FlightRecorder(str(tmp_path / f"{side.name}.jsonl"))
        result = side.rolling.RollingReconfigurator(
            kube, POOL, max_unavailable=1, node_timeout_s=30, poll_interval_s=0.02,
            flight=flight, metrics=side.metrics.MetricsRegistry()).rollout(MODE_ON)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    events = side.flight.read_events(str(tmp_path / f"{side.name}.jsonl"))[0]
    timeline = [(e["event"], e.get("node"), e.get("window"), e.get("groups"))
                for e in events if e["event"] != side.flight.EVENT_COMPLETE]
    mine = {n: [s for s in logs[n].steps()] for n in nodes}
    return (result.ok, [g.group for g in result.groups], timeline,
            {n: mine[n] for n in nodes}, {n: split_prepare(calls[n]) for n in nodes})


def test_a_rolling_flip_over_real_agents_matches_the_jax_package(tmp_path):
    jax_out, port_out = both(lambda side: rolling_flip(side, tmp_path))
    assert port_out == jax_out
    ok, groups, timeline, labels, calls = jax_out
    assert ok and groups == ["node-0", "node-1", "node-2"]
    assert [e for e, n, _, _ in timeline if e == "node-converged"] == ["node-converged"] * 3


# ---------------------------------------------------------------------------
# (c) A rollout killed on one package, resumed by the other's successor
# ---------------------------------------------------------------------------


def agent_simulator(kube, counts):
    """Per-node agents as the resume suites emulate them: each desired
    mode converges 30 ms after it lands, and each node's reconciles are
    counted (the double-bounce detector)."""
    in_flight = set()

    def reactor(name, node):
        labels = node_labels(node)
        desired, state = labels.get(CC_MODE_LABEL), labels.get(CC_MODE_STATE_LABEL)
        if desired and state != desired and name not in in_flight:
            in_flight.add(name)
            counts[name] = counts.get(name, 0) + 1

            def fire():
                in_flight.discard(name)
                kube.set_node_label(name, CC_MODE_STATE_LABEL, desired)

            timer = threading.Timer(0.03, fire)
            timer.daemon = True
            timer.start()

    kube.add_patch_reactor(reactor)


def carry(source, target, nodes, lease_name) -> None:
    """Carry the node objects and the Lease object from one ``FakeKube``
    to another, as dicts through the public verbs."""
    for name in nodes:
        node = source.get_node(name)
        target.add_node(name, node_labels(node))
        annotations = node_annotations(node)
        if annotations:
            target.patch_node_annotations(name, annotations)
    lease = source.get_lease(NS, lease_name)
    created = target.create_lease(NS, lease_name, lease["spec"])
    created["metadata"]["annotations"] = dict(lease["metadata"].get("annotations") or {})
    target.update_lease(NS, lease_name, created)


def kill_and_resume(first, second, tmp_path):
    """``first``'s orchestrator flips a pool of four one-node groups and is
    killed at its first window boundary; the pool and the lease move to
    ``second``'s ``FakeKube``, whose successor takes the lease over and
    resumes. Returns the successor's result, the reconciles per node on
    each side, the record the successor read and the reconstructed
    timeline of the shared flight file."""
    nodes = [f"node-{i}" for i in range(4)]
    flight_path = str(tmp_path / f"{first.name}-to-{second.name}.jsonl")
    kube_a, counts_a = first.kube.FakeKube(), {}
    for name in nodes:
        kube_a.add_node(name, {"pool": "tpu"})
    agent_simulator(kube_a, counts_a)
    clk = Clock()
    lease_a = first.state.RolloutLease(kube_a, holder="orch-a", namespace=NS, duration_s=30,
                                       metrics=first.metrics.MetricsRegistry(), wall=clk,
                                       clock=clk)
    lease_a.acquire()

    def killer(point):
        if point == "window-boundary":
            raise first.faults.OrchestratorKilled(point, 0)

    roller_a = first.rolling.RollingReconfigurator(
        kube_a, POOL, node_timeout_s=5, poll_interval_s=0.02, lease=lease_a,
        crash_hook=killer, metrics=first.metrics.MetricsRegistry(),
        flight=first.flight.FlightRecorder(flight_path, generation=lease_a.generation))
    with pytest.raises(first.faults.OrchestratorKilled):
        roller_a.rollout(MODE_ON)

    kube_b, counts_b = second.kube.FakeKube(), {}
    carry(kube_a, kube_b, nodes, first.state.LEASE_NAME)
    agent_simulator(kube_b, counts_b)
    clk.advance(31)  # the killed orchestrator's lease lapses
    lease_b = second.state.RolloutLease(kube_b, holder="orch-b", namespace=NS, duration_s=30,
                                        metrics=second.metrics.MetricsRegistry(), wall=clk,
                                        clock=clk)
    record = lease_b.acquire()
    assert record is not None and record.status == second.state.RECORD_IN_PROGRESS
    done = sorted(g for g, d in record.done.items() if d.get("ok"))
    result = second.rolling.RollingReconfigurator(
        kube_b, POOL, node_timeout_s=5, poll_interval_s=0.02, lease=lease_b,
        resume_record=record, metrics=second.metrics.MetricsRegistry(),
        flight=second.flight.FlightRecorder(flight_path, generation=lease_b.generation),
    ).rollout(MODE_ON)
    events, torn = second.flight.read_events(flight_path)
    assert torn == 0
    final = {n: node_labels(kube_b.get_node(n)).get(CC_MODE_STATE_LABEL) for n in nodes}
    return (result, counts_a, counts_b, done, (lease_a.generation,
            lease_b.generation), final, second.flight.reconstruct(events))


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_a_killed_rollout_resumes_on_the_other_package(direction, tmp_path):
    first, second = (JAX, PORT) if direction == "jax-to-port" else (PORT, JAX)
    result, counts_a, counts_b, done, generations, final, timeline = kill_and_resume(
        first, second, tmp_path)
    assert result.ok and result.resumed and generations == (1, 2)
    # Killed after group 1: the successor skips it on the record's say-so
    # and bounces each other node once; no node is bounced twice in all.
    assert done == ["node/node-0"] and counts_a == {"node-0": 1}
    assert counts_b == {"node-1": 1, "node-2": 1, "node-3": 1}
    assert final == {f"node-{i}": MODE_ON for i in range(4)}
    assert [g.group for g in result.groups if g.skipped] == ["node/node-0"]
    outcomes = {n: (e["outcome"], e["gen"]) for n, e in timeline["nodes"].items()}
    assert outcomes == {"node-0": ("node-converged", 1), **{
        f"node-{i}": ("node-converged", 2) for i in (1, 2, 3)}}
    assert timeline["duplicate_node_events"] == [] and timeline["resumes"] == 1


def test_both_directions_reconstruct_the_same_outcomes(tmp_path):
    views = []
    for first, second in ((JAX, PORT), (PORT, JAX)):
        *_, timeline = kill_and_resume(first, second, tmp_path)
        views.append(({n: (e["outcome"], e["state"], e["gen"])
                       for n, e in timeline["nodes"].items()},
                      timeline["generations"], timeline["resumes"],
                      [(w["wave"], w["window"], w.get("groups")) for w in timeline["windows"]]))
    assert views[1] == views[0]
    assert json.dumps(views[0][0], sort_keys=True)
