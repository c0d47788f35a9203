"""The port's federation, fleet gateway, ``ctl`` and cclint against the JAX
package's, side by side.

Where ``test_torch_{federation,obs_fleet,ctl,cclint}.py`` run each JAX case
on each package, these cases give both packages the same inputs in one test
and require the same outputs: a federated two-region ``ctl rollout`` over
the same seeded pool (result, parent record and ``ctl status`` table); a
regional shard killed at ``federation-boundary`` on one package and resumed
on the other, both ways, from the Lease objects and node objects carried
between their ``FakeKube``s; the fleet gateway's merged ``/metrics`` and
``/fleetz`` over the same per-node expositions; and the findings of each
package's lint over the same fixture files. Each package runs on its own
``FakeKube``: the parent lease's name and the region label are module
constants of each package's ``federation``.
"""

import json
import random
import re
import threading
import time
import types

import pytest

import test_cclint as cclint_fixtures
import tpu_cc_manager.ccmanager.federation as jax_federation
import tpu_cc_manager.ccmanager.rolling as jax_rolling
import tpu_cc_manager.ccmanager.rollout_state as jax_state
import tpu_cc_manager.ctl as jax_ctl
import tpu_cc_manager.faults.plan as jax_plan
import tpu_cc_manager.kubeclient.fake as jax_kube
import tpu_cc_manager.lint.__main__ as jax_lint
import tpu_cc_manager.obs.fleet as jax_fleet
import tpu_cc_manager.obs.flight as jax_flight
import tpu_cc_manager.utils.metrics as jax_metrics
import tpu_cc_manager_torch.ccmanager.federation as port_federation
import tpu_cc_manager_torch.ccmanager.rolling as port_rolling
import tpu_cc_manager_torch.ccmanager.rollout_state as port_state
import tpu_cc_manager_torch.ctl as port_ctl
import tpu_cc_manager_torch.faults.plan as port_plan
import tpu_cc_manager_torch.kubeclient.fake as port_kube
import tpu_cc_manager_torch.lint.__main__ as port_lint
import tpu_cc_manager_torch.obs.fleet as port_fleet
import tpu_cc_manager_torch.obs.flight as port_flight
import tpu_cc_manager_torch.utils.metrics as port_metrics
from test_torch_agent_modules import call_every_recorder, normalise
from test_torch_fleet_parity import Clock, carry
from test_torch_fleet_sides import port_path
from tpu_cc_manager.kubeclient.api import node_labels
from tpu_cc_manager.labels import CC_MODE_LABEL, CC_MODE_STATE_LABEL, MODE_ON

JAX = types.SimpleNamespace(
    name="jax", federation=jax_federation, rolling=jax_rolling, state=jax_state, ctl=jax_ctl,
    plan=jax_plan, kube=jax_kube, lint=jax_lint, fleet=jax_fleet, flight=jax_flight,
    metrics=jax_metrics, path=lambda p: p)
PORT = types.SimpleNamespace(
    name="port", federation=port_federation, rolling=port_rolling, state=port_state,
    ctl=port_ctl, plan=port_plan, kube=port_kube, lint=port_lint, fleet=port_fleet,
    flight=port_flight, metrics=port_metrics, path=port_path)
SIDES = (JAX, PORT)

POOL = "pool=tpu"
NS = "tpu-operator"
REGIONS = ("r1", "r2")
FAILING = "r2-node-1"  # its agent reports the flip failed


def regional_pool(side, seed: int):
    """Two nodes per region, added in a seeded order, each converging (or,
    ``FAILING``, failing) the moment its desired label lands."""
    kube = side.kube.FakeKube()
    names = [f"{region}-node-{i}" for region in REGIONS for i in range(2)]
    random.Random(seed).shuffle(names)
    for name in names:
        kube.add_node(name, {"pool": "tpu", side.federation.REGION_LABEL: name[:2]})

    def reactor(name, node):
        labels = node_labels(node)
        desired = labels.get(CC_MODE_LABEL)
        if desired and labels.get(CC_MODE_STATE_LABEL) in (None, "off"):
            kube.set_node_label(name, CC_MODE_STATE_LABEL,
                                "failed" if name == FAILING else desired)

    kube.add_patch_reactor(reactor)
    return kube


def cli(side, kube, capsys, argv):
    capsys.readouterr()
    command = {"rollout": side.ctl.cmd_rollout, "status": side.ctl.cmd_status}[argv[0]]
    rc = command(kube, side.ctl.build_parser().parse_args(argv))
    return rc, capsys.readouterr().out


TIMES = ("total_seconds", "max_group_seconds", "mean_seconds_per_node")


def federated_rollout(side, capsys, tmp_path):
    """``ctl rollout --regions r1,r2`` with a budget of one node, then
    ``ctl status``: the result, the parent record and the table, with the
    walls, wall stamps and file paths taken out."""
    kube = regional_pool(side, seed=11)
    flight_file = str(tmp_path / f"{side.name}.jsonl")
    rc, out = cli(side, kube, capsys, [
        "rollout", "--selector", POOL, "--mode", "on", "--regions", ",".join(REGIONS),
        "--failure-budget", "1", "--continue-on-failure", "--node-timeout", "5",
        "--lease-namespace", NS, "--flight-file", flight_file])
    summary = json.loads(out.strip().splitlines()[-1])
    assert set(summary.pop("flight_files")) == set(REGIONS)
    for region in summary["regions"].values():
        for key in TIMES:
            region.pop(key)
    parent = json.loads(side.federation.ParentStore(kube, namespace=NS).load().to_json())
    for region in parent["regions"].values():
        region.pop("synced_at")
    status_rc, status = cli(side, kube, capsys, ["status", "--selector", POOL,
                                                 "--lease-namespace", NS])
    status = re.sub(r"synced \d+s ago", "synced", status)
    events, torn = side.flight.stitch_files([f"{flight_file}.{r}" for r in REGIONS])
    outcomes = {n: (e["outcome"], e["state"]) for n, e in
                side.flight.reconstruct(events)["nodes"].items()}
    labels = {n["metadata"]["name"]: node_labels(n).get(CC_MODE_STATE_LABEL)
              for n in kube.list_nodes(POOL)}
    return rc, summary, parent, status_rc, status, torn, outcomes, labels


def test_a_federated_ctl_rollout_matches_the_jax_package(capsys, tmp_path):
    views = [federated_rollout(side, capsys, tmp_path) for side in SIDES]
    assert views[1] == views[0]
    rc, summary, parent, status_rc, status, torn, outcomes, labels = views[0]
    # r2's failing node is charged once against the budget of one; the
    # rest of the pool flips, and the federation reports the failure.
    assert rc == 1 and not summary["ok"] and summary["budget_spend"] == 1
    assert parent["budget_spend"] == [FAILING] and parent["failure_budget"] == 1
    assert {r: parent["regions"][r]["charged"] for r in REGIONS} == {"r1": [], "r2": [FAILING]}
    assert status_rc == 0 and "budget_spend=1/1" in status
    assert torn == 0 and outcomes[FAILING][0] != outcomes["r1-node-0"][0]
    assert labels == {"r1-node-0": MODE_ON, "r1-node-1": MODE_ON, "r2-node-0": MODE_ON,
                      FAILING: "failed"}


def kill_and_resume(first, second, tmp_path):
    """``first`` runs region r1 of a two-region federation as a regional
    shard (its own lease, the parent gate) and is killed at its second
    ``federation-boundary``, after its first node converged. The pool, the
    regional lease and the parent lease move to ``second``'s ``FakeKube``,
    whose successor rebuilds the gate from the record
    (``FederationGate.from_record_dict``) and resumes. Returns what the
    successor saw and did."""
    nodes = ["r1-node-0", "r1-node-1"]
    kube_a, counts = first.kube.FakeKube(), {}
    for name in nodes:
        kube_a.add_node(name, {"pool": "tpu", first.federation.REGION_LABEL: "r1"})

    def reactor_for(kube):
        def reactor(name, node):
            labels = node_labels(node)
            if labels.get(CC_MODE_LABEL) == MODE_ON and labels.get(CC_MODE_STATE_LABEL) is None:
                counts[name] = counts.get(name, 0) + 1
                kube.set_node_label(name, CC_MODE_STATE_LABEL, MODE_ON)
        return reactor

    kube_a.add_patch_reactor(reactor_for(kube_a))
    clk = Clock()
    lease_name = first.federation.regional_lease_name("r1")
    flight_path = str(tmp_path / f"{first.name}-to-{second.name}.jsonl")

    def lease(side, kube, holder):
        return side.state.RolloutLease(kube, holder=holder, namespace=NS, name=lease_name,
                                       duration_s=30, metrics=side.metrics.MetricsRegistry(),
                                       wall=clk, clock=clk)

    store = first.federation.ParentStore(kube_a, namespace=NS)
    parent = store.initialize(first.federation.ParentRecord.fresh(
        MODE_ON, POOL, list(REGIONS), failure_budget=1), resume=False)
    lease_a = lease(first, kube_a, "orch-a")
    lease_a.acquire()
    gate = first.federation.FederationGate(store, "r1")
    gate.attach(parent)
    boundaries = []

    def killer(point):
        if point == "federation-boundary":
            boundaries.append(point)
            if len(boundaries) == 2:
                raise first.plan.OrchestratorKilled(point, len(boundaries))

    selector = first.federation.regional_selector(POOL, "r1")
    with pytest.raises(first.plan.OrchestratorKilled):
        first.rolling.RollingReconfigurator(
            kube_a, selector, node_timeout_s=5, poll_interval_s=0.02, lease=lease_a,
            federation=gate, crash_hook=killer, metrics=first.metrics.MetricsRegistry(),
            flight=first.flight.FlightRecorder(flight_path, generation=lease_a.generation),
        ).rollout(MODE_ON)

    kube_b = second.kube.FakeKube()
    carry(kube_a, kube_b, nodes, lease_name)
    parent_lease = kube_a.get_lease(NS, first.federation.PARENT_LEASE_NAME)
    created = kube_b.create_lease(NS, second.federation.PARENT_LEASE_NAME, parent_lease["spec"])
    created["metadata"]["annotations"] = dict(parent_lease["metadata"].get("annotations") or {})
    kube_b.update_lease(NS, second.federation.PARENT_LEASE_NAME, created)
    kube_b.add_patch_reactor(reactor_for(kube_b))
    clk.advance(31)  # the killed shard's lease lapses
    lease_b = lease(second, kube_b, "orch-b")
    record = lease_b.acquire()
    assert record is not None and record.status == second.state.RECORD_IN_PROGRESS
    done = sorted(g for g, d in record.done.items() if d.get("ok"))
    gate_b = second.federation.FederationGate.from_record_dict(kube_b, record.federation)
    result = second.rolling.RollingReconfigurator(
        kube_b, selector, node_timeout_s=5, poll_interval_s=0.02, lease=lease_b,
        federation=gate_b, resume_record=record, metrics=second.metrics.MetricsRegistry(),
        flight=second.flight.FlightRecorder(flight_path, generation=lease_b.generation),
    ).rollout(MODE_ON)
    final = second.federation.ParentStore(kube_b, namespace=NS).load()
    events, torn = second.flight.read_events(flight_path)
    return (result, counts, done, record.federation["digest"] == parent.digest, final, torn,
            {n: (e["outcome"], e["gen"]) for n, e in
             second.flight.reconstruct(events)["nodes"].items()})


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_a_killed_regional_shard_resumes_on_the_other_package(direction, tmp_path):
    first, second = (JAX, PORT) if direction == "jax-to-port" else (PORT, JAX)
    result, counts, done, same_parent, final, torn, outcomes = kill_and_resume(
        first, second, tmp_path)
    assert result.ok and result.resumed and result.generation == 2
    assert same_parent and done == ["node/r1-node-0"]
    # Each node bounced once across the kill: the successor skipped node 0.
    assert counts == {"r1-node-0": 1, "r1-node-1": 1}
    assert final.regions["r1"]["status"] == "complete"
    assert (final.regions["r1"]["done"], final.regions["r1"]["total"]) == (2, 2)
    assert final.regions["r2"]["status"] == "pending" and final.budget_spend == []
    assert torn == 0 and outcomes == {"r1-node-0": ("node-converged", 1),
                                      "r1-node-1": ("node-converged", 2)}


def test_both_directions_reconstruct_the_same_resume(tmp_path):
    views = []
    for first, second in ((JAX, PORT), (PORT, JAX)):
        result, counts, done, _, final, _, outcomes = kill_and_resume(first, second, tmp_path)
        regions = {r: {k: v for k, v in e.items() if k != "synced_at"}
                   for r, e in final.regions.items()}
        views.append((result.ok, result.generation, counts, done, regions, outcomes))
    assert views[1] == views[0]


@pytest.fixture()
def expositions(monkeypatch):
    """Three agents' expositions: every recorder of the port's registry
    called, with a clock stepping 0.25 s a read, and a few more samples
    each (serving latencies, a quarantine), seeded per node."""
    texts = {}
    for i, name in enumerate(("node-a", "node-b", "node-c")):
        ticks = iter(range(10**6))
        monkeypatch.setattr(time, "monotonic", lambda: 0.25 * next(ticks))
        registry = port_metrics.MetricsRegistry()
        call_every_recorder(registry)
        rng = random.Random(i)
        for _ in range(20):
            registry.observe_serve_request(name, rng.uniform(0.001, 0.5))
        registry.set_quarantined(i == 1)
        texts[name] = registry.render_prometheus()
    monkeypatch.undo()
    return texts


def gateway_views(side, texts):
    def target(text):
        def fetch(path):
            if path in ("", "/metrics"):
                return text
            if path == "/statusz":
                return json.dumps({"agent_version": "0.0.0", "snapshot_ts": 5.0})
            return json.dumps({"events": []})
        return fetch

    gateway = side.fleet.FleetGateway({n: target(t) for n, t in texts.items()})
    gateway.scrape_once()
    fleetz = gateway.fleetz()
    fleetz.pop("sweep_seconds")
    for entry in fleetz["nodes"].values():
        entry.pop("scrape_seconds")
    return gateway.metrics_text(), fleetz, side.fleet.merge_expositions(texts)


def test_the_gateways_serve_the_same_fleet(expositions):
    (jax_text, jax_fleetz, jax_merged), (port_text, port_fleetz, port_merged) = (
        gateway_views(side, expositions) for side in SIDES)
    assert port_text.encode() == jax_text.encode()
    assert port_merged.encode() == jax_merged.encode()
    assert port_fleetz == jax_fleetz
    assert jax_fleetz["fleet"]["nodes"] == 3 and jax_fleetz["fleet"]["stale"] == 0
    assert "tpu_cc_quarantined 1" in jax_text
    assert port_lint.expo.lint(port_text) == []


#: One fixture tree for both lints: each checker's known-bad sources from
#: the JAX suite, at the JAX package's paths (the port's are mapped from
#: them), plus a docs table, a manifest and a test file.
LINT_TREE = {
    "tpu_cc_manager/ccmanager/locked.py": cclint_fixtures.LOCKS_BAD,
    "tpu_cc_manager/ccmanager/interproc.py": cclint_fixtures.LOCKS_INTERPROC,
    "tpu_cc_manager/waiting.py": cclint_fixtures.WAITS_BAD,
    "tpu_cc_manager/crashing.py": cclint_fixtures.CRASH_BAD,
    "tpu_cc_manager/ccmanager/rogue.py": cclint_fixtures.JOURNAL_BAD,
    "tpu_cc_manager/tpudev/impl.py": cclint_fixtures.JOURNAL_BAD,
    "tpu_cc_manager/ccmanager/branch.py": cclint_fixtures.JOURNAL_BRANCH_BAD,
    "tpu_cc_manager/ccmanager/open_exit.py": cclint_fixtures.JOURNAL_OPEN_EXIT,
    "tpu_cc_manager/ctl.py": cclint_fixtures.FENCED_BRACKET,
    "tpu_cc_manager/ccmanager/helper.py": cclint_fixtures.FENCED_HELPER,
    "tpu_cc_manager/ccmanager/roll.py": cclint_fixtures.CRASHPOINT_PKG,
    "tpu_cc_manager/labels.py": 'OK = "cloud.google.com/tpu-cc.fine"\n',
    "tpu_cc_manager/envs.py": (
        'import os\n'
        'A = os.environ.get("CC_DOCUMENTED", "")\n'
        'B = os.environ.get("CC_UNDOCUMENTED", "")\n'
        'KEY = "cloud.google.com/tpu-cc.rogue-key"\n'),
    "docs/operations.md": "| `CC_DOCUMENTED` | on | documented |\n",
    "deployments/manifests/daemonset.yaml": "env:\n  - name: CC_DOCUMENTED\n  - name: CC_PHANTOM\n",
    "tests/test_roll.py": cclint_fixtures.CRASHPOINT_TEST + (
        "import time\n"
        "def test_flaky():\n"
        "    time.sleep(0.5)\n"),
}


def lint_findings(side, root) -> list:
    for relpath, text in LINT_TREE.items():
        path = root / side.path(relpath)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    manifest = "deployments/manifests/daemonset.yaml"

    def norm(text: str) -> str:  # the port's manifest (the H100 one) read as the JAX one's
        return normalise(text.replace(port_path(manifest), manifest))

    # Sorted after the reading: the lint sorts by path, and the two
    # manifests' paths sort differently.
    return sorted((f.checker, norm(f.path), f.line, norm(f.message), norm(f.fingerprint))
                  for f in side.lint.run(str(root), skip_expo=True))


def test_the_lints_find_the_same_findings_in_the_same_files(tmp_path):
    jax_found, port_found = (lint_findings(side, tmp_path / side.name) for side in SIDES)
    assert port_found == jax_found
    checkers = {f[0] for f in jax_found}
    assert checkers == {"locks", "waits", "crash", "journal", "fenced", "crashpoints",
                        "surface"}, checkers
    assert not any("tpudev/impl.py" in f[1] for f in jax_found)  # the device layer is out
