"""Fleet-scale orchestration bench: rollout cost vs pool size.

A copy of the repository's ``hack/scale_bench.py`` over the port's
``ccmanager/``, ``kubeclient/``, ``faults/``, ``obs/`` and ``lint/``; each
line of code that differs is a seam and says so in a comment. It touches
no card. The seams: the repository root is three directories above this
file, ``hack/mock_apiserver.py`` (a stdlib HTTP server beside the JAX
package, which ``ccmanager/localrig.py`` runs too) is loaded from the
root's ``hack/``, and the default artifacts carry a ``torch_`` prefix, so
that a run from the repository root never overwrites the reference's
``SCALE_r0*.json`` and ``FLEET_r01.json``; the SCALE_r02 baseline is still
read from the reference's committed ``SCALE_r02.json``.

Drives a FULL rolling CC reconfiguration over a simulated fleet of
100 / 1k / 10k nodes — thousands of simulated node agents (FakeKube
backed, each behind its own seeded-FaultPlan chaos client) converging on
the desired-mode labels the orchestrator writes — and measures what the
orchestrator costs the apiserver, per verb:

- **legacy** mode is the pre-informer orchestrator: every await poll and
  window boundary re-lists the pool — O(pool) requests AND O(pool)
  response bytes per decision;
- **informer** mode is the watch-driven cache (ccmanager/informer.py)
  plus sharded rollout waves: one chunked listing, one watch, awaits
  wake on cache events — O(changes).

The artifact (SCALE_r01.json) records rollout wall-clock and the
orchestrator's per-verb apiserver request counts at each pool size, so
the O(pool)→O(changes) drop is a measured number, not an assertion. The
acceptance bar: ≥10× fewer list requests at 1k nodes in informer mode.

Resumable: ``--partial FILE`` appends one JSON line per completed
(mode, size) run and skips combos already recorded — the evidence ladder
(hack/evidence_r5.sh) re-runs the script after an interruption without
re-buying finished pools.

Legacy mode at 10k nodes is skipped by default (--full enables it): its
O(pool) listings make the run minutes-long by construction, which is the
very pathology the informer exists to remove; the 1k comparison already
quantifies it.

``--apiserver`` swaps FakeKube for the real HTTP ``hack/mock_apiserver.py``
behind RestKube — chunked listings, selector watches and lease CAS ride
the wire — with the fleet's agents emulated server-side (ServerAgentSim);
defaults to the 1k-node fleet and SCALE_r02.json (mock-apiserver scale
parity, ROADMAP item 1 headroom).

Usage:
    python -m tpu_cc_manager_torch.bench.scale_bench                   # full bench
    python -m tpu_cc_manager_torch.bench.scale_bench --sizes 100,1000  # subset
    python -m tpu_cc_manager_torch.bench.scale_bench --apiserver       # 1k nodes over HTTP
    python -m tpu_cc_manager_torch.bench.scale_bench --out torch_SCALE_r01.json --partial artifacts/scale_partial.jsonl
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import random
import sys
import tempfile
import threading
import time
import zlib

# Seam: the repository root, three directories above this file.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _REPO_ROOT)

from tpu_cc_manager_torch.ccmanager import rollout_state  # noqa: E402
from tpu_cc_manager_torch.ccmanager.informer import NodeInformer  # noqa: E402
from tpu_cc_manager_torch.ccmanager.rolling import (  # noqa: E402
    RollingReconfigurator,
    ZONE_LABEL,
)
from tpu_cc_manager_torch.faults.kube import FaultyKubeClient  # noqa: E402
from tpu_cc_manager_torch.faults.plan import FaultPlan, OrchestratorKilled  # noqa: E402
from tpu_cc_manager_torch.kubeclient.api import (  # noqa: E402
    KubeApiError,
    classify_kube_error,
    node_labels,
)
from tpu_cc_manager_torch.kubeclient.fake import FakeKube  # noqa: E402
from tpu_cc_manager_torch.labels import (  # noqa: E402
    CC_MODE_LABEL,
    CC_MODE_STATE_LABEL,
    SLICE_ID_LABEL,
)
from tpu_cc_manager_torch.lint import expo as expo_lint  # noqa: E402
from tpu_cc_manager_torch.obs import fleet as fleet_mod  # noqa: E402
from tpu_cc_manager_torch.obs import flight as flight_mod  # noqa: E402
from tpu_cc_manager_torch.utils import retry as retry_mod  # noqa: E402
from tpu_cc_manager_torch.utils.metrics import MetricsRegistry  # noqa: E402

SELECTOR = "pool=tpu"
DEFAULT_SEED = 20260803


class CountingKube:
    """Pass-through wrapper counting the ORCHESTRATOR's per-verb requests
    (FakeKube.request_counts sees the whole fleet — agents included — so
    the orchestrator's own apiserver footprint needs its own ledger)."""

    _VERBS = {
        "get_node": "get", "list_nodes": "list", "list_nodes_page": "list",
        "list_pods": "list", "patch_node_labels": "patch",
        "patch_node_annotations": "patch", "patch_node_taints": "patch",
        "watch_nodes": "watch", "watch_nodes_pool": "watch",
        "create_event": "create", "get_lease": "get",
        "create_lease": "create", "update_lease": "update",
        "delete_lease": "delete",
    }

    def __init__(self, inner):
        self.inner = inner
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self.retries_internally = getattr(inner, "retries_internally", False)

    def _count(self, verb: str) -> None:
        with self._lock:
            self.counts[verb] = self.counts.get(verb, 0) + 1

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        verb = self._VERBS.get(name)
        if verb is None or not callable(attr):
            return attr

        def counted(*args, **kwargs):
            self._count(verb)
            return attr(*args, **kwargs)

        return counted


class AgentSim:
    """Thousands of simulated node agents without thousands of threads.

    A FakeKube patch reactor models each agent's watch: when a node's
    desired mode diverges from its state, the agent schedules a
    transition (seeded per-node latency), executed by a small worker pool
    through that node's own FaultyKubeClient — so every agent's apiserver
    traffic rides a seeded FaultPlan, like the chaos soak's single agent,
    and the fleet's convergence is exercised under per-node weather."""

    def __init__(
        self,
        fake: FakeKube,
        seed: int,
        fault_rate: float = 0.02,
        workers: int = 24,
        min_delay_s: float = 0.02,
        max_delay_s: float = 0.08,
    ) -> None:
        self.fake = fake
        self.seed = seed
        self.fault_rate = fault_rate
        self.min_delay_s = min_delay_s
        self.max_delay_s = max_delay_s
        self._cond = threading.Condition()
        self._heap: list[tuple[float, str, str]] = []
        self._scheduled: set[str] = set()
        self._stop = False
        self._clients: dict[str, FaultyKubeClient] = {}
        self._rngs: dict[str, random.Random] = {}
        self.transitions = 0
        self.errors = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(workers)
        ]
        fake.add_patch_reactor(self._react)
        for t in self._threads:
            t.start()

    def _client(self, node: str) -> FaultyKubeClient:
        client = self._clients.get(node)
        if client is None:
            # crc32, not hash(): tuple/str hashes are randomized per
            # process (PYTHONHASHSEED), and the whole point of a seeded
            # FaultPlan is same-seed-same-schedule across runs.
            node_seed = zlib.crc32(f"{self.seed}:{node}".encode())
            plan = FaultPlan(
                seed=node_seed,
                rate=self.fault_rate,
                retry_after_s=0.01,
                slow_s=0.005,
            )
            client = FaultyKubeClient(self.fake, plan)
            self._clients[node] = client
            self._rngs[node] = random.Random(node_seed ^ 0xDE1A)
        return client

    def _react(self, name: str, node: dict) -> None:
        labels = node_labels(node)
        desired = labels.get(CC_MODE_LABEL)
        state = labels.get(CC_MODE_STATE_LABEL)
        if not desired or desired == state:
            return
        with self._cond:
            if name in self._scheduled:
                return
            self._client(name)  # seed rng/client outside the worker
            delay = self._rngs[name].uniform(self.min_delay_s, self.max_delay_s)
            heapq.heappush(
                self._heap, (time.monotonic() + delay, name, desired)
            )
            self._scheduled.add(name)
            self._cond.notify()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stop and (
                    not self._heap or self._heap[0][0] > time.monotonic()
                ):
                    timeout = (
                        self._heap[0][0] - time.monotonic()
                        if self._heap else 0.2
                    )
                    self._cond.wait(timeout=max(0.001, min(timeout, 0.2)))
                if self._stop:
                    return
                _, name, desired = heapq.heappop(self._heap)
            self._transition(name, desired)
            with self._cond:
                self._scheduled.discard(name)

    def _transition(self, name: str, desired: str) -> None:
        api = self._client(name)
        policy = retry_mod.RetryPolicy(
            max_attempts=5, base_delay_s=0.01, max_delay_s=0.1
        )
        try:
            # The agent's confirm read + truthful state report — the same
            # two requests a real reconcile's cheap path costs.
            policy.call(
                lambda: api.get_node(name),
                op="agent.confirm", classify=classify_kube_error,
            )
            policy.call(
                lambda: api.patch_node_labels(
                    name, {CC_MODE_STATE_LABEL: desired}
                ),
                op="agent.report", classify=classify_kube_error,
            )
            self.transitions += 1
        except KubeApiError:
            # Exhausted the ladder under seeded weather: the reactor fires
            # again on the next desired-label event; count it.
            self.errors += 1

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=1.0)


def fleet_labels(i: int, n: int, hosts_per_slice: int, zones: int) -> dict:
    slice_count = max(1, n // hosts_per_slice)
    sid = i % slice_count
    return {
        "pool": "tpu",
        SLICE_ID_LABEL: f"scale-s{sid:05d}",
        ZONE_LABEL: f"zone-{sid % zones}",
        CC_MODE_STATE_LABEL: "off",
    }


def build_fleet(
    fake: FakeKube, n: int, hosts_per_slice: int = 4, zones: int = 8
) -> None:
    for i in range(n):
        fake.add_node(
            f"scale-n{i:05d}", fleet_labels(i, n, hosts_per_slice, zones)
        )


# ---------------------------------------------------------------------------
# --apiserver mode: the SAME rollout, but the orchestrator speaks real
# HTTP to hack/mock_apiserver.py through RestKube — chunked listings,
# selector watches, lease CAS and merge-patches all ride the wire, so
# the informer-vs-legacy comparison covers serialization and transport,
# not just FakeKube method calls (ROADMAP item 1's "mock-apiserver scale
# parity" headroom).
# ---------------------------------------------------------------------------

_MOCK_THREADS_STARTED = [False]


def _load_mock():
    # Seam: the mock apiserver lives in the repository's hack/.
    sys.path.insert(0, os.path.join(_REPO_ROOT, "hack"))
    import mock_apiserver as mock

    return mock


def _reset_mock(mock) -> None:
    with mock.lock:
        mock.nodes.clear()
        mock.pods.clear()
        mock.leases.clear()
        mock.request_counts.clear()
        mock.page_snapshots.clear()
        mock.events.clear()
        mock.sticky_pods.clear()
        mock.compacted_below[0] = 0


class ServerAgentSim:
    """The fleet's agents, emulated server-side: a scheduler thread scans
    the mock's node table for desired≠state, schedules each flip after a
    seeded per-node latency, and applies it under the mock's lock (state
    label + rv bump + watch event) — exactly the churn a real fleet's
    DaemonSet generates, without 1k HTTP clients. The ORCHESTRATOR is the
    process under test here; its traffic is what rides the wire."""

    def __init__(
        self,
        mock,
        seed: int,
        min_delay_s: float = 0.02,
        max_delay_s: float = 0.08,
        scan_interval_s: float = 0.01,
        dead_nodes: set[str] | None = None,
    ) -> None:
        self.mock = mock
        self.seed = seed
        self.min_delay_s = min_delay_s
        self.max_delay_s = max_delay_s
        self.scan_interval_s = scan_interval_s
        #: Names whose agents never flip (simulated hardware failure).
        #: The set is live: clearing it mid-run models the hardware
        #: recovering — the next scan schedules the flip normally.
        self.dead_nodes = dead_nodes if dead_nodes is not None else set()
        self.transitions = 0
        self._due: list[tuple[float, str, str]] = []
        self._scheduled: set[str] = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _delay(self, name: str) -> float:
        rng = random.Random(zlib.crc32(f"{self.seed}:{name}".encode()))
        return rng.uniform(self.min_delay_s, self.max_delay_s)

    def _loop(self) -> None:
        mock = self.mock
        while not self._stop.wait(self.scan_interval_s):
            now = time.monotonic()
            with mock.lock:
                for name, node in mock.nodes.items():
                    labels = node["metadata"]["labels"]
                    desired = labels.get(CC_MODE_LABEL)
                    state = labels.get(CC_MODE_STATE_LABEL)
                    if (
                        desired
                        and desired != state
                        and name not in self._scheduled
                        and name not in self.dead_nodes
                    ):
                        self._scheduled.add(name)
                        heapq.heappush(
                            self._due,
                            (now + self._delay(name), name, desired),
                        )
            while self._due and self._due[0][0] <= time.monotonic():
                _, name, desired = heapq.heappop(self._due)
                with mock.lock:
                    node = mock.nodes.get(name)
                    if node is None:
                        continue
                    node["metadata"]["labels"][CC_MODE_STATE_LABEL] = desired
                    mock.bump_rv(node)
                    mock.emit_watch_event(node)
                self._scheduled.discard(name)
                self.transitions += 1

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def run_pool_apiserver(
    n: int,
    mode: str,
    seed: int = DEFAULT_SEED,
    shards: int = 8,
    per_shard_unavailable: int = 4,
    poll_interval_s: float = 0.2,
    node_timeout_s: float = 300.0,
    hosts_per_slice: int = 4,
) -> dict:
    """One full rollout over an n-node fleet served by the real HTTP mock
    apiserver; the orchestrator runs RestKube end-to-end."""
    from http.server import ThreadingHTTPServer

    from tpu_cc_manager_torch.kubeclient.rest import ClusterConfig, RestKube

    mock = _load_mock()
    _reset_mock(mock)
    with mock.lock:
        for i in range(n):
            name = f"scale-n{i:05d}"
            mock.nodes[name] = {
                "kind": "Node",
                "apiVersion": "v1",
                "metadata": {
                    "name": name,
                    "resourceVersion": "1",
                    "labels": fleet_labels(i, n, hosts_per_slice, zones=8),
                },
            }
    if not _MOCK_THREADS_STARTED[0]:
        threading.Thread(target=mock._watch_writer, daemon=True).start()
        _MOCK_THREADS_STARTED[0] = True
    srv = ThreadingHTTPServer(("127.0.0.1", 0), mock.Handler)
    srv_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    srv_thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sim = ServerAgentSim(mock, seed=seed)
    client = RestKube(ClusterConfig(server=url, token="scale-bench"))
    counting = CountingKube(client)
    informer = None
    total_unavailable = shards * per_shard_unavailable
    try:
        if mode == "informer":
            informer = NodeInformer(
                counting, SELECTOR, page_limit=500,
            ).start(sync_timeout_s=120.0)
            roller = RollingReconfigurator(
                counting, SELECTOR,
                max_unavailable=per_shard_unavailable,
                poll_interval_s=poll_interval_s,
                node_timeout_s=node_timeout_s,
                informer=informer,
                wave_shards=shards,
            )
        else:
            roller = RollingReconfigurator(
                counting, SELECTOR,
                max_unavailable=total_unavailable,
                poll_interval_s=poll_interval_s,
                node_timeout_s=node_timeout_s,
            )
        t0 = time.monotonic()
        result = roller.rollout("on")
        seconds = time.monotonic() - t0
        with mock.lock:
            converged = all(
                node["metadata"]["labels"].get(CC_MODE_STATE_LABEL) == "on"
                for node in mock.nodes.values()
            )
            server_requests = dict(sorted(mock.request_counts.items()))
    finally:
        if informer is not None:
            informer.stop()
        sim.stop()
        srv.shutdown()
        srv_thread.join(timeout=5.0)
    return {
        "nodes": n,
        "mode": mode,
        "transport": "http",
        "ok": bool(result.ok and converged),
        "converged": converged,
        "seconds": round(seconds, 2),
        "groups": len(result.groups),
        "wave_shards": shards if mode == "informer" else 1,
        "max_unavailable_total": total_unavailable,
        "orchestrator_requests": dict(sorted(counting.counts.items())),
        "apiserver_requests": server_requests,
        "agent_transitions": sim.transitions,
    }


# ---------------------------------------------------------------------------
# --federation mode: the federation acceptance bench (SCALE_r03). One
# federated rollout over >=100k nodes sharded across >=10 REGIONS, each
# region served by its OWN mock apiserver instance (mock_apiserver
# .MockState + make_handler) with its own server-side agent sim — plus a
# dedicated control-plane apiserver hosting only the parent record's CAS
# lease (ccmanager/federation.py). Every regional orchestrator holds a
# regional lease, checkpoints a regional record, and settles the single
# global failure budget through the parent at wave boundaries.
#
# Three things are measured and gated:
#  - per-apiserver load: each region's HTTP request count, normalized
#    per node, must stay within the SCALE_r02 1k-node informer baseline
#    plus a small allowance for what r02 did not carry (regional lease
#    checkpoints + acquire traffic);
#  - regional failure: one region's orchestrator is SIGKILL-simulated
#    mid-rollout (OrchestratorKilled at a crash point) and a successor
#    resumes from the regional record, re-attaching to the live parent;
#  - cross-region observability: every region writes its own flight
#    file; stitch_files + reconstruct must rebuild ONE timeline with
#    every node's outcome exactly once across all regions and the kill.
# ---------------------------------------------------------------------------

#: SCALE_r02's measured per-node apiserver cost for the 1k informer run
#: ({list: 2, patch: 1000, watch: 1} ≈ 1.003 req/node), re-read from the
#: committed artifact when present so the gate tracks the actual
#: baseline, not a stale constant.
R02_FALLBACK_PER_NODE = 1.003
#: The r03 run adds traffic r02 did not have: regional lease
#: create/acquire + one CAS checkpoint per window + the resume leg's
#: re-list. All are O(windows) or O(1), not O(nodes); 0.25 req/node
#: bounds them with room at 10k nodes/region.
FEDERATION_PER_NODE_ALLOWANCE = 0.25


def _r02_baseline_per_node() -> float:
    # Seam: the reference's committed baseline, at the repository root.
    path = os.path.join(_REPO_ROOT, "SCALE_r02.json")
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        for row in doc.get("pools", []):
            if row.get("mode") == "informer" and row.get("apiserver_requests"):
                return sum(row["apiserver_requests"].values()) / row["nodes"]
    except (OSError, ValueError, KeyError, ZeroDivisionError):
        pass
    return R02_FALLBACK_PER_NODE


def _federation_region_fleet(state, region: str, n: int,
                             hosts_per_slice: int = 4) -> None:
    from tpu_cc_manager_torch.ccmanager import federation as federation_mod

    for i in range(n):
        name = f"{region}-n{i:05d}"
        labels = fleet_labels(i, n, hosts_per_slice, zones=8)
        labels[federation_mod.REGION_LABEL] = region
        state.nodes[name] = {
            "kind": "Node",
            "apiVersion": "v1",
            "metadata": {
                "name": name,
                "resourceVersion": "1",
                "labels": labels,
            },
        }


def run_federation(
    total_nodes: int = 100_000,
    regions_count: int = 10,
    seed: int = DEFAULT_SEED,
    shards: int = 8,
    per_shard_unavailable: int = 25,
    poll_interval_s: float = 0.05,
    node_timeout_s: float = 600.0,
    kill_region_index: int = 3,
    kill_at: int | None = None,
) -> dict:
    """One federated rollout across ``regions_count`` regional mock
    apiservers, one region killed mid-flight and resumed; returns the
    SCALE_r03 row."""
    from http.server import ThreadingHTTPServer

    from tpu_cc_manager_torch.ccmanager import federation as federation_mod
    from tpu_cc_manager_torch.kubeclient.rest import ClusterConfig, RestKube

    mock = _load_mock()
    ns = "tpu-operator"
    nodes_per_region = total_nodes // regions_count
    regions = [f"r{i:02d}" for i in range(regions_count)]
    kill_region = regions[kill_region_index % len(regions)]
    if kill_at is None:
        # Deep enough to be mid-rollout, shallow enough that small smoke
        # fleets (tests) still reach it before the region completes.
        kill_at = 40 if nodes_per_region >= 1000 else 8
    flight_dir = tempfile.mkdtemp(prefix="scale-federation-")

    servers: list = []
    region_urls: dict[str, str] = {}
    region_states: dict[str, object] = {}
    sims: dict[str, ServerAgentSim] = {}

    def start_server(state) -> str:
        state.start_threads()
        srv = ThreadingHTTPServer(
            ("127.0.0.1", 0), mock.make_handler(state)
        )
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}"

    # The control plane: ONLY the parent record's CAS lease lives here,
    # so the per-region load gate measures regional traffic alone.
    control_state = mock.MockState()
    control_url = start_server(control_state)
    for region in regions:
        state = mock.MockState()
        _federation_region_fleet(state, region, nodes_per_region)
        region_urls[region] = start_server(state)
        region_states[region] = state
        sims[region] = ServerAgentSim(
            state, seed=seed, min_delay_s=0.01, max_delay_s=0.04,
            scan_interval_s=0.1,
        )

    def control_client():
        return RestKube(ClusterConfig(server=control_url, token="scale-bench"))

    parent = federation_mod.ParentStore(
        control_client(), namespace=ns
    ).initialize(
        federation_mod.ParentRecord.fresh(
            "on", SELECTOR, regions,
            max_unavailable=shards * per_shard_unavailable,
        ),
        resume=False,
    )

    results: dict[str, dict] = {}
    errors: dict[str, BaseException] = {}
    flight_files: dict[str, list[str]] = {region: [] for region in regions}
    results_lock = threading.Lock()

    def run_leg(region, client, lease, resume_record, gate, flight_path):
        informer = NodeInformer(
            client, federation_mod.regional_selector(SELECTOR, region),
            page_limit=500,
        ).start(sync_timeout_s=120.0)
        crash_hook = None
        if region == kill_region and resume_record is None:
            calls = {"n": 0}

            def killer(point):
                if calls["n"] == kill_at:
                    raise OrchestratorKilled(point, calls["n"])
                calls["n"] += 1

            crash_hook = killer
        try:
            roller = RollingReconfigurator(
                client,
                federation_mod.regional_selector(SELECTOR, region),
                max_unavailable=per_shard_unavailable,
                poll_interval_s=poll_interval_s,
                node_timeout_s=node_timeout_s,
                informer=informer,
                wave_shards=shards,
                lease=lease,
                resume_record=resume_record,
                crash_hook=crash_hook,
                flight=flight_mod.FlightRecorder(
                    flight_path, generation=lease.generation
                ),
                federation=gate,
            )
            mode = resume_record.mode if resume_record is not None else "on"
            return roller.rollout(mode)
        finally:
            informer.stop()

    def run_region(region: str) -> None:
        client = CountingKube(
            RestKube(
                ClusterConfig(server=region_urls[region], token="scale-bench")
            )
        )
        store = federation_mod.ParentStore(control_client(), namespace=ns)
        # Injected lease clock (gateway-stitch idiom): time stands still
        # during a leg, so leases never lapse mid-run without a renewer,
        # and the kill leg advances past the dead holder's TTL exactly.
        clk = _BenchClock()
        killed = resumed = False
        t0 = time.monotonic()
        result = None
        try:
            lease = rollout_state.RolloutLease(
                client, holder=f"bench-{region}-a", namespace=ns,
                name=federation_mod.regional_lease_name(region),
                duration_s=30.0, wall=clk, clock=clk,
            )
            lease.acquire()
            gate = federation_mod.FederationGate(store, region)
            gate.attach(parent)
            path_a = os.path.join(flight_dir, f"orch-{region}-a.jsonl")
            flight_files[region].append(path_a)
            try:
                result = run_leg(region, client, lease, None, gate, path_a)
            except OrchestratorKilled:
                killed = True
                clk.advance(31.0)  # dead holder's lease TTL lapses
                lease_b = rollout_state.RolloutLease(
                    client, holder=f"bench-{region}-b", namespace=ns,
                    name=federation_mod.regional_lease_name(region),
                    duration_s=30.0, wall=clk, clock=clk,
                )
                record = lease_b.acquire()
                if record is None or not record.federation:
                    raise RuntimeError(
                        f"{region}: resumed record lost its federation "
                        "attachment"
                    )
                gate_b = federation_mod.FederationGate.from_record_dict(
                    control_client(), record.federation
                )
                resumed = True
                path_b = os.path.join(flight_dir, f"orch-{region}-b.jsonl")
                flight_files[region].append(path_b)
                lease = lease_b
                result = run_leg(
                    region, client, lease_b, record, gate_b, path_b
                )
            lease.release(clear_record=bool(result.ok))
        except BaseException as e:  # noqa: BLE001  # cclint: crash-ok(region thread trampoline: the exception is stashed in `errors` and re-raised in the caller after join)
            with results_lock:
                errors[region] = e
            return
        with results_lock:
            results[region] = {
                "ok": bool(result.ok),
                "groups": len(result.groups),
                "seconds": round(time.monotonic() - t0, 2),
                "killed": killed,
                "resumed": resumed,
            }

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=run_region, args=(region,), daemon=True)
        for region in regions
    ]
    final = None
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seconds = time.monotonic() - t0
        if not errors:
            final = federation_mod.ParentStore(
                control_client(), namespace=ns
            ).load()
    finally:
        for sim in sims.values():
            sim.stop()
        for srv in servers:
            srv.shutdown()
    if errors:
        region, err = sorted(errors.items())[0]
        raise RuntimeError(f"region {region} failed: {err!r}") from err

    baseline = _r02_baseline_per_node()
    per_node_budget = round(baseline + FEDERATION_PER_NODE_ALLOWANCE, 3)
    per_apiserver: dict[str, dict] = {}
    load_ok = True
    for region in regions:
        state = region_states[region]
        with state.lock:
            counts = dict(sorted(state.request_counts.items()))
            converged = all(
                node["metadata"]["labels"].get(CC_MODE_STATE_LABEL) == "on"
                for node in state.nodes.values()
            )
        total = sum(counts.values())
        per_node = round(total / max(1, nodes_per_region), 3)
        ok_region = per_node <= per_node_budget and converged
        load_ok = load_ok and ok_region
        per_apiserver[region] = {
            "requests": counts,
            "total": total,
            "per_node": per_node,
            "converged": converged,
        }
    with control_state.lock:
        control_requests = dict(sorted(control_state.request_counts.items()))

    all_paths = [p for region in regions for p in flight_files[region]]
    stitched, torn = flight_mod.stitch_files(all_paths)
    rec = flight_mod.reconstruct(stitched)
    all_nodes = {
        f"{region}-n{i:05d}"
        for region in regions
        for i in range(nodes_per_region)
    }
    exactly_once = (
        set(rec["nodes"]) == all_nodes
        and not rec["duplicate_node_events"]
        and all(
            e["outcome"] == "node-converged" for e in rec["nodes"].values()
        )
    )
    killed_row = results.get(kill_region, {})
    ok = bool(
        results
        and all(r["ok"] for r in results.values())
        and final is not None
        and final.status == federation_mod.PARENT_COMPLETE
        and load_ok
        and killed_row.get("killed")
        and killed_row.get("resumed")
        and torn == 0
        and exactly_once
    )
    return {
        "mode": "federation",
        "nodes": total_nodes,
        "transport": "http",
        "ok": ok,
        "seconds": round(seconds, 2),
        "regions": regions_count,
        "nodes_per_region": nodes_per_region,
        "wave_shards": shards,
        "max_unavailable_per_region": per_shard_unavailable * shards,
        "killed_region": kill_region,
        "kill_at": kill_at,
        "parent_status": final.status if final is not None else "missing",
        "budget_spend": len(final.budget_spend) if final is not None else -1,
        "region_results": {r: results[r] for r in sorted(results)},
        "per_apiserver": per_apiserver,
        "baseline_per_node_r02": round(baseline, 3),
        "per_node_budget": per_node_budget,
        "apiserver_load_ok": load_ok,
        "control_plane_requests": control_requests,
        "stitch": {
            "files": len(all_paths),
            "events": len(stitched),
            "torn_lines": torn,
            "resumes": rec["resumes"],
            "generations": sorted(rec["generations"]),
            "exactly_once": exactly_once,
        },
    }


# ---------------------------------------------------------------------------
# --federation-blackout mode: the partition acceptance bench (SCALE_r04).
# Same federated topology as --federation, but the PARENT PLANE goes
# dark mid-rollout — per-region FaultyKubeClient wrappers around the
# control-plane client refuse every parent CAS while a blackout window
# is open. What the bench must prove:
#  - every region either completes or escrow-halts WITHOUT the parent:
#    healthy regions ride seeded blackout windows, charge nothing, and
#    reconcile on reconnect; the escrow region times out a dead slice
#    while dark, charges its escrowed budget slice, and halts
#    `escrow-exhausted` the moment dark spend would exceed it;
#  - a SIGKILL at the `parent-offline` crash point (mid-blackout) is
#    survivable: the successor takes the regional lease over through the
#    skew-proof observation window (its wall clock disagrees with the
#    dead holder's by ~135 s) and dark-resumes from the checkpointed
#    escrow ledger;
#  - reconciliation is exactly-once: after every region reconnects, the
#    parent's budget_spend is EXACTLY the dead slice — no dark charge
#    lost, none double-counted, every unused escrow slice returned;
#  - the stitched cross-region timeline has zero torn lines and every
#    node's final outcome is converged exactly once.
# ---------------------------------------------------------------------------


def run_federation_blackout(
    total_nodes: int = 100_000,
    regions_count: int = 10,
    seed: int = DEFAULT_SEED,
    shards: int = 8,
    per_shard_unavailable: int = 25,
    poll_interval_s: float = 0.05,
    # Healthy nodes converge in up to ~60 s under full 100k-node thread
    # contention; only the escrow region's dead slice may time out, so
    # the bar sits at 2x the observed worst case.
    node_timeout_s: float = 120.0,
    kill_region_index: int = 3,
    escrow_region_index: int = 5,
    hetero_region_index: int = 2,
    max_clock_skew_s: float = 150.0,
) -> dict:
    """One federated rollout through a parent-plane blackout; returns
    the SCALE_r04 row."""
    from http.server import ThreadingHTTPServer

    from tpu_cc_manager_torch.ccmanager import federation as federation_mod
    from tpu_cc_manager_torch.kubeclient.rest import ClusterConfig, RestKube

    if regions_count < 4:
        raise ValueError("--federation-blackout needs >= 4 regions")
    mock = _load_mock()
    ns = "tpu-operator"
    nodes_per_region = total_nodes // regions_count
    windows = -(-nodes_per_region // max(1, shards * per_shard_unavailable))
    regions = [f"r{i:02d}" for i in range(regions_count)]
    kill_region = regions[kill_region_index % regions_count]
    escrow_region = regions[escrow_region_index % regions_count]
    hetero_region = regions[hetero_region_index % regions_count]
    if len({kill_region, escrow_region, hetero_region}) != 3:
        raise ValueError(
            "kill/escrow/hetero region indices must map to distinct regions"
        )
    # The dead slice: ALL hosts of ONE slice (hosts are striped across
    # the region: slice s = {s + j*slice_count}). A fully-dead slice
    # keeps the stitched timeline exactly-once — its resume re-drives
    # only FAILED nodes (the designed re-drive path), never re-bouncing
    # a converged one — and its whole charge lands at one boundary, so
    # the escrow halt is deterministic.
    hosts_per_slice = 4
    slice_count = max(1, nodes_per_region // hosts_per_slice)
    dead_slice = int(slice_count * 0.3)
    dead_live = {
        f"{escrow_region}-n{dead_slice + j * slice_count:05d}"
        for j in range(hosts_per_slice)
    }
    dead_nodes = set(dead_live)
    offline_grace_s = 0.05
    skew_rng = random.Random(seed ^ 0x51E11)
    region_skews = {r: skew_rng.uniform(-120.0, 120.0) for r in regions}
    flight_dir = tempfile.mkdtemp(prefix="scale-blackout-")

    servers: list = []
    region_urls: dict[str, str] = {}
    region_states: dict[str, object] = {}
    sims: dict[str, ServerAgentSim] = {}

    def start_server(state) -> str:
        state.start_threads()
        srv = ThreadingHTTPServer(
            ("127.0.0.1", 0), mock.make_handler(state)
        )
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}"

    control_state = mock.MockState()
    control_url = start_server(control_state)
    for region in regions:
        state = mock.MockState()
        _federation_region_fleet(state, region, nodes_per_region)
        region_urls[region] = start_server(state)
        region_states[region] = state
        sims[region] = ServerAgentSim(
            state, seed=seed, min_delay_s=0.01, max_delay_s=0.04,
            scan_interval_s=0.1,
            dead_nodes=dead_live if region == escrow_region else None,
        )

    def control_client():
        return RestKube(ClusterConfig(server=control_url, token="scale-bench"))

    # Per-region chaos plans over the PARENT client only: the regional
    # apiservers stay healthy — this is a parent-plane partition, not a
    # regional outage. Spans are sized in parent CALLS (one per dark
    # boundary sync) to end well before the terminal status push.
    parent_plans = {
        region: FaultPlan(
            seed=seed * 1009 + idx, rate=0.0, watch_rate=0.0,
            blackout_min_calls=max(2, windows // 3),
            blackout_max_calls=max(max(2, windows // 3) + 1, windows // 2),
        )
        for idx, region in enumerate(regions)
    }
    faulty_controls = {
        region: FaultyKubeClient(
            control_client(), parent_plans[region], sleep=lambda s: None
        )
        for region in regions
    }

    parent = federation_mod.ParentStore(
        control_client(), namespace=ns
    ).initialize(
        federation_mod.ParentRecord.fresh(
            "on", SELECTOR, regions,
            max_unavailable=shards * per_shard_unavailable,
            # Global budget == region count: fair-share escrow resolves
            # to exactly 1 per region, so the escrow region (2 dead
            # hosts) MUST halt while dark, and the total spend stays
            # within budget. One region carries an explicit per-region
            # cap so the heterogeneous-budget parent format (v2) is what
            # this artifact actually serializes.
            failure_budget=regions_count,
            region_budgets={hetero_region: 2},
        ),
        resume=False,
    )

    results: dict[str, dict] = {}
    errors: dict[str, BaseException] = {}
    flight_files: dict[str, list[str]] = {region: [] for region in regions}
    results_lock = threading.Lock()

    def run_leg(region, client, lease, resume_record, gate, flight_path,
                crash_hook):
        informer = NodeInformer(
            client, federation_mod.regional_selector(SELECTOR, region),
            page_limit=500,
        ).start(sync_timeout_s=120.0)
        try:
            roller = RollingReconfigurator(
                client,
                federation_mod.regional_selector(SELECTOR, region),
                max_unavailable=per_shard_unavailable,
                poll_interval_s=poll_interval_s,
                node_timeout_s=node_timeout_s,
                informer=informer,
                wave_shards=shards,
                lease=lease,
                resume_record=resume_record,
                crash_hook=crash_hook,
                # A timed-out slice must CHARGE the budget and press on
                # (degraded-mode semantics), not halt the whole region.
                continue_on_failure=True,
                flight=flight_mod.FlightRecorder(
                    flight_path, generation=lease.generation
                ),
                federation=gate,
            )
            mode = resume_record.mode if resume_record is not None else "on"
            return roller.rollout(mode)
        finally:
            informer.stop()

    def regional_lease(client, region, holder, clk, skew):
        return rollout_state.RolloutLease(
            client, holder=holder, namespace=ns,
            name=federation_mod.regional_lease_name(region),
            duration_s=30.0, wall=lambda: clk() + skew, clock=clk,
            max_clock_skew_s=max_clock_skew_s,
        )

    def run_region(region: str) -> None:
        client = CountingKube(
            RestKube(
                ClusterConfig(server=region_urls[region], token="scale-bench")
            )
        )
        plan = parent_plans[region]
        parent_api = faulty_controls[region]
        store = federation_mod.ParentStore(parent_api, namespace=ns)
        clk = _BenchClock()
        skew_a = region_skews[region]
        killed = resumed = resumed_dark = False
        escrow_halted_dark = escrow_resumed = False
        t0 = time.monotonic()
        result = None
        try:
            lease = regional_lease(
                client, region, f"bench-{region}-a", clk, skew_a
            )
            lease.acquire()
            gate = federation_mod.FederationGate(
                store, region, offline_grace_s=offline_grace_s
            )
            gate.attach(parent)  # attach is LIGHT: escrow reserved via CAS

            boundaries = {"n": 0}

            def hook(point):
                if point == "federation-boundary":
                    boundaries["n"] += 1
                    if region in (kill_region, escrow_region):
                        # Forced open-ended blackout from the FIRST
                        # boundary: every charge these regions make is
                        # guaranteed dark; the bench closes the window.
                        if boundaries["n"] == 1:
                            plan.begin_blackout()
                    elif boundaries["n"] == 2:
                        # Healthy regions ride a finite SEEDED window —
                        # the production chaos path — and reconnect
                        # before their terminal push.
                        plan.seed_blackout_window()
                if region == kill_region and point == "parent-offline":
                    raise OrchestratorKilled(point, boundaries["n"])

            path_a = os.path.join(flight_dir, f"orch-{region}-a.jsonl")
            flight_files[region].append(path_a)
            try:
                result = run_leg(region, client, lease, None, gate, path_a,
                                 hook)
            except OrchestratorKilled:
                killed = True
                clk.advance(31.0)  # dead holder's lease TTL lapses
                # The successor's wall clock disagrees with the dead
                # holder's by ~135 s, forcing acquire() through the
                # skew-proof observation window (expired OR
                # future-stamped, depending on sign). The observation
                # deadline runs on LOCAL monotonic time — a ticker
                # drives the injected bench clock through it.
                skew_b = skew_a + (135.0 if skew_a < 0 else -135.0)
                lease_b = regional_lease(
                    client, region, f"bench-{region}-b", clk, skew_b
                )
                stop_tick = threading.Event()

                def _tick():
                    while not stop_tick.wait(0.1):
                        clk.advance(4.0)

                ticker = threading.Thread(target=_tick, daemon=True)
                ticker.start()
                try:
                    record = lease_b.acquire()
                finally:
                    stop_tick.set()
                    ticker.join(timeout=2.0)
                if record is None or not record.federation:
                    raise RuntimeError(
                        f"{region}: resumed record lost its federation "
                        "attachment"
                    )
                # The successor comes up with the parent STILL dark (a
                # bounded re-armed window): the dark-resume path must
                # adopt the checkpointed escrow ledger, then reconcile
                # when the window expires. Two calls — the dark attach
                # plus one boundary — so even a successor with almost
                # nothing left to do still pushes its terminal status
                # through a LIVE parent.
                plan.end_blackout()
                plan.begin_blackout(calls=2)
                refusals_before = plan.blackout_refusals
                gate_b = federation_mod.FederationGate.from_record_dict(
                    parent_api, record.federation,
                    offline_grace_s=offline_grace_s,
                )
                resumed = True
                resumed_dark = plan.blackout_refusals > refusals_before
                path_b = os.path.join(flight_dir, f"orch-{region}-b.jsonl")
                flight_files[region].append(path_b)
                lease = lease_b
                result = run_leg(
                    region, client, lease_b, record, gate_b, path_b, None
                )
            if (
                region == escrow_region
                and result is not None
                and not result.ok
                and result.halted_reason
                == federation_mod.ESCROW_EXHAUSTED_REASON
            ):
                # The region halted autonomously, in the dark, with its
                # escrow slice spent on the dead hosts. Hardware
                # recovers, the parent plane comes back, and an operator
                # re-drives: the resume must reconcile the dark charges
                # exactly once and finish the remaining windows.
                escrow_halted_dark = plan.in_blackout
                plan.end_blackout()
                lease.release(clear_record=False)
                lease_c = regional_lease(
                    client, region, f"bench-{region}-c", clk, skew_a
                )
                record = lease_c.acquire()
                if record is None or not record.federation:
                    raise RuntimeError(
                        f"{region}: halted record lost its federation "
                        "attachment"
                    )
                gate_c = federation_mod.FederationGate.from_record_dict(
                    parent_api, record.federation,
                    offline_grace_s=offline_grace_s,
                )
                escrow_resumed = True
                path_c = os.path.join(flight_dir, f"orch-{region}-c.jsonl")
                flight_files[region].append(path_c)
                lease = lease_c

                # The dead hardware recovers only once the successor has
                # taken its pre-recovery listing and committed to
                # RE-DRIVING the failed group — window-start fires
                # strictly after the resume plan, so the timeline always
                # shows the designed `redriven` supersede instead of a
                # timing-dependent already-at-target re-observation (the
                # agent sim's scan loop would otherwise race the resume
                # listing and self-heal the slice, leaving node-failed
                # as the reconstructed outcome).
                def recovery_hook(point):
                    if point == "window-start" and dead_live:
                        dead_live.clear()

                result = run_leg(
                    region, client, lease_c, record, gate_c, path_c,
                    recovery_hook,
                )
            lease.release(clear_record=bool(result.ok))
        except BaseException as e:  # noqa: BLE001  # cclint: crash-ok(region thread trampoline: the exception is stashed in `errors` and re-raised in the caller after join)
            with results_lock:
                errors[region] = e
            return
        with results_lock:
            results[region] = {
                "ok": bool(result.ok),
                "groups": len(result.groups),
                "seconds": round(time.monotonic() - t0, 2),
                "killed": killed,
                "resumed": resumed,
                "resumed_dark": resumed_dark,
                "escrow_halted_dark": escrow_halted_dark,
                "escrow_resumed": escrow_resumed,
                "parent_blackout_windows": plan.blackout_windows,
                "parent_refusals": plan.blackout_refusals,
            }

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=run_region, args=(region,), daemon=True)
        for region in regions
    ]
    final = None
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seconds = time.monotonic() - t0
        if not errors:
            final = federation_mod.ParentStore(
                control_client(), namespace=ns
            ).load()
    finally:
        for sim in sims.values():
            sim.stop()
        for srv in servers:
            srv.shutdown()
    if errors:
        region, err = sorted(errors.items())[0]
        raise RuntimeError(f"region {region} failed: {err!r}") from err

    baseline = _r02_baseline_per_node()
    per_node_budget = round(baseline + FEDERATION_PER_NODE_ALLOWANCE, 3)
    per_apiserver: dict[str, dict] = {}
    load_ok = True
    for region in regions:
        state = region_states[region]
        with state.lock:
            counts = dict(sorted(state.request_counts.items()))
            converged = all(
                node["metadata"]["labels"].get(CC_MODE_STATE_LABEL) == "on"
                for node in state.nodes.values()
            )
        total = sum(counts.values())
        per_node = round(total / max(1, nodes_per_region), 3)
        load_ok = load_ok and per_node <= per_node_budget and converged
        per_apiserver[region] = {
            "requests": counts,
            "total": total,
            "per_node": per_node,
            "converged": converged,
        }
    with control_state.lock:
        control_requests = dict(sorted(control_state.request_counts.items()))

    all_paths = [p for region in regions for p in flight_files[region]]
    stitched, torn = flight_mod.stitch_files(all_paths)
    rec = flight_mod.reconstruct(stitched)
    all_nodes = {
        f"{region}-n{i:05d}"
        for region in regions
        for i in range(nodes_per_region)
    }
    exactly_once = (
        set(rec["nodes"]) == all_nodes
        and not rec["duplicate_node_events"]
        and all(
            e["outcome"] == "node-converged" for e in rec["nodes"].values()
        )
    )
    offline_events = sum(
        1 for e in stitched
        if e.get("event") == flight_mod.EVENT_PARENT_OFFLINE
    )
    reconnect_events = sum(
        1 for e in stitched
        if e.get("event") == flight_mod.EVENT_PARENT_RECONNECT
    )
    spend = sorted(final.budget_spend) if final is not None else []
    # Exactly-once reconciliation, ledger-level: the parent's spend is
    # PRECISELY the dead slice (no dark charge lost or double-counted)
    # and every escrow slice went back to zero on terminal sync.
    spend_exact = spend == sorted(dead_nodes)
    escrow_zeroed = final is not None and all(
        v == 0 for v in final.escrow.values()
    )
    killed_row = results.get(kill_region, {})
    escrow_row = results.get(escrow_region, {})
    ok = bool(
        results
        and all(r["ok"] for r in results.values())
        and final is not None
        and final.status == federation_mod.PARENT_COMPLETE
        and final.region_budgets.get(hetero_region) == 2
        and killed_row.get("killed")
        and killed_row.get("resumed")
        and killed_row.get("resumed_dark")
        and escrow_row.get("escrow_halted_dark")
        and escrow_row.get("escrow_resumed")
        and spend_exact
        and escrow_zeroed
        and offline_events >= regions_count
        and reconnect_events >= regions_count - 2
        and torn == 0
        and exactly_once
    )
    return {
        "mode": "federation-blackout",
        "nodes": total_nodes,
        "transport": "http",
        "ok": ok,
        "seconds": round(seconds, 2),
        "regions": regions_count,
        "nodes_per_region": nodes_per_region,
        "wave_shards": shards,
        "max_unavailable_per_region": per_shard_unavailable * shards,
        "failure_budget": regions_count,
        "region_budgets": {hetero_region: 2},
        "killed_region": kill_region,
        "escrow_region": escrow_region,
        "dead_nodes": sorted(dead_nodes),
        "max_clock_skew_s": max_clock_skew_s,
        "parent_status": final.status if final is not None else "missing",
        "budget_spend": spend,
        "budget_spend_exactly_dead_slice": spend_exact,
        "escrow_zeroed": escrow_zeroed,
        "parent_offline_events": offline_events,
        "parent_reconnect_events": reconnect_events,
        "region_results": {r: results[r] for r in sorted(results)},
        "per_apiserver": per_apiserver,
        "baseline_per_node_r02": round(baseline, 3),
        "per_node_budget": per_node_budget,
        # Informational here (the load acceptance gate is SCALE_r03):
        # this bench gates partition-tolerance invariants, but a load
        # regression would still show up in these rows.
        "apiserver_load_ok": load_ok,
        "control_plane_requests": control_requests,
        "stitch": {
            "files": len(all_paths),
            "events": len(stitched),
            "torn_lines": torn,
            "resumes": rec["resumes"],
            "generations": sorted(rec["generations"]),
            "exactly_once": exactly_once,
        },
    }


def run_pool(
    n: int,
    mode: str,
    seed: int = DEFAULT_SEED,
    shards: int = 8,
    per_shard_unavailable: int = 4,
    poll_interval_s: float = 0.2,
    node_timeout_s: float = 120.0,
    hosts_per_slice: int = 4,
) -> dict:
    """One full rollout over an n-node fleet; returns the measured row."""
    fake = FakeKube()
    build_fleet(fake, n, hosts_per_slice=hosts_per_slice)
    sim = AgentSim(fake, seed=seed)
    counting = CountingKube(fake)
    informer = None
    total_unavailable = shards * per_shard_unavailable
    try:
        if mode == "informer":
            informer = NodeInformer(
                counting, SELECTOR, page_limit=500,
            ).start(sync_timeout_s=60.0)
            roller = RollingReconfigurator(
                counting, SELECTOR,
                max_unavailable=per_shard_unavailable,
                poll_interval_s=poll_interval_s,
                node_timeout_s=node_timeout_s,
                informer=informer,
                wave_shards=shards,
            )
        else:
            roller = RollingReconfigurator(
                counting, SELECTOR,
                max_unavailable=total_unavailable,
                poll_interval_s=poll_interval_s,
                node_timeout_s=node_timeout_s,
            )
        t0 = time.monotonic()
        result = roller.rollout("on")
        seconds = time.monotonic() - t0
    finally:
        if informer is not None:
            informer.stop()
        sim.stop()
    converged = all(
        node_labels(node).get(CC_MODE_STATE_LABEL) == "on"
        for node in fake.list_nodes(SELECTOR)
    )
    return {
        "nodes": n,
        "mode": mode,
        "ok": bool(result.ok and converged),
        "converged": converged,
        "seconds": round(seconds, 2),
        "groups": len(result.groups),
        "wave_shards": shards if mode == "informer" else 1,
        "max_unavailable_total": total_unavailable,
        "orchestrator_requests": dict(sorted(counting.counts.items())),
        "fleet_requests": dict(sorted(fake.request_counts.items())),
        "agent_transitions": sim.transitions,
        "agent_errors": sim.errors,
    }


# ---------------------------------------------------------------------------
# --gateway mode: the fleet observability plane (obs/fleet.py) over a
# simulated 100-node fleet — the gateway acceptance bench. Three legs:
# a full-fleet scrape+merge must converge inside one gateway interval
# with a lint-clean merged exposition and a correct capacity ledger;
# killed agents must be marked stale within 2 intervals; and a sharded
# rollout killed mid-flight and resumed by a successor — each run
# writing its OWN flight file, like per-region orchestrators — must
# stitch back into one federated timeline that reconstructs every
# node's outcome exactly once.
# ---------------------------------------------------------------------------


class _BenchClock:
    """Injected lease clock for the stitch leg (advance past the lease
    TTL without waiting it out)."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def build_fleet_registries(
    n: int, seed: int
) -> tuple[dict[str, MetricsRegistry], set[str], set[str]]:
    """n per-node agent registries with seeded serve telemetry, plus the
    (disjoint) sets of quarantined and prestaging nodes — so the
    capacity ledger's expected headroom count is computable exactly."""
    registries: dict[str, MetricsRegistry] = {}
    quarantined: set[str] = set()
    prestaging: set[str] = set()
    for i in range(n):
        name = f"fleet-n{i:05d}"
        rng = random.Random(zlib.crc32(f"{seed}:obs:{name}".encode()))
        reg = MetricsRegistry()
        for _ in range(rng.randint(3, 8)):
            reg.observe_serve_request(name, rng.uniform(0.01, 0.5))
        reg.set_serve_queue_depth(name, rng.randint(0, 6))
        reg.set_serve_inflight(name, rng.randint(0, 4))
        reg.record_serve_outcome(name, "completed", rng.randint(5, 40))
        reg.set_serve_hbm_bw_util(name, rng.uniform(0.30, 0.85))
        if i % 29 == 7:
            reg.set_quarantined(True)
            quarantined.add(name)
        elif i % 31 == 11:
            reg.set_prestage_in_progress(True)
            prestaging.add(name)
        registries[name] = reg
    return registries, quarantined, prestaging


def run_gateway_scrape(
    n: int,
    seed: int = DEFAULT_SEED,
    interval_s: float = 5.0,
    kill: int = 10,
    workers: int = 16,
) -> dict:
    """Legs 1+2: full-fleet scrape+merge convergence and staleness."""
    registries, quarantined, prestaging = build_fleet_registries(n, seed)
    alive = {name: True for name in registries}

    def target(name: str, reg: MetricsRegistry):
        inner = fleet_mod.local_target(reg)

        def fetch(path: str) -> str:
            if not alive[name]:
                raise ConnectionError("agent killed by bench chaos")
            return inner(path)

        return fetch

    gateway = fleet_mod.FleetGateway(
        targets={name: target(name, reg) for name, reg in registries.items()},
        interval_s=interval_s,
        scrape_deadline_s=1.0,
        stale_after_sweeps=2,
        workers=workers,
    )
    t0 = time.monotonic()
    fleetz = gateway.scrape_once()
    sweep_seconds = time.monotonic() - t0
    merged = gateway.metrics_text()
    lint_problems = expo_lint.lint(merged)
    expected_headroom = n - len(quarantined) - len(prestaging)
    headroom_ok = fleetz["fleet"]["headroom_nodes"] == expected_headroom

    killed = sorted(alive)[:kill]
    for name in killed:
        alive[name] = False
    gateway.scrape_once()
    after_one = set(gateway.fleetz()["fleet"]["stale_nodes"])
    gateway.scrape_once()
    after_two = set(gateway.fleetz()["fleet"]["stale_nodes"])
    stale_ok = after_one.issubset(set(killed)) and after_two == set(killed)

    return {
        "nodes": n,
        "sweep_seconds": round(sweep_seconds, 3),
        "interval_s": interval_s,
        "converged_one_interval": bool(sweep_seconds <= interval_s),
        "merged_lines": len(merged.splitlines()),
        "merged_lint_problems": lint_problems,
        "headroom_nodes": fleetz["fleet"]["headroom_nodes"],
        "expected_headroom_nodes": expected_headroom,
        "quarantined": len(quarantined),
        "prestaging": len(prestaging),
        "fleet_p99_present": "tpu_cc_fleet_serve_p99_seconds" in merged,
        "killed_agents": len(killed),
        "stale_after_two_sweeps": sorted(after_two),
        "ok": bool(
            sweep_seconds <= interval_s
            and not lint_problems
            and headroom_ok
            and stale_ok
        ),
    }


def run_gateway_stitch(
    n: int = 16,
    seed: int = DEFAULT_SEED,
    shards: int = 4,
    kill_at: int = 6,
) -> dict:
    """Leg 3: a sharded rollout (wave_shards > 1) killed mid-flight and
    resumed by a successor orchestrator, each writing its OWN flight
    file; stitch_files must reconstruct exactly-once node outcomes
    across the kill."""
    fake = FakeKube()
    build_fleet(fake, n)
    sim = AgentSim(fake, seed=seed, fault_rate=0.0)
    clk = _BenchClock()
    metrics = MetricsRegistry()
    hook_calls = {"n": 0}

    def killer(point):
        if hook_calls["n"] == kill_at:
            raise OrchestratorKilled(point, hook_calls["n"])
        hook_calls["n"] += 1

    stitch_dir = tempfile.mkdtemp(prefix="scale-gateway-stitch-")
    path_a = os.path.join(stitch_dir, "orch-a.jsonl")
    path_b = os.path.join(stitch_dir, "orch-b.jsonl")

    def lease_for(holder: str) -> rollout_state.RolloutLease:
        return rollout_state.RolloutLease(
            fake, holder=holder, namespace="tpu-operator",
            duration_s=30.0, metrics=metrics, wall=clk, clock=clk,
        )

    killed = False
    try:
        lease_a = lease_for("orch-a")
        lease_a.acquire()
        roller_a = RollingReconfigurator(
            fake, SELECTOR, max_unavailable=4, node_timeout_s=10,
            poll_interval_s=0.02, wave_shards=shards, lease=lease_a,
            crash_hook=killer, metrics=metrics,
            flight=flight_mod.FlightRecorder(
                path_a, generation=lease_a.generation
            ),
        )
        try:
            result = roller_a.rollout("on")
        except OrchestratorKilled:
            killed = True
            clk.advance(31.0)  # the dead holder's lease TTL lapses
            lease_b = lease_for("orch-b")
            record = lease_b.acquire()
            roller_b = RollingReconfigurator(
                fake, SELECTOR, max_unavailable=4, node_timeout_s=10,
                poll_interval_s=0.02, wave_shards=shards, lease=lease_b,
                resume_record=record, metrics=metrics,
                flight=flight_mod.FlightRecorder(
                    path_b, generation=lease_b.generation
                ),
            )
            result = roller_b.rollout(record.mode if record else "on")
    finally:
        sim.stop()
    stitched, torn = flight_mod.stitch_files([path_a, path_b])
    rec = flight_mod.reconstruct(stitched)
    all_nodes = {f"scale-n{i:05d}" for i in range(n)}
    exactly_once = (
        set(rec["nodes"]) == all_nodes
        and not rec["duplicate_node_events"]
        and all(
            e["outcome"] == "node-converged" for e in rec["nodes"].values()
        )
    )
    streams = sorted({e.get("stream") for e in stitched})
    return {
        "nodes": n,
        "wave_shards": shards,
        "kill_at": kill_at,
        "killed": killed,
        "rollout_ok": bool(result.ok),
        "flight_files": 2,
        "streams_in_stitch": streams,
        "stitched_events": len(stitched),
        "torn_lines": torn,
        "resumes": rec["resumes"],
        "generations": rec["generations"],
        "exactly_once": exactly_once,
        "ok": bool(
            killed
            and result.ok
            and torn == 0
            and exactly_once
            and rec["resumes"] == 1
            and len(rec["generations"]) == 2
        ),
    }


def run_gateway_bench(
    n: int = 100, seed: int = DEFAULT_SEED, shards: int = 4
) -> dict:
    scrape = run_gateway_scrape(n, seed=seed)
    stitch = run_gateway_stitch(seed=seed, shards=max(2, shards))
    return {
        "bench": "fleet_gateway",
        "unit": "one gateway sweep / stitched rollout",
        "fleet_rollup": scrape,
        "stitch": stitch,
        "ok": bool(scrape["ok"] and stitch["ok"]),
    }


def summarize(rows: list[dict]) -> dict:
    by_key = {(r["mode"], r["nodes"]): r for r in rows}
    out: dict = {
        "bench": "scale_rollout",
        "unit": "apiserver requests / rollout",
        "selector": SELECTOR,
        "pools": sorted(rows, key=lambda r: (r["nodes"], r["mode"])),
    }
    drops = {}
    for n in sorted({r["nodes"] for r in rows}):
        legacy = by_key.get(("legacy", n))
        informer = by_key.get(("informer", n))
        if legacy and informer:
            llists = legacy["orchestrator_requests"].get("list", 0)
            ilists = max(1, informer["orchestrator_requests"].get("list", 0))
            drops[str(n)] = round(llists / ilists, 1)
    out["list_request_drop"] = drops
    out["ok"] = bool(
        rows
        and all(r["ok"] for r in rows)
        # The acceptance bar: >=10x fewer list requests at 1k nodes.
        and (drops.get("1000") is None or drops["1000"] >= 10.0)
    )
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default=None)
    parser.add_argument("--modes", default="legacy,informer")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--shards", type=int, default=8)
    parser.add_argument("--out", default=None)
    parser.add_argument(
        "--apiserver", action="store_true",
        help="drive the rollouts over real HTTP through "
        "hack/mock_apiserver.py + RestKube instead of in-process FakeKube "
        "calls (chunked listings, selector watches, lease CAS on the "
        # Seam: the port's artifacts carry a torch_ prefix.
        "wire); defaults to the 1k-node fleet and torch_SCALE_r02.json",
    )
    parser.add_argument(
        "--gateway", action="store_true",
        help="run the fleet observability gateway bench instead of the "
        "rollout benches: 100-node scrape+merge convergence inside one "
        "interval, stale marking of killed agents within 2 intervals, "
        "and a sharded kill+resume rollout stitched back from two "
        # Seam: the port's artifacts carry a torch_ prefix.
        "flight files (obs/fleet.py); defaults to torch_FLEET_r01.json",
    )
    parser.add_argument(
        "--federation", action="store_true",
        help="run the federated region-sharded bench instead: one "
        "rollout over --sizes total nodes split across --regions "
        "per-region mock apiservers, a single global failure budget "
        "CAS-settled through a control-plane parent record, one region "
        "killed mid-rollout and resumed, and all regional flight files "
        "stitched into one exactly-once timeline; defaults to 100000 "
        # Seam: the port's artifacts carry a torch_ prefix.
        "nodes, 10 regions, torch_SCALE_r03.json",
    )
    parser.add_argument(
        "--federation-blackout", action="store_true",
        help="run the parent-plane partition bench instead: the "
        "--federation topology with every region's parent client riding "
        "a chaos blackout mid-rollout — healthy regions reconnect and "
        "reconcile, one region SIGKILLed at the parent-offline crash "
        "point dark-resumes through the skew-proof lease observation "
        "window, and one region escrow-halts on a dead slice while dark "
        "then resumes to completion; defaults to 100000 nodes, 10 "
        # Seam: the port's artifacts carry a torch_ prefix.
        "regions, torch_SCALE_r04.json",
    )
    parser.add_argument(
        "--regions", type=int, default=10,
        help="region (= per-region apiserver) count for --federation "
        "and --federation-blackout",
    )
    parser.add_argument(
        "--partial", default=None,
        help="JSONL of completed (mode,size) rows; existing rows are "
        "skipped on re-run (resume after an interruption)",
    )
    parser.add_argument(
        "--full", action="store_true",
        help="also run legacy mode at 10k nodes (minutes of O(pool) "
        "listings by construction; skipped by default)",
    )
    args = parser.parse_args(argv)
    if args.gateway:
        # Seam: the port's artifacts carry a torch_ prefix.
        out = args.out or "torch_FLEET_r01.json"
        sizes = [int(s) for s in (args.sizes or "100").split(",") if s]
        summary = run_gateway_bench(
            n=sizes[0], seed=args.seed, shards=args.shards
        )
        summary["seed"] = args.seed
        with open(out, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(json.dumps(summary))
        return 0 if summary["ok"] else 1
    if args.federation or args.federation_blackout:
        blackout = args.federation_blackout
        bench_mode = "federation-blackout" if blackout else "federation"
        # Seam: the port's artifacts carry a torch_ prefix.
        out = args.out or ("torch_SCALE_r04.json" if blackout else "torch_SCALE_r03.json")
        total = int((args.sizes or "100000").split(",")[0])
        summary = None
        if args.partial and os.path.exists(args.partial):
            with open(args.partial, encoding="utf-8") as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    if (
                        row.get("mode") == bench_mode
                        and row.get("nodes") == total
                        and row.get("ok")
                    ):
                        summary = row
            if summary is not None:
                print(
                    f">>> resuming: {bench_mode}@{total} already completed "
                    f"in {args.partial}", file=sys.stderr,
                )
        if summary is None:
            print(
                f">>> federated rollout{' (parent blackout)' if blackout else ''}: "
                f"{total} node(s) across "
                f"{args.regions} regional apiserver(s)", file=sys.stderr,
            )
            runner = run_federation_blackout if blackout else run_federation
            summary = runner(
                total_nodes=total, regions_count=args.regions,
                seed=args.seed, shards=args.shards,
            )
            if args.partial:
                os.makedirs(
                    os.path.dirname(args.partial) or ".", exist_ok=True
                )
                with open(args.partial, "a", encoding="utf-8") as f:
                    f.write(json.dumps(summary) + "\n")
        summary["bench"] = (
            "federated_blackout_rollout" if blackout
            else "federated_scale_rollout"
        )
        summary["unit"] = (
            "partition-tolerance invariants / federated rollout"
            if blackout
            else "per-apiserver requests / federated rollout"
        )
        summary["seed"] = args.seed
        with open(out, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(json.dumps(summary))
        return 0 if summary["ok"] else 1
    if args.sizes is None:
        args.sizes = "1000" if args.apiserver else "100,1000,10000"
    if args.out is None:
        # Seam: the port's artifacts carry a torch_ prefix.
        args.out = "torch_SCALE_r02.json" if args.apiserver else "torch_SCALE_r01.json"
    runner = run_pool_apiserver if args.apiserver else run_pool
    sizes = [int(s) for s in args.sizes.split(",") if s]
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    rows: list[dict] = []
    done: set[tuple[str, int]] = set()
    if args.partial and os.path.exists(args.partial):
        dropped = 0
        with open(args.partial, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    row = json.loads(line)
                    # Only SUCCESSFUL rows are resume-skippable: keeping
                    # an ok:false row would pin the combo as "done", so
                    # every later run would recompute the same failed
                    # summary without ever re-attempting the pool.
                    if not row.get("ok"):
                        dropped += 1
                        continue
                    rows.append(row)
                    done.add((row["mode"], row["nodes"]))
        if done or dropped:
            print(
                f">>> resuming: {len(done)} completed run(s) in "
                f"{args.partial}"
                + (f"; re-buying {dropped} failed row(s)" if dropped
                   else ""),
                file=sys.stderr,
            )
    for n in sizes:
        for mode in modes:
            if (mode, n) in done:
                continue
            if mode == "legacy" and n >= 10000 and not args.full:
                print(
                    f">>> skipping legacy@{n} (O(pool) by construction; "
                    "--full to run it anyway)", file=sys.stderr,
                )
                continue
            print(
                f">>> rollout: {mode} mode, {n} node(s)"
                + (" over HTTP (mock apiserver)" if args.apiserver else ""),
                file=sys.stderr,
            )
            row = runner(n, mode, seed=args.seed, shards=args.shards)
            print(
                f">>> {mode}@{n}: ok={row['ok']} {row['seconds']}s "
                f"requests={row['orchestrator_requests']}",
                file=sys.stderr,
            )
            rows.append(row)
            if args.partial:
                os.makedirs(
                    os.path.dirname(args.partial) or ".", exist_ok=True
                )
                with open(args.partial, "a", encoding="utf-8") as f:
                    f.write(json.dumps(row) + "\n")
    summary = summarize(rows)
    summary["seed"] = args.seed
    # Every SCALE artifact carries a fleet-rollup section: one gateway
    # sweep over a seeded 100-agent fleet (obs/fleet.py) — cheap, and it
    # keeps the federation path exercised wherever the rollout bench
    # runs. The rollup is informational here; the full acceptance gate
    # is the --gateway bench (FLEET_r01.json).
    rollup = run_gateway_scrape(100, seed=args.seed)
    summary["fleet_rollup"] = {
        k: rollup[k] for k in (
            "nodes", "sweep_seconds", "converged_one_interval",
            "headroom_nodes", "stale_after_two_sweeps", "ok",
        )
    }
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
