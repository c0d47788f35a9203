"""In-memory fake apiserver implementing KubeApi.

Used by unit/integration tests and by bench.py's no-cluster dry-run
(BASELINE.json configs[0]). The reference project has no fake backend at all
(SURVEY.md §4) — this is the deliberate fix.

Features beyond a dumb store, each needed by a specific test scenario:

- monotonically increasing resourceVersions with a watch event log,
- configurable "compaction" so old resourceVersions raise 410 Gone
  (exercises the resync path, reference main.py:670-682),
- injectable transport errors / ERROR events on the watch stream
  (exercises the consecutive-error cap, reference main.py:659-668),
- reactors: callbacks fired after each node label patch, used to emulate the
  operator controller that deletes component pods when it sees the paused
  label (the reference relies on the external GPU operator for this,
  gpu_operator_eviction.py:185-207).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Callable, Iterator, Mapping

from tpu_cc_manager_torch.kubeclient.api import KubeApi, KubeApiError, WatchEvent


def _match_label_selector(labels: Mapping[str, str], selector: str | None) -> bool:
    if not selector:
        return True
    for term in selector.split(","):
        term = term.strip()
        if not term:
            continue
        if "=" in term:
            k, _, v = term.partition("=")
            if labels.get(k.strip()) != v.strip():
                return False
        elif labels.get(term) is None:
            return False
    return True


def _match_pod_field_selector(pod: dict, selector: str | None) -> bool:
    if not selector:
        return True
    for term in selector.split(","):
        k, _, v = term.partition("=")
        k, v = k.strip(), v.strip()
        if k == "spec.nodeName":
            if (pod.get("spec") or {}).get("nodeName") != v:
                return False
        elif k == "metadata.name":
            if (pod.get("metadata") or {}).get("name") != v:
                return False
        elif k == "status.phase":
            if (pod.get("status") or {}).get("phase") != v:
                return False
        else:
            raise KubeApiError(400, f"unsupported field selector {k!r}")
    return True


class FakeKube(KubeApi):
    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._rv = 0
        self._compacted_before = 0  # rvs strictly below this are 410-Gone
        self._nodes: dict[str, dict] = {}
        self._pods: dict[tuple[str, str], dict] = {}  # (namespace, name) -> pod
        self._leases: dict[tuple[str, str], dict] = {}  # (namespace, name)
        self._node_events: list[tuple[int, WatchEvent]] = []
        # In-flight chunked listings: continue tokens serve from the
        # snapshot taken at the FIRST page (like the real apiserver's
        # etcd-revision-pinned continuation), never the live store — a
        # node changing between pages must not shift the sort and drop a
        # neighbor from the listing. token -> (pages' items, listing rv).
        self._page_snapshots: dict[str, tuple[list[dict], str]] = {}
        self._page_snapshot_seq = 0
        self._watch_faults: list[Exception | WatchEvent] = []
        self._patch_reactors: list[Callable[[str, dict], None]] = []
        # Counters some tests assert on.
        self.patch_calls = 0
        self.list_pod_calls = 0
        # Per-verb request accounting, apiserver-side (what a real
        # apiserver's QPS dashboard would show): the scale harness
        # (hack/scale_bench.py) reads this to prove the informer refactor
        # turned O(pool) listings into O(changes) watch traffic.
        self.request_counts: dict[str, int] = {}
        # Events emitted via create_event, in order (tests assert on them).
        self.events: list[dict] = []

    def _count(self, verb: str) -> None:
        # Caller need not hold the lock; GIL-atomic enough for counters
        # read only after the workload quiesces.
        self.request_counts[verb] = self.request_counts.get(verb, 0) + 1

    # ---- test harness helpers -------------------------------------------

    def add_node(self, name: str, labels: dict | None = None) -> dict:
        with self._lock:
            self._rv += 1
            node = {
                "kind": "Node",
                "metadata": {
                    "name": name,
                    "labels": dict(labels or {}),
                    "resourceVersion": str(self._rv),
                },
            }
            self._nodes[name] = node
            self._record_event("ADDED", node)
            return copy.deepcopy(node)

    def add_pod(
        self,
        namespace: str,
        name: str,
        node_name: str,
        labels: dict | None = None,
        phase: str = "Running",
    ) -> dict:
        with self._lock:
            self._rv += 1
            pod = {
                "kind": "Pod",
                "metadata": {
                    "name": name,
                    "namespace": namespace,
                    "labels": dict(labels or {}),
                    "resourceVersion": str(self._rv),
                },
                "spec": {"nodeName": node_name},
                "status": {"phase": phase},
            }
            self._pods[(namespace, name)] = pod
            return copy.deepcopy(pod)

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            self._pods.pop((namespace, name), None)

    def delete_pods_matching(self, namespace: str, label_selector: str) -> int:
        """Emulates the operator controller reacting to a paused label."""
        with self._lock:
            doomed = [
                key
                for key, pod in self._pods.items()
                if key[0] == namespace
                and _match_label_selector((pod["metadata"].get("labels") or {}), label_selector)
            ]
            for key in doomed:
                del self._pods[key]
            return len(doomed)

    def delete_node(self, name: str) -> None:
        """Harness helper modeling a cluster-autoscaler scale-down: the
        Node object disappears and watchers get a DELETED event (GETs
        404, listings drop it) — exactly what a real apiserver serves
        when the autoscaler deletes a node mid-rollout."""
        with self._lock:
            node = self._nodes.pop(name, None)
            if node is None:
                return
            self._rv += 1
            node["metadata"]["resourceVersion"] = str(self._rv)
            self._record_event("DELETED", node)

    def add_patch_reactor(self, fn: Callable[[str, dict], None]) -> None:
        """fn(node_name, patched_node) runs (outside the lock) after each
        patch_node_labels call."""
        self._patch_reactors.append(fn)

    def inject_watch_fault(self, fault: Exception | WatchEvent) -> None:
        """Next watch_nodes call raises/yields this before streaming events."""
        self._watch_faults.append(fault)

    def compact(self) -> None:
        """Forget watch history: watches from older rvs now get 410 Gone."""
        with self._lock:
            self._compacted_before = self._rv + 1
            self._node_events.clear()

    def set_node_label(self, name: str, key: str, value: str | None) -> dict:
        """Out-of-band label write (e.g. 'the user edits the desired mode')."""
        return self.patch_node_labels(name, {key: value}, _count=False)

    # ---- KubeApi ---------------------------------------------------------

    def get_node(self, name: str) -> dict:
        self._count("get")
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise KubeApiError(404, f"node {name} not found")
            return copy.deepcopy(node)

    def patch_node_labels(
        self, name: str, labels: Mapping[str, str | None], _count: bool = True
    ) -> dict:
        if _count:
            self._count("patch")
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise KubeApiError(404, f"node {name} not found")
            if _count:
                self.patch_calls += 1
            current = node["metadata"].setdefault("labels", {})
            for k, v in labels.items():
                if v is None:
                    current.pop(k, None)
                else:
                    current[k] = str(v)
            self._rv += 1
            node["metadata"]["resourceVersion"] = str(self._rv)
            self._record_event("MODIFIED", node)
            snapshot = copy.deepcopy(node)
        for reactor in self._patch_reactors:
            reactor(name, snapshot)
        return snapshot

    def patch_node_annotations(
        self, name: str, annotations: Mapping[str, str | None]
    ) -> dict:
        self._count("patch")
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise KubeApiError(404, f"node {name} not found")
            current = node["metadata"].setdefault("annotations", {})
            for k, v in annotations.items():
                if v is None:
                    current.pop(k, None)
                else:
                    current[k] = str(v)
            self._rv += 1
            node["metadata"]["resourceVersion"] = str(self._rv)
            self._record_event("MODIFIED", node)
            return copy.deepcopy(node)

    def patch_node_taints(
        self, name: str, add: list[dict], remove_keys: list[str]
    ) -> dict:
        self._count("patch")
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise KubeApiError(404, f"node {name} not found")
            taints = list((node.get("spec") or {}).get("taints") or [])
            doomed = set(remove_keys) | {t.get("key") for t in add}
            taints = [t for t in taints if t.get("key") not in doomed]
            taints.extend(copy.deepcopy(dict(t)) for t in add)
            node.setdefault("spec", {})["taints"] = taints
            self._rv += 1
            node["metadata"]["resourceVersion"] = str(self._rv)
            self._record_event("MODIFIED", node)
            return copy.deepcopy(node)

    def list_nodes(self, label_selector: str | None = None) -> list[dict]:
        self._count("list")
        with self._lock:
            return [
                copy.deepcopy(n)
                for n in self._nodes.values()
                if _match_label_selector(n["metadata"].get("labels") or {}, label_selector)
            ]

    def list_nodes_page(
        self,
        label_selector: str | None = None,
        limit: int | None = None,
        continue_token: str | None = None,
    ) -> dict:
        """Chunked listing with real ``limit``/``continue`` semantics:
        the first page snapshots the name-sorted matching set and the
        token walks THAT snapshot (the real apiserver serves continues
        from the first page's etcd revision) — a label flip between pages
        cannot shift the sort and drop a neighbor from the listing. Every
        page reports the snapshot's resourceVersion so an informer can
        watch from the listing it built its cache from. An unknown or
        malformed token answers 410 Expired (client restarts the
        listing)."""
        self._count("list")
        with self._lock:
            if continue_token:
                snap = self._page_snapshots.get(continue_token)
                if snap is None:
                    raise KubeApiError(
                        410,
                        f"continue token {continue_token!r} expired",
                    )
                matching, rv, offset = (
                    snap[0], snap[1], int(continue_token.split(":")[-1])
                )
            else:
                matching = [
                    copy.deepcopy(n)
                    for _, n in sorted(self._nodes.items())
                    if _match_label_selector(
                        n["metadata"].get("labels") or {}, label_selector
                    )
                ]
                rv = str(self._rv)
                offset = 0
            end = offset + limit if limit else len(matching)
            items = [copy.deepcopy(n) for n in matching[offset:end]]
            meta: dict = {"resourceVersion": rv}
            if continue_token:
                del self._page_snapshots[continue_token]
            if end < len(matching):
                self._page_snapshot_seq += 1
                token = f"{self._page_snapshot_seq}:{end}"
                self._page_snapshots[token] = (matching, rv)
                meta["continue"] = token
                # Abandoned paginations must not pin snapshots forever.
                while len(self._page_snapshots) > 8:
                    oldest = next(iter(self._page_snapshots))
                    del self._page_snapshots[oldest]
            return {"kind": "NodeList", "items": items, "metadata": meta}

    def list_pods(
        self,
        namespace: str,
        label_selector: str | None = None,
        field_selector: str | None = None,
    ) -> list[dict]:
        self._count("list")
        with self._lock:
            self.list_pod_calls += 1
            return [
                copy.deepcopy(p)
                for (ns, _), p in self._pods.items()
                if ns == namespace
                and _match_label_selector(p["metadata"].get("labels") or {}, label_selector)
                and _match_pod_field_selector(p, field_selector)
            ]

    def create_event(self, namespace: str, event: dict) -> dict:
        self._count("create")
        with self._lock:
            self.events.append({"namespace": namespace, **copy.deepcopy(event)})
            return copy.deepcopy(event)

    # Lease verbs with honest optimistic concurrency: update_lease does a
    # real resourceVersion compare-and-swap (409 on mismatch), because the
    # rollout lease's fencing guarantee is only as strong as that CAS.

    def get_lease(self, namespace: str, name: str) -> dict:
        self._count("get")
        with self._lock:
            lease = self._leases.get((namespace, name))
            if lease is None:
                raise KubeApiError(404, f"lease {namespace}/{name} not found")
            return copy.deepcopy(lease)

    def create_lease(self, namespace: str, name: str, spec: dict) -> dict:
        self._count("create")
        with self._lock:
            if (namespace, name) in self._leases:
                raise KubeApiError(
                    409, f"lease {namespace}/{name} already exists"
                )
            self._rv += 1
            lease = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {
                    "name": name,
                    "namespace": namespace,
                    "resourceVersion": str(self._rv),
                },
                "spec": copy.deepcopy(dict(spec)),
            }
            self._leases[(namespace, name)] = lease
            return copy.deepcopy(lease)

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict:
        self._count("update")
        with self._lock:
            stored = self._leases.get((namespace, name))
            if stored is None:
                raise KubeApiError(404, f"lease {namespace}/{name} not found")
            sent_rv = (lease.get("metadata") or {}).get("resourceVersion")
            if str(sent_rv) != stored["metadata"]["resourceVersion"]:
                raise KubeApiError(
                    409,
                    f"lease {namespace}/{name}: resourceVersion conflict "
                    f"(sent {sent_rv}, stored "
                    f"{stored['metadata']['resourceVersion']})",
                )
            self._rv += 1
            updated = copy.deepcopy(lease)
            updated["metadata"]["resourceVersion"] = str(self._rv)
            updated["metadata"]["name"] = name
            updated["metadata"]["namespace"] = namespace
            self._leases[(namespace, name)] = updated
            return copy.deepcopy(updated)

    def delete_lease(self, namespace: str, name: str) -> None:
        self._count("delete")
        with self._lock:
            if self._leases.pop((namespace, name), None) is None:
                raise KubeApiError(404, f"lease {namespace}/{name} not found")

    def self_subject_access_review(
        self, verb: str, resource: str, namespace: str | None = None
    ) -> bool:
        """Grants everything unless the test narrows it via ``rbac_rules``
        (a dict of (verb, resource) -> bool set on the instance)."""
        rules = getattr(self, "rbac_rules", None)
        if rules is None:
            return True
        return bool(rules.get((verb, resource), False))

    def watch_nodes(
        self,
        name: str,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        self._count("watch")
        if self._watch_faults:
            fault = self._watch_faults.pop(0)
            if isinstance(fault, Exception):
                raise fault
            yield fault
            return
        start_rv = int(resource_version) if resource_version else 0
        with self._lock:
            if start_rv and start_rv < self._compacted_before - 1:
                raise KubeApiError(410, "resourceVersion too old")
        deadline = time.monotonic() + timeout_seconds
        cursor = start_rv
        while True:
            with self._lock:
                if cursor < getattr(self, "_dropped_below_rv", 0):
                    raise KubeApiError(
                        410, "watch history compacted past the cursor"
                    )
                pending = [
                    ev
                    for rv, ev in self._node_events
                    if rv > cursor and ev.object["metadata"]["name"] == name
                ]
                if pending:
                    cursor = max(
                        int(ev.object["metadata"]["resourceVersion"]) for ev in pending
                    )
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self._lock.wait(timeout=min(remaining, 0.05))
                    continue
            for ev in pending:
                yield copy.deepcopy(ev)

    def watch_nodes_pool(
        self,
        label_selector: str | None = None,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        """Selector-scoped pool watch with the real apiserver's view
        semantics: a node whose labels stop matching the selector is
        delivered as DELETED (the cache must drop it), one that starts
        matching arrives as its change event. ``in_view`` reconstructs
        which nodes the caller's listing (at ``resource_version``) could
        see, from the retained event log plus the nodes unchanged since."""
        self._count("watch")
        if self._watch_faults:
            fault = self._watch_faults.pop(0)
            if isinstance(fault, Exception):
                raise fault
            yield fault
            return
        start_rv = int(resource_version) if resource_version else 0
        in_view: set[str] = set()
        with self._lock:
            if start_rv and start_rv < self._compacted_before - 1:
                raise KubeApiError(410, "resourceVersion too old")
            for name, node in self._nodes.items():
                if int(node["metadata"]["resourceVersion"]) <= start_rv and (
                    _match_label_selector(
                        node["metadata"].get("labels") or {}, label_selector
                    )
                ):
                    in_view.add(name)
            for rv, ev in self._node_events:
                if rv > start_rv:
                    break
                name = ev.object["metadata"]["name"]
                if ev.type != "DELETED" and _match_label_selector(
                    ev.object["metadata"].get("labels") or {}, label_selector
                ):
                    in_view.add(name)
                else:
                    in_view.discard(name)
        deadline = time.monotonic() + timeout_seconds
        cursor = start_rv
        while True:
            with self._lock:
                if cursor < getattr(self, "_dropped_below_rv", 0):
                    raise KubeApiError(
                        410, "watch history compacted past the cursor"
                    )
                pending = [ev for rv, ev in self._node_events if rv > cursor]
                if pending:
                    cursor = max(
                        int(ev.object["metadata"]["resourceVersion"])
                        for ev in pending
                    )
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self._lock.wait(timeout=min(remaining, 0.05))
                    continue
            for ev in pending:
                name = ev.object["metadata"]["name"]
                matches = ev.type != "DELETED" and _match_label_selector(
                    ev.object["metadata"].get("labels") or {}, label_selector
                )
                if matches:
                    yield copy.deepcopy(
                        WatchEvent(
                            "ADDED" if name not in in_view else ev.type,
                            ev.object,
                        )
                    )
                    in_view.add(name)
                elif name in in_view:
                    in_view.discard(name)
                    yield copy.deepcopy(WatchEvent("DELETED", ev.object))

    # ---- internals -------------------------------------------------------

    def _record_event(self, etype: str, node: dict) -> None:
        # Caller holds the lock.
        self._node_events.append((self._rv, WatchEvent(etype, copy.deepcopy(node))))
        if len(self._node_events) > 4096:
            # Remember the newest DROPPED rv: a watcher whose cursor is
            # below it may have missed events, and (like a real apiserver
            # whose history was compacted out from under a slow watcher)
            # must get 410 Gone and relist — never a silent gap. Found
            # while scaling to 10k nodes, where a busy fleet can outrun a
            # momentarily-stalled watch reader.
            self._dropped_below_rv = max(
                getattr(self, "_dropped_below_rv", 0),
                self._node_events[2047][0],
            )
            del self._node_events[:2048]
        self._lock.notify_all()
