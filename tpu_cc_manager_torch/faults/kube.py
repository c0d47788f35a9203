"""FaultyKubeClient: chaos in front of any KubeApi.

Wraps a real or fake client and consults a seeded
:class:`~tpu_cc_manager_torch.faults.plan.FaultPlan` before each call:

- unary verbs may be throttled (429 + Retry-After), 5xx'd, connection-
  reset, or slowed — all injected BEFORE the inner call runs, modeling a
  request that never reached (or never returned from) the apiserver;
- watch connects may 410 immediately (stale rv → resync path) or hang up
  after a bounded number of events (transport death mid-stream).

Being a plain KubeApi, it composes anywhere: under the manager's watch
loop, under the rolling orchestrator, under pool attestation — and the
retry totals in utils/metrics.py show exactly what the faults cost.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, Mapping

from tpu_cc_manager_torch.faults.plan import Fault, FaultPlan
from tpu_cc_manager_torch.kubeclient.api import KubeApi, KubeApiError, WatchEvent

log = logging.getLogger(__name__)


class FaultyKubeClient(KubeApi):
    def __init__(
        self,
        inner: KubeApi,
        plan: FaultPlan,
        sleep=time.sleep,
        # How many events a hung-up watch yields before dying (decided per
        # hangup from the plan's rng via randrange, so it stays seeded).
        watch_hangup_after: int = 2,
    ) -> None:
        self.inner = inner
        self.plan = plan
        self.sleep = sleep
        self.watch_hangup_after = watch_hangup_after
        # Transparent to retry layering: wrapping RestKube must not
        # re-enable the caller-side ladder caller_retry_attempts collapses
        # (nested 3x3 amplification), and wrapping a fake must not disable
        # it.
        self.retries_internally = getattr(inner, "retries_internally", False)

    # ---- fault application ----------------------------------------------

    def _maybe_fault(self, op: str) -> None:
        # Brownout weather first (gray failure: the call SUCCEEDS, just
        # late — intermittently, from the plan's derived brownout
        # stream). Checked before the main-stream decision so a slow
        # call can still also draw a fault; neither perturbs the other's
        # schedule.
        brown = self.plan.decide_brownout_slow(op)
        if brown > 0:
            log.info("chaos: brownout slows %s by %.3fs", op, brown)
            self.sleep(brown)
        fault = self.plan.decide(op)
        if fault is None:
            return
        log.info("chaos: injecting %s", fault.describe())
        self._raise_or_delay(fault)

    def _raise_or_delay(self, fault: Fault) -> None:
        if fault.kind == "slow":
            self.sleep(fault.slow_s or 0.0)
            return
        if fault.kind == "http-429":
            raise KubeApiError(
                429, f"chaos: {fault.describe()}",
                retry_after_s=fault.retry_after_s,
            )
        if fault.kind in ("http-5xx", "stale-rv"):
            raise KubeApiError(fault.status, f"chaos: {fault.describe()}")
        # conn-reset / watch-hangup: transport-level failure.
        raise KubeApiError(None, f"chaos: {fault.describe()}")

    # ---- KubeApi ---------------------------------------------------------

    def get_node(self, name: str) -> dict:
        self._maybe_fault("get_node")
        return self.inner.get_node(name)

    def patch_node_labels(self, name: str, labels: Mapping[str, str | None]) -> dict:
        self._maybe_fault("patch_node_labels")
        return self.inner.patch_node_labels(name, labels)

    def patch_node_annotations(
        self, name: str, annotations: Mapping[str, str | None]
    ) -> dict:
        self._maybe_fault("patch_node_annotations")
        return self.inner.patch_node_annotations(name, annotations)

    def patch_node_taints(
        self, name: str, add: list[dict], remove_keys: list[str]
    ) -> dict:
        self._maybe_fault("patch_node_taints")
        return self.inner.patch_node_taints(name, add, remove_keys)

    def delete_node(self, name: str) -> None:
        """Harness passthrough (FakeKube.delete_node): chaos scenarios
        modeling a cluster-autoscaler scale-down delete through the same
        faulted surface the rest of the scenario rides, so a deletion can
        itself be throttled/5xx'd like a real autoscaler's would be."""
        self._maybe_fault("delete_node")
        return self.inner.delete_node(name)

    def list_nodes(self, label_selector: str | None = None) -> list[dict]:
        self._maybe_fault("list_nodes")
        return self.inner.list_nodes(label_selector)

    def list_nodes_page(
        self,
        label_selector: str | None = None,
        limit: int | None = None,
        continue_token: str | None = None,
    ) -> dict:
        # Faulted under the same op as the unchunked listing: a chaos
        # schedule that throttles lists throttles every page of them.
        self._maybe_fault("list_nodes")
        return self.inner.list_nodes_page(label_selector, limit, continue_token)

    def list_pods(
        self,
        namespace: str,
        label_selector: str | None = None,
        field_selector: str | None = None,
    ) -> list[dict]:
        self._maybe_fault("list_pods")
        return self.inner.list_pods(namespace, label_selector, field_selector)

    def create_event(self, namespace: str, event: dict) -> dict:
        # Events are best-effort by contract; still fault them — a caller
        # that lets an event failure break a reconcile is a bug the soak
        # should catch.
        self._maybe_fault("create_event")
        return self.inner.create_event(namespace, event)

    def self_subject_access_review(
        self, verb: str, resource: str, namespace: str | None = None
    ) -> bool:
        self._maybe_fault("ssar")
        return self.inner.self_subject_access_review(verb, resource, namespace)

    # Lease verbs: faulted like any unary call, so the rollout lease's
    # acquire/renew/checkpoint paths prove themselves under throttling and
    # connection resets — a renew loop that dies on one 429 would silently
    # forfeit the lease mid-rollout.

    def get_lease(self, namespace: str, name: str) -> dict:
        self._maybe_fault("get_lease")
        return self.inner.get_lease(namespace, name)

    def create_lease(self, namespace: str, name: str, spec: dict) -> dict:
        self._maybe_fault("create_lease")
        return self.inner.create_lease(namespace, name, spec)

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict:
        self._maybe_fault("update_lease")
        return self.inner.update_lease(namespace, name, lease)

    def delete_lease(self, namespace: str, name: str) -> None:
        self._maybe_fault("delete_lease")
        return self.inner.delete_lease(namespace, name)

    def watch_nodes(
        self,
        name: str,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        return self._faulted_watch(
            self.inner.watch_nodes(name, resource_version, timeout_seconds)
        )

    def watch_nodes_pool(
        self,
        label_selector: str | None = None,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        # Same fault vocabulary as the single-node watch: the informer
        # cache's transport must prove itself against hangups, stale-rv
        # 410s and blackouts just like the agent's watch loop does.
        return self._faulted_watch(
            self.inner.watch_nodes_pool(
                label_selector, resource_version, timeout_seconds
            )
        )

    def _faulted_watch(self, stream: Iterator[WatchEvent]) -> Iterator[WatchEvent]:
        fault = self.plan.decide_watch()
        if fault is not None and fault.kind == "stale-rv":
            log.info("chaos: injecting %s", fault.describe())
            raise KubeApiError(410, f"chaos: {fault.describe()}")
        if fault is not None and fault.kind == "blackout":
            # Total outage: the watch connect is refused like every other
            # verb — no events leak through a dead apiserver.
            log.info("chaos: injecting %s", fault.describe())
            raise KubeApiError(None, f"chaos: {fault.describe()}")
        if fault is None:
            yield from stream
            return
        # watch-hangup: pass through a bounded number of events, then die
        # with a transport error (the stream the server closed mid-read).
        log.info("chaos: injecting %s", fault.describe())
        yielded = 0
        for event in stream:
            yield event
            yielded += 1
            if yielded >= self.watch_hangup_after:
                break
        raise KubeApiError(None, f"chaos: {fault.describe()} after {yielded} event(s)")
