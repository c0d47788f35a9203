"""Drain and re-admit TPU operator components via the pause protocol.

Reference analogue: gpu_operator_eviction.py:98-259 (SURVEY.md §2 #8). The
shape is the same — read the component deploy labels, rewrite them to their
paused values in one node patch, poll until each component's pods are gone
from this node, and invert afterwards — with two deliberate changes:

- label writes are a merge-patch of metadata.labels only (not the reference's
  racy full-object read-modify-write, SURVEY.md §8.3);
- the timeout policy is explicit: ``proceed_on_timeout=True`` preserves the
  reference's "don't fail — continue anyway" behavior
  (gpu_operator_eviction.py:205-207) but callers can demand strictness.
"""

from __future__ import annotations

import logging
import time

from tpu_cc_manager_torch.drain import handshake
from tpu_cc_manager_torch.drain.pause import is_paused, pause_value, unpause_value
from tpu_cc_manager_torch.kubeclient.api import KubeApi, node_labels
from tpu_cc_manager_torch.labels import DRAIN_COMPONENT_LABELS
from tpu_cc_manager_torch.obs import trace as obs_trace
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

# Reference values: 300 s wait, 2 s poll (gpu_operator_eviction.py:136, :200).
DEFAULT_EVICTION_TIMEOUT_S = 300.0
DEFAULT_POLL_INTERVAL_S = 2.0

# Preemption fast-drain: the hard deadline a GCE spot/preemptible VM gets
# between the preemption notice and the kill — the whole drain (workload
# checkpoint handshake + component eviction) must fit inside it, which is
# why the fast path compresses rather than reuses the 300 s budget above.
DEFAULT_PREEMPTION_DEADLINE_S = 30.0
FAST_DRAIN_POLL_INTERVAL_S = 0.5
# Fraction of the deadline reserved for the workload checkpoint handshake
# (checkpoint-before-pause, benched at 0.55 s for the real llama job);
# the rest is the compressed pod-eviction wait.
FAST_DRAIN_ACK_FRACTION = 0.5
# Tail of the deadline the pod-eviction wait may NOT consume: the caller
# still has to publish the handoff record (and fence the slice) before
# the kill lands, and a wedged pod waiting out the whole window would
# cost exactly the publish that matters more than a clean drain.
FAST_DRAIN_PUBLISH_RESERVE_FRACTION = 0.15
FAST_DRAIN_PUBLISH_RESERVE_MAX_S = 5.0


class EvictionTimeout(Exception):
    """Raised (only when proceed_on_timeout=False) if pods outlive the wait.

    Carries the pre-drain label values so the caller can still re-admit
    the components it paused."""

    def __init__(self, msg: str, original: dict[str, str]):
        super().__init__(msg)
        self.original = original


def fetch_component_labels(api: KubeApi, node_name: str) -> dict[str, str]:
    """Current values of the drain-component labels on the node.

    Reference: fetch_current_component_labels (gpu_operator_eviction.py:98).
    Only labels actually present on the node are returned.
    """
    labels = node_labels(api.get_node(node_name))
    return {k: labels[k] for k in DRAIN_COMPONENT_LABELS if k in labels}


def evict_components(
    api: KubeApi,
    node_name: str,
    namespace: str,
    timeout_s: float = DEFAULT_EVICTION_TIMEOUT_S,
    poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
    proceed_on_timeout: bool = True,
    workload_ack_timeout_s: float = 0.0,
) -> dict[str, str]:
    """Pause every drainable component and wait for its pods to leave the node.

    When ``workload_ack_timeout_s`` > 0, the workload drain handshake runs
    FIRST: the drain request label goes up and registered training jobs get
    that long to checkpoint and ack before any component is paused
    (drain/handshake.py). The wait is bounded and lenient — a wedged job
    cannot veto a security transition — matching the reference's
    lenient-drain policy (gpu_operator_eviction.py:205-207).

    Returns the original label values (pass them to ``readmit_components``).
    Reference: evict_gpu_operator_components (gpu_operator_eviction.py:131-214).
    """
    cycle = None
    if workload_ack_timeout_s > 0:
        cycle = handshake.request_drain(api, node_name)
    try:
        return _evict_components_inner(
            api, node_name, namespace, timeout_s, poll_interval_s,
            proceed_on_timeout, workload_ack_timeout_s, cycle,
        )
    except Exception:
        # The drain-request label is up but this drain is being abandoned
        # (transport error mid-pause, strict eviction timeout, …): clear it
        # best-effort so subscribers don't stay parked until some later
        # reconcile happens to reach readmit_components.
        if cycle is not None:
            handshake.clear_drain_request(api, node_name)
        raise


def _evict_components_inner(
    api: KubeApi,
    node_name: str,
    namespace: str,
    timeout_s: float,
    poll_interval_s: float,
    proceed_on_timeout: bool,
    workload_ack_timeout_s: float,
    cycle,
) -> dict[str, str]:
    if cycle is not None and cycle.subscribers:
        # Its own span: the handshake is the part of the drain window a
        # slow-checkpointing training job owns, and the first question
        # after a blown budget is "handshake or pod eviction?".
        with obs_trace.span(
            "drain.handshake", node=node_name,
            subscribers=len(cycle.subscribers),
        ):
            handshake.await_workload_acks(
                api, node_name,
                timeout_s=workload_ack_timeout_s,
                poll_interval_s=poll_interval_s,
                token=cycle.token,
            )
    with obs_trace.span("drain.pause_components", node=node_name) as sp:
        original = fetch_component_labels(api, node_name)
        patch = {}
        for key, value in original.items():
            paused = pause_value(value)
            if paused is not None:
                patch[key] = paused
        sp.set_attribute("paused", sorted(patch))
        if patch:
            log.info("pausing components on %s: %s", node_name, sorted(patch))
            api.patch_node_labels(node_name, patch)
        else:
            log.info("no components to pause on %s", node_name)

    # Wait for the operator controller to delete each paused component's
    # pods. Components already paused by a previous (crashed) run must be
    # waited on too — their pods may still be terminating — hence "paused
    # now", not "paused by us".
    paused_now = sorted(
        key
        for key, value in {**original, **patch}.items()
        if is_paused(value)
    )
    if not paused_now:
        return original
    deadline = time.monotonic() + timeout_s
    with obs_trace.span(
        "drain.await_pods", node=node_name, components=len(paused_now)
    ) as sp:
        timed_out = []
        for key in paused_now:
            app = DRAIN_COMPONENT_LABELS[key]
            remaining = {"pods": 0}

            def component_gone(app=app, remaining=remaining) -> bool:
                pods = api.list_pods(
                    namespace,
                    label_selector=f"app={app}",
                    field_selector=f"spec.nodeName={node_name}",
                )
                remaining["pods"] = len(pods)
                return not pods

            # One shared deadline across all components (unchanged policy);
            # the per-component wait is whatever budget is left.
            if retry_mod.poll_until(
                component_gone,
                max(0.0, deadline - time.monotonic()),
                poll_interval_s,
            ):
                log.info("component %s drained from %s", app, node_name)
                continue
            msg = (
                f"timed out waiting for {remaining['pods']} pod(s) of "
                f"component {app} to leave node {node_name}"
            )
            if proceed_on_timeout:
                # Reference behavior: warn and continue to the hardware
                # phase anyway (gpu_operator_eviction.py:205-207).
                log.warning("%s — continuing anyway", msg)
                timed_out.append(app)
                continue
            raise EvictionTimeout(msg, original)
        if timed_out:
            sp.set_attribute("timed_out", timed_out)
    return original


def fast_drain_components(
    api: KubeApi,
    node_name: str,
    namespace: str,
    deadline_s: float = DEFAULT_PREEMPTION_DEADLINE_S,
    poll_interval_s: float = FAST_DRAIN_POLL_INTERVAL_S,
    workload_ack_timeout_s: float | None = None,
) -> dict[str, str]:
    """Preemption fast-drain: the SAME pause-label algebra as
    :func:`evict_components`, compressed into the platform's hard
    termination deadline.

    Ordering is the point: the workload checkpoint handshake runs FIRST
    (checkpoint-before-pause — the training job's unsaved state is the
    only thing on this node that cannot be recreated), then the
    components are paused and their pods waited on with whatever budget
    remains. The wait ALWAYS proceeds on timeout — the VM dies at the
    deadline whether or not eviction finished, and the caller still has
    the handoff record to publish.

    Deliberately never re-admits and never withdraws the drain-request
    label: this node is dying, and the replacement node's crash-recovery
    readmit (manager._readmit_leftover_paused) restores both from the
    labels the fast drain leaves behind. Returns the pre-drain label
    values like evict_components (callers that survive the notice — a
    cancelled preemption — can readmit with them)."""
    deadline = time.monotonic() + max(0.0, deadline_s)
    if workload_ack_timeout_s is None:
        workload_ack_timeout_s = deadline_s * FAST_DRAIN_ACK_FRACTION
    with obs_trace.span(
        "drain.fast", node=node_name, deadline_s=deadline_s,
    ) as sp:
        cycle = handshake.request_drain(
            api, node_name, deadline_s=deadline_s
        )
        if cycle.subscribers and workload_ack_timeout_s > 0:
            with obs_trace.span(
                "drain.handshake", node=node_name,
                subscribers=len(cycle.subscribers), fast=True,
            ):
                handshake.await_workload_acks(
                    api, node_name,
                    timeout_s=min(
                        workload_ack_timeout_s,
                        max(0.0, deadline - time.monotonic()),
                    ),
                    poll_interval_s=poll_interval_s,
                    token=cycle.token,
                )
        # The eviction wait stops short of the deadline: the tail is the
        # caller's handoff-publish (and slice-fence) window, which a
        # wedged pod must not be allowed to consume.
        publish_reserve_s = min(
            FAST_DRAIN_PUBLISH_RESERVE_MAX_S,
            deadline_s * FAST_DRAIN_PUBLISH_RESERVE_FRACTION,
        )
        original = _evict_components_inner(
            api, node_name, namespace,
            timeout_s=max(
                0.0, deadline - publish_reserve_s - time.monotonic()
            ),
            poll_interval_s=poll_interval_s,
            # The kill lands at the deadline regardless; failing here
            # would only cost the caller its handoff publish window.
            proceed_on_timeout=True,
            workload_ack_timeout_s=0.0,  # already awaited, compressed
            cycle=None,
        )
        sp.set_attribute(
            "seconds", round(deadline_s - (deadline - time.monotonic()), 3)
        )
        return original


def readmit_components(api: KubeApi, node_name: str, original: dict[str, str]) -> None:
    """Restore the pre-drain label values, unpausing what we paused.

    Reference: reschedule_gpu_operator_components
    (gpu_operator_eviction.py:217-259). Reads the node again and only
    unpauses labels that are still in a paused state, so a concurrent
    user edit (e.g. disabling a component mid-drain) wins.
    """
    with obs_trace.span("readmit.unpause", node=node_name):
        _readmit_components(api, node_name, original)


def _readmit_components(
    api: KubeApi, node_name: str, original: dict[str, str]
) -> None:
    labels = node_labels(api.get_node(node_name))
    current = {k: labels[k] for k in DRAIN_COMPONENT_LABELS if k in labels}
    patch: dict[str, str | None] = {}
    # Withdraw the drain request in the same patch, so subscribers watching
    # the label may resume as soon as components return — but only when one
    # was actually published (the handshake is off by default, and the
    # common path must not pay an extra write per reconcile).
    if handshake.DRAIN_REQUESTED_LABEL in labels:
        patch[handshake.DRAIN_REQUESTED_LABEL] = None
    # A fast drain publishes a deadline hint next to the request; when a
    # crash-recovery readmit (or a cancelled preemption) unwinds it, the
    # stale hint must not survive into the next normal drain cycle.
    if handshake.DRAIN_DEADLINE_LABEL in labels:
        patch[handshake.DRAIN_DEADLINE_LABEL] = None
    for key in DRAIN_COMPONENT_LABELS:
        restored = unpause_value(current.get(key))
        if restored is not None:
            # The unpaused current value is the truth. The remembered
            # original is only consulted when it is itself unpaused (it can
            # legitimately be a paused value after a crash-recovery run, and
            # writing that back would strand the component).
            remembered = original.get(key)
            patch[key] = (
                remembered
                if remembered is not None and not is_paused(remembered)
                else restored
            )
    components = sorted(k for k in patch if k != handshake.DRAIN_REQUESTED_LABEL)
    if components:
        log.info("unpausing components on %s: %s", node_name, components)
    else:
        log.info("no components to unpause on %s", node_name)
    if patch:
        api.patch_node_labels(node_name, patch)
