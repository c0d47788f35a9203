"""Workload drain handshake: let live training jobs checkpoint before the
node's TPU runtime is bounced.

No reference counterpart (the reference's drain only pauses operator
components and waits for THEIR pods, gpu_operator_eviction.py:185-207; the
workloads a reset disrupts are invisible to its protocol). On TPUs the gap
bites harder: a CC transition restarts the runtime under every pod on the
host, so a live training job loses unsaved state unless it snapshots first
(BASELINE.json configs[3] — rolling reconfig under live ResNet-50 training).

Protocol, carried on node labels like everything else in this system:

1. A training job registers a subscriber label
   ``drain-subscriber.tpu-cc.gke.io/<job> = active`` on its node
   (:class:`DrainSubscriber`, typically from a sidecar thread).
2. The manager, before pausing components, sets
   ``cloud.google.com/tpu-cc.drain = requested-<cycle token>`` and resets
   every subscriber label to ``active`` in the same patch, then re-reads
   the subscriber set (so a job registering concurrently is still
   awaited).
3. The subscriber sees the request, runs its ``on_drain`` callback
   (checkpoint via :class:`~tpu_cc_manager_torch.parallel.checkpoint
   .TrainCheckpointer`), then flips its label to ``acked-<cycle token>``.
   Acks are cycle-scoped: an in-flight ack patch from a previous cycle
   carries the previous token and can never satisfy this cycle's wait.
4. The manager waits — bounded, CC_DRAIN_ACK_TIMEOUT_S — for every
   subscriber to ack, then proceeds with the normal component drain.
   Timeout proceeds with a warning (the reference's lenient-drain policy,
   SURVEY.md §8.5): a wedged job must not be able to veto a security
   transition forever.
5. After re-admission the drain request label is cleared; subscribers see
   that and may resume (restore + continue, or simply let the pod restart
   and restore on boot).
"""

from __future__ import annotations

import logging
import secrets
import threading
import time
from typing import Callable, NamedTuple

from tpu_cc_manager_torch.kubeclient.api import KubeApi, KubeApiError, node_labels
from tpu_cc_manager_torch import labels as labels_mod
from tpu_cc_manager_torch.labels import label_safe
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

# Wire names centralized in labels.py (cclint surface contract).
DRAIN_REQUESTED_LABEL = labels_mod.DRAIN_REQUESTED_LABEL
DRAIN_REQUESTED = "requested"  # value prefix: "requested-<cycle token>"
# Optional deadline hint published WITH a drain request (whole seconds):
# a preemption fast-drain carries its hard termination deadline here so a
# subscriber's checkpoint callback can choose a partial/incremental
# checkpoint that actually fits the window instead of starting a full one
# the kill will truncate. Absent on a normal (300 s budget) drain.
DRAIN_DEADLINE_LABEL = labels_mod.DRAIN_DEADLINE_LABEL
SUBSCRIBER_PREFIX = labels_mod.DRAIN_SUBSCRIBER_PREFIX
ACTIVE = "active"
ACKED = "acked"  # value prefix: "acked-<cycle token>"

DEFAULT_ACK_POLL_INTERVAL_S = 2.0
# When no drain is requested, subscribers poll this many times slower —
# fleet-wide the idle GET load is N jobs × poll rate, and the only thing an
# idle poll can discover is a new request, which tolerates seconds of lag
# (the manager's ack wait is bounded in tens of seconds).
IDLE_POLL_MULTIPLIER = 5


def new_cycle_token() -> str:
    """A fresh per-drain-cycle token (label-value-safe hex)."""
    return secrets.token_hex(4)


def request_value(token: str) -> str:
    """Drain-request label value carrying the cycle token."""
    return f"{DRAIN_REQUESTED}-{token}" if token else DRAIN_REQUESTED


def ack_value(token: str) -> str:
    """The only subscriber value that satisfies cycle ``token``'s wait.

    Cycle-scoped so an in-flight ack patch from the PREVIOUS cycle landing
    after this cycle's reset can never read as a fresh checkpoint (the r4
    stale-ack race): the old ack carries the old token.
    """
    return f"{ACKED}-{token}" if token else ACKED


def request_token(value: str | None) -> str | None:
    """Cycle token of a drain-request label value; None when no drain is
    requested. A bare legacy ``requested`` value maps to token ''; any
    other value that is not ``requested-<token>`` is NOT a drain request
    (a malformed value must not yield a garbage token that subscribers
    would checkpoint against)."""
    if value is None:
        return None
    if value == DRAIN_REQUESTED:
        return ""
    if value.startswith(DRAIN_REQUESTED + "-"):
        return value[len(DRAIN_REQUESTED) + 1:]
    return None


class DrainCycle(NamedTuple):
    """One published drain request: its token and the subscribers to await."""

    token: str
    subscribers: list[str]


def subscriber_label(job_name: str) -> str:
    return SUBSCRIBER_PREFIX + label_safe(job_name)


def subscriber_labels_of(labels: dict[str, str]) -> dict[str, str]:
    """The subscriber entries among a node's labels."""
    return {
        k: v for k, v in labels.items() if k.startswith(SUBSCRIBER_PREFIX)
    }


# ---------------------------------------------------------------------------
# Manager side
# ---------------------------------------------------------------------------


def request_drain(
    api: KubeApi, node_name: str, deadline_s: float | None = None
) -> DrainCycle:
    """Publish the drain request (with a fresh cycle token) and reset every
    known subscriber to ``active``, in one merge-patch.

    ``deadline_s`` (preemption fast-drain) additionally publishes the
    hard termination deadline as a whole-seconds label hint for
    subscribers; a normal drain clears any stale hint in the same patch.

    Returns the cycle token plus the subscriber keys that must ack it. The
    subscriber set is re-read AFTER the patch (the server's view), so a job
    registering between our read and our patch is still awaited — and the
    cycle token means a stale ack can never satisfy the wait regardless of
    when it lands.
    """
    token = new_cycle_token()
    subscribers = subscriber_labels_of(node_labels(api.get_node(node_name)))
    patch: dict[str, str | None] = {
        DRAIN_REQUESTED_LABEL: request_value(token),
        DRAIN_DEADLINE_LABEL: (
            str(max(1, int(round(deadline_s)))) if deadline_s else None
        ),
    }
    patch.update({k: ACTIVE for k in subscribers})
    api.patch_node_labels(node_name, patch)
    try:
        subscribers = subscriber_labels_of(
            node_labels(api.get_node(node_name))
        )
    except KubeApiError as e:
        # The request IS published; a transient re-read failure must not
        # abandon the cycle. Fall back to the pre-patch set.
        log.warning(
            "could not re-read subscribers on %s after drain request: %s",
            node_name, e,
        )
    if subscribers:
        log.info(
            "drain requested on %s (cycle %s); awaiting ack from %s",
            node_name, token, sorted(subscribers),
        )
    return DrainCycle(token, sorted(subscribers))


def await_workload_acks(
    api: KubeApi,
    node_name: str,
    timeout_s: float,
    poll_interval_s: float = DEFAULT_ACK_POLL_INTERVAL_S,
    token: str = "",
) -> list[str]:
    """Wait (bounded) until every subscriber label carries THIS cycle's ack.

    Returns the list of laggards (empty on full ack). Subscribers that
    unregister mid-wait (their pod finished) count as done.

    A bare legacy ``acked`` (pre-token subscriber, versioned with the
    training image rather than the manager DaemonSet) is accepted too so a
    manager upgrade doesn't turn every skewed job into a full-timeout
    laggard; only those subscribers keep the r4-size stale-ack window, and
    only until their image catches up."""
    expected = ack_value(token)
    state: dict = {"laggards": [], "legacy_warned": False}

    def all_acked() -> bool:
        labels = node_labels(api.get_node(node_name))
        subs = subscriber_labels_of(labels)
        if not state["legacy_warned"] and any(
            v == ACKED for v in subs.values()
        ):
            log.warning(
                "subscriber(s) %s acked with the pre-token value — "
                "upgrade their image for cycle-scoped acks",
                sorted(k for k, v in subs.items() if v == ACKED),
            )
            state["legacy_warned"] = True
        state["laggards"] = sorted(
            k for k, v in subs.items() if v not in (expected, ACKED)
        )
        return not state["laggards"]

    if retry_mod.poll_until(all_acked, timeout_s, poll_interval_s):
        return []
    log.warning(
        "drain ack timeout on %s: %s did not checkpoint in %.0fs — "
        "proceeding anyway", node_name, state["laggards"], timeout_s,
    )
    return state["laggards"]


def clear_drain_request(api: KubeApi, node_name: str) -> None:
    """Withdraw the drain request (after re-admission). Best-effort."""
    try:
        api.patch_node_labels(node_name, {
            DRAIN_REQUESTED_LABEL: None,
            DRAIN_DEADLINE_LABEL: None,
        })
    except KubeApiError as e:
        log.warning("could not clear drain request on %s: %s", node_name, e)


# ---------------------------------------------------------------------------
# Workload side
# ---------------------------------------------------------------------------


class DrainSubscriber:
    """The training job's side of the handshake.

    Run :meth:`start` from the job process (a daemon thread polls the node);
    ``on_drain`` is invoked — once per drain cycle — when the manager
    requests a drain, and must return only after the job's state is durably
    checkpointed. ``on_resume`` (optional) fires when the request clears.

        sub = DrainSubscriber(api, node, "llama-train", on_drain=ckpt.save_now)
        sub.start()
        ...
        sub.stop()      # unregisters
    """

    def __init__(
        self,
        api: KubeApi,
        node_name: str,
        job_name: str,
        on_drain: Callable[[], None],
        on_resume: Callable[[], None] | None = None,
        poll_interval_s: float = DEFAULT_ACK_POLL_INTERVAL_S,
        idle_poll_interval_s: float | None = None,
    ) -> None:
        self.api = api
        self.node_name = node_name
        self.label = subscriber_label(job_name)
        self.on_drain = on_drain
        self.on_resume = on_resume
        self.poll_interval_s = poll_interval_s
        # Idle polls only need to notice a NEW request, which tolerates
        # seconds of lag — back off so a fleet of subscribers doesn't hit
        # the apiserver at full drain-poll rate around the clock.
        self.idle_poll_interval_s = (
            idle_poll_interval_s
            if idle_poll_interval_s is not None
            else IDLE_POLL_MULTIPLIER * poll_interval_s
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._acked_token: str | None = None
        self._drain_requested = False
        # The deadline hint of the current drain cycle (None on a normal
        # drain): read before on_drain fires so a checkpoint callback can
        # size itself to a preemption fast-drain's hard window.
        self.drain_deadline_s: float | None = None

    def register(self) -> None:
        self.api.patch_node_labels(self.node_name, {self.label: ACTIVE})

    def unregister(self) -> None:
        try:
            self.api.patch_node_labels(self.node_name, {self.label: None})
        except KubeApiError as e:
            log.warning("could not unregister %s: %s", self.label, e)

    def check_once(self) -> bool:
        """One poll step; returns True if the current cycle is acked.

        The cycle is identified by the token in the drain-request label:
        ``_acked_token`` tracks which cycle OUR checkpoint served, so a new
        request (fresh token — e.g. after a crash-restart of the manager)
        re-runs the callback (checkpointing twice is safe; not
        checkpointing is not), while re-polling one cycle is idempotent.
        """
        labels = node_labels(self.api.get_node(self.node_name))
        token = request_token(labels.get(DRAIN_REQUESTED_LABEL))
        self._drain_requested = token is not None
        try:
            self.drain_deadline_s = (
                float(labels[DRAIN_DEADLINE_LABEL])
                if token is not None and DRAIN_DEADLINE_LABEL in labels
                else None
            )
        except (TypeError, ValueError):
            self.drain_deadline_s = None
        if token is None:
            if self._acked_token is not None:
                # Clear the cycle only AFTER on_resume succeeds: a failing
                # resume callback leaves _acked_token set, so the next poll
                # really does retry it (run()'s catch-all promises that).
                if self.on_resume is not None:
                    self.on_resume()
                self._acked_token = None
            return False
        if self._acked_token == token and labels.get(self.label) == ack_value(token):
            return True
        # Drain requested and we have not acked this cycle: checkpoint,
        # then ack with the cycle's token. A callback failure leaves us
        # un-acked — the manager's bounded wait will proceed without us and
        # the failure is loud here.
        self.on_drain()
        self.api.patch_node_labels(self.node_name, {self.label: ack_value(token)})
        self._acked_token = token
        log.info(
            "drain ack published for %s on %s (cycle %s)",
            self.label, self.node_name, token,
        )
        return True

    def run(self) -> None:
        self.register()
        try:
            while not self._stop.is_set():
                try:
                    self.check_once()
                except KubeApiError as e:
                    log.warning("drain subscriber poll failed: %s", e)
                except Exception:  # noqa: BLE001 - callback failures
                    # A failing on_drain (disk hiccup mid-checkpoint…) must
                    # not kill the subscriber thread: we stay registered and
                    # un-acked, and the next poll retries the checkpoint.
                    # (Un-acked is safe — the manager's bounded wait
                    # proceeds without us at worst.)
                    log.exception(
                        "drain callback failed; retrying next poll"
                    )
                self._stop.wait(
                    self.poll_interval_s
                    if self._drain_requested
                    else self.idle_poll_interval_s
                )
        finally:
            self.unregister()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, daemon=True, name=f"drain-sub-{self.label}"
        )
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
