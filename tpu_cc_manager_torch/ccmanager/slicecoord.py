"""Slice-wide multi-host commit coordination.

The reference's PPCIe mode is fabric-atomic within one OS image: stage ALL
devices, then reset ALL together "so the NVLink fabric is configured
consistently" (reference main.py:362-368). A multi-host TPU slice spreads
that fabric across machines, so the stage-all/reset-all invariant needs a
cross-host barrier: **no host of an ICI slice may reset its runtime before
every host of the slice is staged and drained.**

The barrier runs over node labels — the same medium the rest of the control
plane uses for desired/actual state — so a crash at any point leaves labels
describing reality (SURVEY.md §7(c)):

- ``cloud.google.com/tpu-cc.slice.staged`` — published by each host after it
  has drained its components and staged the new mode on its chips. Value is
  the staged mode. Cleared when the host finishes (or aborts) the
  transition, so a lingering marker means "host is mid-transition".
- ``cloud.google.com/tpu-cc.slice.commit`` — published by the slice leader
  (``host_index == 0``) on its own node once it observes every host of the
  slice staged. Followers reset only after BOTH observing all hosts staged
  AND seeing the leader's commit marker. The leader clears the marker after
  the barrier completes (best-effort; a stale marker alone can never trigger
  a reset because followers always re-check full staging themselves).

Peer discovery uses the slice-membership label
(:data:`~tpu_cc_manager_torch.labels.SLICE_ID_LABEL`): each host publishes it at
barrier entry, and the barrier is complete when ``num_hosts`` nodes carry the
slice id with a matching staged marker. ``num_hosts`` comes from the device
topology, so a half-visible slice can never commit.

Failure semantics:

- Barrier timeout → :class:`BarrierTimeout` (a :class:`GpuError`): the
  reconcile fails, the host clears its own staged marker (it is about to
  re-admit components, so "staged and drained" is no longer true) and labels
  itself ``failed``. No hardware was touched.
- Crash mid-barrier → the staged marker stays behind; peers time out and
  fail soft. When the crashed host's agent restarts, the apply re-runs and
  re-publishes the marker (idempotent), and the barrier converges.
- Leader crash after publishing commit → followers that saw the marker
  reset (the fabric transition was already decided); the restarted leader's
  re-apply clears its stale marker at barrier entry and re-runs the
  protocol against its peers' already-committed state.

Dead-peer fencing (failure containment, ccmanager/remediation.py):

A host that dies mid-barrier used to cost every peer the full barrier
deadline. When a host is condemned — quarantined by the remediation
ladder, or watchdog-condemned — it (or the operator) bumps the slice's
**fencing generation** (``…slice.fence``, an integer label on the
condemned node). Every barrier round is entered at the generation current
at publish time, carried in ``…slice.staged-gen`` / ``…slice.commit-gen``:

- peers polling the barrier see a fence generation NEWER than their own
  round and abort immediately with :class:`BarrierFenced` — fail fast,
  well under the barrier deadline;
- a stale agent from a pre-fence round can neither complete the aborted
  barrier (its commit marker carries the old generation, which no
  current-round follower accepts, and its own next poll aborts) nor
  re-stage it (its old-generation staged marker never counts as ready
  for the new round). Re-entering the barrier afresh reads the CURRENT
  generation — a fresh round is always allowed.
"""

from __future__ import annotations

import logging

from tpu_cc_manager_torch.kubeclient.api import (
    KubeApi,
    KubeApiError,
    caller_retry_attempts,
    classify_kube_error,
    node_labels,
)
from tpu_cc_manager_torch import labels as labels_mod
from tpu_cc_manager_torch.labels import (
    CC_MODE_STATE_LABEL,
    SLICE_ID_LABEL,
    label_safe,
)
from tpu_cc_manager_torch.obs import trace as obs_trace
from tpu_cc_manager_torch.ccmanager.node import SliceView, GpuError
from tpu_cc_manager_torch.utils import metrics as metrics_mod
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

# Wire names centralized in labels.py (cclint surface contract);
# re-exported here so the barrier's public API is unchanged.
SLICE_STAGED_LABEL = labels_mod.SLICE_STAGED_LABEL
SLICE_COMMIT_LABEL = labels_mod.SLICE_COMMIT_LABEL
# Dead-peer fencing: the slice's current fencing generation (integer),
# bumped on the condemned node; rounds entered at an older generation
# abort fast and can neither complete nor re-stage.
SLICE_FENCE_LABEL = labels_mod.SLICE_FENCE_LABEL
# Which generation a host's staged / commit marker belongs to.
SLICE_STAGED_GEN_LABEL = labels_mod.SLICE_STAGED_GEN_LABEL
SLICE_COMMIT_GEN_LABEL = labels_mod.SLICE_COMMIT_GEN_LABEL

DEFAULT_BARRIER_TIMEOUT_S = 300.0
# How long the leader lingers after its own transition for peers to clear
# their staged markers before it retires the commit marker.
DEFAULT_COMPLETE_TIMEOUT_S = 60.0


class BarrierTimeout(GpuError):
    """The slice barrier did not form (or complete) in time."""


class BarrierFenced(GpuError):
    """The barrier round was aborted by a newer fencing generation (a peer
    was condemned mid-barrier); the caller fails fast instead of burning
    the barrier deadline."""


def _gen_of(labels: dict, key: str) -> int:
    """Integer generation from a label value (absent/garbled -> 0, so
    pre-fencing peers interoperate as generation 0)."""
    try:
        return int(labels.get(key) or 0)
    except (TypeError, ValueError):
        return 0


def fence_generation(nodes: list[dict]) -> int:
    """The slice's current fencing generation: the max fence label across
    its nodes (any node may carry it — normally the condemned one)."""
    return max(
        (_gen_of(node_labels(n), SLICE_FENCE_LABEL) for n in nodes),
        default=0,
    )


def fence_slice(
    api: KubeApi,
    node_name: str,
    slice_id: str,
    reason: str = "",
    metrics: "metrics_mod.MetricsRegistry | None" = None,
) -> int:
    """Abort any in-flight barrier round of ``slice_id`` by bumping the
    fencing generation on ``node_name`` (the condemned host — the caller
    holds patch RBAC on it). Also withdraws that host's own staged marker:
    a condemned host is by definition not "staged and drained". Returns
    the new generation. Raises KubeApiError on failure — the caller
    decides whether fencing is best-effort."""
    slice_value = label_safe(slice_id)
    nodes = api.list_nodes(f"{SLICE_ID_LABEL}={slice_value}")
    generation = fence_generation(nodes) + 1
    api.patch_node_labels(node_name, {
        # Peers discover the fence through the slice-membership listing, so
        # membership is (re)published with it — a host condemned before its
        # first successful reconcile must not carry an invisible fence.
        SLICE_ID_LABEL: slice_value,
        SLICE_FENCE_LABEL: str(generation),
        SLICE_STAGED_LABEL: None,
        SLICE_STAGED_GEN_LABEL: None,
    })
    (metrics if metrics is not None else metrics_mod.REGISTRY).record_barrier_fenced()
    log.warning(
        "slice %s FENCED at generation %d by %s%s: in-flight barrier "
        "rounds abort; peers fail fast",
        slice_id, generation, node_name, f" ({reason})" if reason else "",
    )
    return generation


def fence_departed_peer(
    api: KubeApi,
    node_name: str,
    slice_id: str,
    reason: str = "preempted",
    metrics: "metrics_mod.MetricsRegistry | None" = None,
) -> int | None:
    """Fence the slice on behalf of a host that is about to DEPART
    (platform preemption, autoscaler reclaim): its peers mid-barrier must
    abort fast with BarrierFenced instead of burning the barrier deadline
    waiting for a staged marker whose owner is being reclaimed. Unlike
    :func:`fence_slice`, failures are swallowed — the departing host is
    racing a hard kill deadline and a fencing hiccup must not consume the
    seconds the handoff publish still needs (peers then merely degrade to
    the old timeout behavior). Returns the new generation, or None."""
    try:
        return fence_slice(
            api, node_name, slice_id, reason=reason, metrics=metrics
        )
    except KubeApiError as e:
        log.warning(
            "could not fence slice %s for departing host %s (%s); peers "
            "fall back to the barrier timeout", slice_id, node_name, e,
        )
        return None


class SliceBarrier:
    """One host's participation in one slice-wide commit round."""

    def __init__(
        self,
        api: KubeApi,
        node_name: str,
        topo: SliceView,
        timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S,
        poll_interval_s: float = 1.0,
        complete_timeout_s: float = DEFAULT_COMPLETE_TIMEOUT_S,
        informer=None,
    ) -> None:
        self.api = api
        self.node_name = node_name
        self.topo = topo
        # Peer listing source (ccmanager/informer.py): with an informer
        # scoped to this slice's membership label, every barrier poll is
        # a local cache read — N hosts × barrier-deadline seconds of
        # 1/s peer listings stop hitting the apiserver. The informer's
        # slice index keys on the RAW label value, which is exactly
        # label_safe(slice_id) — the same value the membership label
        # carries.
        self.informer = informer
        self.timeout_s = timeout_s
        self.poll_interval_s = poll_interval_s
        self.complete_timeout_s = complete_timeout_s
        self.slice_label_value = label_safe(topo.slice_id)
        # The fencing generation this round was entered at (publish_staged
        # reads the slice's current generation). A newer generation
        # observed while waiting aborts the round with BarrierFenced.
        self.generation = 0
        # Transient-failure policy for the peer listing: short ladder (the
        # outer barrier deadline is authoritative) through the shared
        # jittered backoff instead of the old warn-and-poll-again. One
        # attempt when the client already retries internally (RestKube) —
        # exactly one ladder per logical call.
        self.retry_policy = retry_mod.RetryPolicy(
            max_attempts=caller_retry_attempts(api),
            base_delay_s=min(1.0, max(0.01, poll_interval_s)),
            max_delay_s=max(1.0, poll_interval_s * 4),
        )

    @property
    def is_leader(self) -> bool:
        return self.topo.host_index == 0

    # ------------------------------------------------------------------

    def publish_staged(self, mode: str) -> None:
        """Advertise "this host is drained and staged for ``mode``".

        Also publishes slice membership (peer discovery does not depend on a
        previous successful reconcile) and clears any commit marker this
        node owns from an earlier, possibly crashed, round.

        The round is entered at the slice's CURRENT fencing generation
        (read from the peers before publishing) and the staged marker is
        stamped with it — a marker left behind by a pre-fence round can
        never satisfy the current round's readiness count.
        """
        try:
            self.generation = fence_generation(self._slice_nodes())
        except KubeApiError as e:
            # Peer listing down at entry: enter at the last generation this
            # process saw (0 for a fresh barrier). Safe — a stale entry is
            # fenced out on the first successful poll.
            log.warning(
                "slice barrier: could not read fence generation (%s); "
                "entering at generation %d", e, self.generation,
            )
        self.api.patch_node_labels(
            self.node_name,
            {
                SLICE_ID_LABEL: self.slice_label_value,
                SLICE_STAGED_LABEL: mode,
                SLICE_STAGED_GEN_LABEL: str(self.generation),
                SLICE_COMMIT_LABEL: None,
                SLICE_COMMIT_GEN_LABEL: None,
            },
        )
        log.info(
            "slice %s host %d/%d: staged marker published (mode=%s gen=%d)",
            self.topo.slice_id, self.topo.host_index, self.topo.num_hosts,
            mode, self.generation,
        )

    def _slice_nodes(self) -> list[dict]:
        # Only a SYNCED cache may answer: an informer whose first listing
        # hasn't landed (start() returns after its sync wait even on
        # timeout) would silently report zero peers — publish_staged would
        # enter at fence generation 0 on a slice whose real generation is
        # higher, and every poll after sync would abort with a spurious
        # BarrierFenced. Unsynced degrades to the legacy listing path,
        # which raises on failure and lets callers keep last-known state.
        if self.informer is not None and self.informer.synced:
            return self.informer.slice_members(self.slice_label_value)
        return self.retry_policy.call(
            lambda: self.api.list_nodes(
                f"{SLICE_ID_LABEL}={self.slice_label_value}"
            ),
            op="barrier.list_peers",
            classify=classify_kube_error,
        )

    def await_commit(self, mode: str) -> None:
        """Block until this host may reset.

        A peer counts as *ready* when it is staged for ``mode`` — or when
        its actual-state label already reports ``mode``, i.e. it committed
        in an earlier round and this host is a recovering straggler (a crash
        mid-barrier must not wedge the slice: the survivors completed and
        cleared their staged markers, so staging alone could never re-form).

        Every host requires all ``num_hosts`` peers ready. The leader then
        publishes the commit marker and proceeds; followers additionally
        wait for a commit marker — the serialization point that stops a
        follower from resetting while a peer that briefly staged is already
        timing out and re-admitting its components. A follower whose peers
        have ALL already committed proceeds without a marker (the fabric
        transition was decided in the round it missed).
        """
        with obs_trace.span(
            "barrier.await_commit",
            slice=self.topo.slice_id,
            host_index=self.topo.host_index,
            num_hosts=self.topo.num_hosts,
            leader=self.is_leader,
        ):
            self._await_commit(mode)

    def _await_commit(self, mode: str) -> None:
        # Closure state across polls: the commit marker may be observed on
        # an earlier poll than the one where all hosts read ready, and the
        # timeout message reports the last observed readiness.
        state = {"committed_seen": False, "ready": None}

        def barrier_formed() -> bool:
            try:
                nodes = self._slice_nodes()
            except KubeApiError as e:
                # The retry policy already burned its short ladder; keep
                # polling — the barrier deadline is authoritative.
                log.warning("slice barrier: peer listing failed (%s); retrying", e)
                return False
            self._check_fence(nodes, mode)  # raises BarrierFenced
            ready, peers_committed = [], []
            for n in nodes:
                labels = node_labels(n)
                name = n["metadata"]["name"]
                already = labels.get(CC_MODE_STATE_LABEL) == mode
                staged_current = (
                    labels.get(SLICE_STAGED_LABEL) == mode
                    # A marker from a pre-fence round never counts: its
                    # host must re-enter at the current generation.
                    and _gen_of(labels, SLICE_STAGED_GEN_LABEL)
                    >= self.generation
                )
                if staged_current or already:
                    ready.append(name)
                if already and name != self.node_name:
                    peers_committed.append(name)
            state["ready"] = ready
            state["committed_seen"] = state["committed_seen"] or any(
                node_labels(n).get(SLICE_COMMIT_LABEL) == mode
                # A stale leader's pre-fence commit marker must not let a
                # current-round follower reset.
                and _gen_of(node_labels(n), SLICE_COMMIT_GEN_LABEL)
                >= self.generation
                for n in nodes
            )
            all_ready = len(ready) >= self.topo.num_hosts
            if all_ready and self.is_leader:
                self.api.patch_node_labels(
                    self.node_name,
                    {
                        SLICE_COMMIT_LABEL: mode,
                        SLICE_COMMIT_GEN_LABEL: str(self.generation),
                    },
                )
                log.info(
                    "slice %s: all %d host(s) ready; leader committing "
                    "mode=%s (gen=%d)",
                    self.topo.slice_id, self.topo.num_hosts, mode,
                    self.generation,
                )
                return True
            if all_ready and (
                state["committed_seen"]
                or len(peers_committed) >= self.topo.num_hosts - 1
            ):
                log.info(
                    "slice %s host %d: all ready (%s); committing mode=%s",
                    self.topo.slice_id, self.topo.host_index,
                    "leader marker" if state["committed_seen"]
                    else "peers already committed",
                    mode,
                )
                return True
            log.debug(
                "slice %s barrier: %d/%d ready, commit=%s",
                self.topo.slice_id, len(ready), self.topo.num_hosts,
                state["committed_seen"],
            )
            return False

        if not retry_mod.poll_until(
            barrier_formed, self.timeout_s, self.poll_interval_s
        ):
            ready = state["ready"]
            raise BarrierTimeout(
                f"slice {self.topo.slice_id}: barrier for mode {mode} did "
                f"not form within {self.timeout_s:.0f}s "
                f"({len(ready) if ready is not None else '?'}"
                f"/{self.topo.num_hosts} hosts ready)"
            )

    def _check_fence(self, nodes: list[dict], mode: str) -> None:
        """Raise BarrierFenced when the slice's fencing generation moved
        past this round's — a peer was condemned; fail fast."""
        current = fence_generation(nodes)
        if current > self.generation:
            raise BarrierFenced(
                f"slice {self.topo.slice_id}: barrier for mode {mode} "
                f"aborted — fencing generation advanced to {current} "
                f"(this round entered at {self.generation}); a peer was "
                "condemned mid-barrier"
            )

    def clear_staged(self) -> None:
        """Withdraw this host's staged marker (it is either done or about
        to re-admit components — either way no longer "staged and
        drained"). Best-effort."""
        try:
            self.api.patch_node_labels(self.node_name, {
                SLICE_STAGED_LABEL: None,
                SLICE_STAGED_GEN_LABEL: None,
            })
        except KubeApiError as e:
            log.warning("slice barrier: could not clear staged marker: %s", e)

    def abort(self) -> None:
        self.clear_staged()

    def complete(self, mode: str) -> None:
        """Retire the barrier. The caller runs this AFTER re-admitting
        components (manager.set_cc_mode), so the leader's bounded wait for
        peers never extends the drain window — it only delays the leader's
        own next watch iteration.

        The leader waits for every peer's staged marker to clear before
        retiring the commit marker: clearing it too early would strand
        followers still polling for it. A leftover marker is harmless —
        followers never act on a commit marker without re-verifying full
        staging — and is cleared at the next barrier entry.
        """
        self.clear_staged()  # idempotent; normally already cleared
        if not self.is_leader:
            return
        with obs_trace.span(
            "barrier.complete", slice=self.topo.slice_id, leader=True
        ):
            self._complete_as_leader(mode)

    def _complete_as_leader(self, mode: str) -> None:
        fenced = {"hit": False}

        def peers_cleared() -> bool:
            try:
                nodes = self._slice_nodes()
            except KubeApiError:
                return False
            if fence_generation(nodes) > self.generation:
                # This round was fenced: a stale leader must not keep
                # driving completion — retire its own (old-generation)
                # commit marker and get out of the new round's way.
                fenced["hit"] = True
                return True
            return not any(
                node_labels(n).get(SLICE_STAGED_LABEL) == mode for n in nodes
            )

        if not retry_mod.poll_until(
            peers_cleared, self.complete_timeout_s, self.poll_interval_s
        ):
            log.warning(
                "slice %s: peers still staged after %.0fs; leaving commit "
                "marker for the next round to clear",
                self.topo.slice_id, self.complete_timeout_s,
            )
            return
        if fenced["hit"]:
            log.warning(
                "slice %s: fencing generation advanced past this round "
                "(gen=%d); leader stops completing the aborted barrier",
                self.topo.slice_id, self.generation,
            )
        try:
            self.api.patch_node_labels(self.node_name, {
                SLICE_COMMIT_LABEL: None,
                SLICE_COMMIT_GEN_LABEL: None,
            })
        except KubeApiError as e:
            log.warning("slice barrier: could not clear commit marker: %s", e)
