"""Federated region-sharded rollouts: hierarchical lease fencing over
one global failure budget.

The single-process orchestrator (ccmanager/rolling.py) tops out at one
apiserver, one Lease, one process — ROADMAP item 1's standing ceiling.
This module composes two primitives the rollout already has —
the CAS-fenced rollout record and the stitched flight timeline — into a
two-level hierarchy that keeps the crash-anywhere / resume-exactly-once
guarantees when an entire *region* (orchestrator shard, apiserver, or
both) fails:

- **Regional shard**: one ordinary lease-fenced rollout per region
  (``RollingReconfigurator`` + ``RolloutLease``, unchanged semantics),
  against that region's own apiserver (or a region-label slice of one),
  checkpointing its regional slice of the plan into its regional lease.
  A shard SIGKILLed at any declared crash point resumes from its
  regional record exactly like today's ``--resume``.
- **Parent record**: ONE CAS document — the record annotation on a
  parent Lease object that nobody *holds* — carrying the global plan
  digest, the per-region status map, the single global failure budget /
  max-unavailable, the global ``budget_spend`` union, and a monotonic
  ``generation`` that fences force-aborted shards. Every shard
  read-modify-CAS-writes it at wave boundaries
  (:meth:`FederationGate.sync`); a 409 means another region wrote first,
  so the loser re-reads, re-merges and retries — budget spend is a
  node-name **set union**, so a CAS race between two shards charging the
  same window resolves to exactly-once by construction.

Fencing is hierarchical: a shard stops writing when (a) its regional
lease is lost (the existing ``FencedKube`` fence), (b) the parent
``generation`` has advanced past the one it attached at (a force-abort
bumped it — the wedged shard self-fences on its next sync), or (c) the
parent record is aborted. A regional apiserver blackout stalls only that
region's shard (its writes ride the shard's own retry ladder); the
parent's global spend keeps every other region's budget math honest in
the meantime.

Used by ``ctl rollout --regions``, ``hack/scale_bench.py --federation``
(SCALE_r03) and ``tests/test_federation.py``. Timeline stitching of the
per-region flight files stays in obs/flight.py (``stitch_files``) —
each shard writes its own JSONL shard, and
``ctl rollout-timeline --stitch`` reconstructs the one cross-region
exactly-once view.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

from tpu_cc_manager_torch.ccmanager import rollout_state
from tpu_cc_manager_torch.ccmanager.intent_journal import (
    OfflineTracker,
    is_outage_error,
)
from tpu_cc_manager_torch.kubeclient.api import (
    KubeApi,
    KubeApiError,
    caller_retry_attempts,
    classify_kube_error,
)
from tpu_cc_manager_torch.labels import label_safe
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

#: The parent record's Lease object (namespace = the rollout lease's).
#: Distinct from the regional rollout leases: nobody holds it, it is a
#: CAS document, and deleting it would reset the fencing generation.
PARENT_LEASE_NAME = "tpu-cc-rollout-parent"

#: Standard Kubernetes topology label used when regions are label slices
#: of one apiserver (``ctl rollout --regions r1,r2``).
REGION_LABEL = "topology.kubernetes.io/region"

#: Parent-document format version (independent of the regional
#: RolloutRecord's ``RECORD_VERSION`` — the parent is a new document,
#: not an evolution of the regional record). History:
#: 1: plan digest, per-region status map, one global budget,
#: ``budget_spend`` union, fencing ``generation``.
#: 2: adds ``escrow`` (per-region slices of the global budget reserved
#: for autonomous degraded-mode spending during a parent-plane
#: blackout), ``region_budgets`` and ``region_max_unavailable``
#: (heterogeneous per-region limits). Written ONLY when one of those
#: maps is populated, so budgetless/homogeneous federations keep
#: round-tripping through v1 binaries; an escrow-bearing parent resumed
#: by an escrow-unaware binary would silently drop the ledger and let
#: dark regions overspend, so v2 is refused loudly by older parsers.
PARENT_VERSION = 2
#: What parents WITHOUT the escrow/heterogeneous fields write.
PARENT_VERSION_NO_ESCROW = 1

PARENT_IN_PROGRESS = rollout_state.RECORD_IN_PROGRESS
PARENT_COMPLETE = rollout_state.RECORD_COMPLETE
PARENT_HALTED = rollout_state.RECORD_HALTED
PARENT_ABORTED = "aborted"
#: What :meth:`FederationGate.sync` reports as ``parent_status`` while
#: the parent apiserver is unreachable (transport-level failures only —
#: an apiserver that ANSWERS an error is not an outage).
PARENT_OFFLINE = "offline"

#: Degraded-mode halt reasons. ``escrow-exhausted`` is regional-only:
#: a dark shard that spent its escrowed slice stops itself without
#: halting the (unreachable) parent; siblings keep rolling. So is
#: ``region-failure-budget-exceeded`` (a heterogeneous per-region cap) —
#: only a GLOBAL budget breach halts the whole federation.
ESCROW_EXHAUSTED_REASON = "escrow-exhausted"
REGION_BUDGET_REASON = "region-failure-budget-exceeded"
_REGIONAL_ONLY_HALTS = (ESCROW_EXHAUSTED_REASON, REGION_BUDGET_REASON)

#: How long the parent plane must be dark (transport errors on every
#: sync) before a shard declares DEGRADED mode and journals the
#: parent-offline flight event. The escrow safety math applies from the
#: very first failed sync regardless — the grace only debounces the
#: operator-facing state flip, mirroring CC_OFFLINE_GRACE_S one level
#: down the hierarchy.
FEDERATION_OFFLINE_GRACE_ENV = "CC_FEDERATION_OFFLINE_GRACE_S"
DEFAULT_FEDERATION_OFFLINE_GRACE_S = 60.0


def federation_offline_grace_s() -> float:
    raw = os.environ.get(FEDERATION_OFFLINE_GRACE_ENV)
    if raw is None:
        return DEFAULT_FEDERATION_OFFLINE_GRACE_S
    try:
        return float(raw)
    except ValueError:
        log.warning(
            "%s=%r is not a number; using %.0f",
            FEDERATION_OFFLINE_GRACE_ENV, raw,
            DEFAULT_FEDERATION_OFFLINE_GRACE_S,
        )
        return DEFAULT_FEDERATION_OFFLINE_GRACE_S


class ParentUnreadable(rollout_state.RolloutFenced):
    """The parent record exists but cannot be parsed. Distinct from the
    version refusal so ``abort`` (the documented recovery) can discard a
    corrupt parent instead of tracebacking on it."""


#: A region registered at federation creation that has not synced yet.
#: Pre-seeding every region keeps ``all_complete`` honest (a parent is
#: complete only when EVERY declared region reports complete, not just
#: the ones that happened to sync) and gives every shard the true
#: region count at attach time.
PARENT_PENDING = "pending"

#: CAS retry ceiling for one parent write. Ten regions racing one wave
#: boundary serialize in at most N writes; the bound exists only to turn
#: a livelocked apiserver into an error instead of a hang.
_CAS_ATTEMPTS = 32


def regional_lease_name(region: str) -> str:
    """Per-region rollout lease name: regional shards must not contend
    on one Lease or the fence would serialize the federation."""
    return f"{rollout_state.LEASE_NAME}-{label_safe(region, max_len=40)}"


def regional_selector(selector: str, region: str) -> str:
    """The region slice of a pool selector when regions are label slices
    of one apiserver (the ctl ``--regions`` form)."""
    return f"{selector},{REGION_LABEL}={region}"


def plan_digest(mode: str, selector: str, regions: list[str]) -> str:
    """Digest of the federated plan identity. Shards attaching to the
    parent verify it so two operators racing different rollouts onto the
    same parent lease are refused instead of silently merged."""
    return hashlib.sha256(
        json.dumps(
            {"mode": mode, "selector": selector, "regions": sorted(regions)},
            sort_keys=True, separators=(",", ":"),
        ).encode()
    ).hexdigest()[:32]


@dataclass
class RegionSpec:
    """One region of a federated rollout: its name, its apiserver
    client, and its slice selector. ``lease_name`` defaults to the
    per-region rollout lease."""

    name: str
    api: KubeApi
    selector: str
    lease_name: str = ""

    def __post_init__(self) -> None:
        if not self.lease_name:
            self.lease_name = regional_lease_name(self.name)


@dataclass
class ParentRecord:
    """The one global document of a federated rollout (JSON in the
    parent Lease's record annotation). ``budget_spend`` is the global
    union of every region's charged node names; ``generation`` is the
    parent fencing token (bumped by force-abort so wedged shards
    self-fence); ``regions`` maps region name -> its last-synced
    status/progress."""

    mode: str
    selector: str
    digest: str
    max_unavailable: int
    failure_budget: int | None
    generation: int = 1
    budget_spend: list[str] = field(default_factory=list)
    regions: dict[str, dict] = field(default_factory=dict)
    status: str = PARENT_IN_PROGRESS
    halted_reason: str | None = None
    # Budget escrow (format v2): per-region slices of the global budget
    # reserved for degraded-mode spending while the parent plane is
    # dark. Invariant: len(budget_spend) + sum(escrow.values()) <=
    # failure_budget — a dark region charging only against its slice can
    # never push the federation over the global budget.
    escrow: dict[str, int] = field(default_factory=dict)
    # Heterogeneous per-region limits (format v2): a region absent from
    # either map falls back to the global value.
    region_budgets: dict[str, int] = field(default_factory=dict)
    region_max_unavailable: dict[str, int] = field(default_factory=dict)

    @classmethod
    def fresh(
        cls,
        mode: str,
        selector: str,
        regions: list[str],
        max_unavailable: int = 1,
        failure_budget: int | None = None,
        region_budgets: dict[str, int] | None = None,
        region_max_unavailable: dict[str, int] | None = None,
    ) -> "ParentRecord":
        """A new federation's parent document with every region
        pre-registered as pending — the digest and the region count are
        fixed at creation, before any shard's first sync."""
        rec = cls(
            mode=mode, selector=selector,
            digest=plan_digest(mode, selector, list(regions)),
            max_unavailable=max_unavailable, failure_budget=failure_budget,
            region_budgets=dict(region_budgets or {}),
            region_max_unavailable=dict(region_max_unavailable or {}),
        )
        for region in regions:
            rec.regions[str(region)] = {
                "status": PARENT_PENDING, "done": 0, "total": 0,
                "generation": None,
            }
        return rec

    def charge_budget(self, nodes) -> None:
        self.budget_spend = sorted(set(self.budget_spend) | set(nodes))

    def note_region(
        self, region: str, status: str, done: int, total: int,
        generation: int | None = None,
        charged: list[str] | None = None,
        synced_at: float | None = None,
    ) -> None:
        entry = {
            "status": status,
            "done": int(done),
            "total": int(total),
            "generation": generation,
        }
        if charged is not None:
            # Per-region spend attribution: the subset of budget_spend
            # this region itself charged (set-union, exactly-once under
            # CAS races like the global ledger). Only maintained when a
            # budget exists — it is what heterogeneous caps and escrow
            # re-reservation are computed from.
            entry["charged"] = sorted(set(charged))
        if synced_at is not None:
            # Display-only wall stamp for `ctl status` last-sync age;
            # NEVER consulted by fencing (fencing is wall-clock-free:
            # generation tokens and monotonic local clocks only).
            entry["synced_at"] = round(float(synced_at), 3)
        self.regions[region] = entry

    @property
    def all_complete(self) -> bool:
        return bool(self.regions) and all(
            r.get("status") == PARENT_COMPLETE for r in self.regions.values()
        )

    def region_charged(self, region: str) -> set[str]:
        """The spend this region itself charged (its slice of the global
        union), per the persisted per-region attribution."""
        return set((self.regions.get(region) or {}).get("charged") or [])

    def to_json(self) -> str:
        # Serialize at the LOWEST version that expresses the populated
        # fields (the regional record's downgrade-compat discipline): a
        # budgetless/homogeneous federation stays v1 so older binaries
        # keep adopting it; any escrow or per-region limit forces v2 and
        # a loud refusal from escrow-unaware parsers.
        versioned = bool(
            self.escrow or self.region_budgets or self.region_max_unavailable
        )
        body = {
            "parentVersion": (
                PARENT_VERSION if versioned else PARENT_VERSION_NO_ESCROW
            ),
            "mode": self.mode,
            "selector": self.selector,
            "digest": self.digest,
            "max_unavailable": self.max_unavailable,
            "failure_budget": self.failure_budget,
            "generation": self.generation,
            "budget_spend": list(self.budget_spend),
            "regions": self.regions,
            "status": self.status,
            "halted_reason": self.halted_reason,
        }
        if versioned:
            body["escrow"] = {k: int(v) for k, v in self.escrow.items()}
            if self.region_budgets:
                body["region_budgets"] = {
                    k: int(v) for k, v in self.region_budgets.items()
                }
            if self.region_max_unavailable:
                body["region_max_unavailable"] = {
                    k: int(v) for k, v in self.region_max_unavailable.items()
                }
        return json.dumps(body, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, data: str) -> "ParentRecord":
        try:
            obj = json.loads(data)
            version = int(obj.get("parentVersion") or 1)
            if version > PARENT_VERSION:
                raise rollout_state.RolloutFenced(
                    f"federated parent record v{version} is newer than this "
                    f"orchestrator understands (max v{PARENT_VERSION}); "
                    "upgrade, or abort the federation to discard"
                )
            return cls(
                mode=str(obj["mode"]),
                selector=str(obj["selector"]),
                digest=str(obj["digest"]),
                max_unavailable=int(obj.get("max_unavailable") or 1),
                failure_budget=(
                    int(obj["failure_budget"])
                    if obj.get("failure_budget") is not None else None
                ),
                generation=int(obj.get("generation") or 1),
                budget_spend=[str(n) for n in obj.get("budget_spend") or []],
                regions={
                    str(k): dict(v)
                    for k, v in (obj.get("regions") or {}).items()
                },
                status=str(obj.get("status") or PARENT_IN_PROGRESS),
                halted_reason=(
                    str(obj["halted_reason"])
                    if obj.get("halted_reason") else None
                ),
                escrow={
                    str(k): int(v)
                    for k, v in (obj.get("escrow") or {}).items()
                },
                region_budgets={
                    str(k): int(v)
                    for k, v in (obj.get("region_budgets") or {}).items()
                },
                region_max_unavailable={
                    str(k): int(v)
                    for k, v in (obj.get("region_max_unavailable") or {}).items()
                },
            )
        except rollout_state.RolloutFenced:
            raise
        except (ValueError, KeyError, TypeError) as e:
            raise ParentUnreadable(
                f"unreadable federated parent record: {e}"
            ) from e


class ParentStore:
    """The parent record's CAS home: a Lease object nobody holds, on the
    designated parent apiserver. Chosen over a ConfigMap because every
    client in the repo (FakeKube, RestKube, the mock apiserver) already
    speaks honest resourceVersion CAS for Leases — the same primitive
    the regional fence rests on.

    Thread- and process-safe by construction: every mutation goes
    through :meth:`update`'s read-mutate-CAS-write loop, so concurrent
    shards serialize on the apiserver's resourceVersion, never on local
    locks."""

    def __init__(
        self,
        api: KubeApi,
        namespace: str | None = None,
        name: str = PARENT_LEASE_NAME,
        retry_policy: retry_mod.RetryPolicy | None = None,
    ) -> None:
        self.api = api
        self.namespace = namespace or rollout_state.lease_namespace()
        self.name = name
        # Every parent read/write rides the shared retry ladder like any
        # other client path: Retry-After honored, transients re-tried,
        # and attempts collapsed to 1 when the client retries internally
        # (RestKube) so ladders never nest. A 409 is classified
        # non-transient, so CAS conflicts still surface to the
        # read-mutate-write loops below instead of being blindly
        # replayed against a stale resourceVersion.
        self.retry = retry_policy or retry_mod.RetryPolicy(
            max_attempts=caller_retry_attempts(self.api),
            base_delay_s=0.2, max_delay_s=2.0,
        )

    def _get_lease(self) -> dict:
        return self.retry.call(
            lambda: self.api.get_lease(self.namespace, self.name),
            op="federation.parent-get", classify=classify_kube_error,
        )

    def _put_lease(self, lease: dict) -> dict:
        return self.retry.call(
            lambda: self.api.update_lease(self.namespace, self.name, lease),
            op="federation.parent-cas", classify=classify_kube_error,
        )

    def load(self) -> ParentRecord | None:
        """The current parent record, or None when no federation is in
        flight (no lease, or a lease with no record annotation)."""
        try:
            lease = self._get_lease()
        except KubeApiError as e:
            if e.status == 404:
                return None
            raise
        raw = ((lease.get("metadata") or {}).get("annotations") or {}).get(
            rollout_state.RECORD_ANNOTATION
        )
        return ParentRecord.from_json(raw) if raw else None

    def initialize(self, parent: ParentRecord, resume: bool) -> ParentRecord:
        """Create the parent document, or adopt the existing one.

        A fresh federation refuses an in-progress parent with a
        DIFFERENT plan digest (two operators racing different rollouts);
        a matching in-progress parent is adopted (another shard of the
        same federation got here first — the normal N-shard startup
        race). ``resume`` additionally demands an existing parent."""
        existing = self.load()
        if existing is not None:
            if existing.status in (PARENT_IN_PROGRESS, PARENT_HALTED):
                if existing.digest != parent.digest:
                    raise rollout_state.RolloutFenced(
                        "a different federated rollout is already in "
                        f"flight (digest {existing.digest} != "
                        f"{parent.digest}); abort it first"
                    )
                if existing.status == PARENT_HALTED and resume:
                    # A resumed federation brings a halted parent back to
                    # life exactly like a regional --resume restamps its
                    # record in-progress.
                    return self.update(self._revive)
                return existing
            if resume:
                raise rollout_state.RolloutFenced(
                    f"federated parent record is {existing.status}; "
                    "nothing to resume"
                )
        elif resume:
            raise rollout_state.RolloutFenced(
                "no federated parent record to resume"
            )
        return self._create(parent)

    @staticmethod
    def _revive(rec: ParentRecord) -> ParentRecord:
        rec.status = PARENT_IN_PROGRESS
        rec.halted_reason = None
        return rec

    def _create(self, parent: ParentRecord) -> ParentRecord:
        for _ in range(_CAS_ATTEMPTS):
            try:
                lease = self._get_lease()
            except KubeApiError as e:
                if e.status != 404:
                    raise
                try:
                    self.retry.call(
                        lambda: self.api.create_lease(
                            self.namespace, self.name, {"holderIdentity": ""}
                        ),
                        op="federation.parent-create",
                        classify=classify_kube_error,
                    )
                except KubeApiError as ce:
                    if ce.status != 409:
                        raise
                continue
            meta = lease.setdefault("metadata", {})
            annotations = meta.setdefault("annotations", {})
            prior = annotations.get(rollout_state.RECORD_ANNOTATION)
            if prior:
                # Someone wrote a record between load() and here: fall
                # back to adoption semantics via a fresh initialize.
                return self.initialize(parent, resume=False)
            annotations[rollout_state.RECORD_ANNOTATION] = parent.to_json()
            try:
                self._put_lease(lease)
                return parent
            except KubeApiError as e:
                if e.status != 409:
                    raise
        raise KubeApiError(
            None,
            f"parent lease {self.namespace}/{self.name}: create kept "
            "conflicting",
        )

    def update(self, mutate) -> ParentRecord:
        """Read-mutate-CAS-write the parent record. ``mutate`` receives
        the freshly read :class:`ParentRecord` and returns the record to
        persist (usually the same object, merged); it runs again on
        every 409, against the NEW read — set-union merges make the
        retried write idempotent, which is what turns a two-shard CAS
        race into an exactly-once budget charge. ``mutate`` may raise
        ``RolloutFenced`` to refuse (stale shard); that propagates."""
        last: KubeApiError | None = None
        for _ in range(_CAS_ATTEMPTS):
            lease = self._get_lease()
            raw = ((lease.get("metadata") or {}).get("annotations") or {}).get(
                rollout_state.RECORD_ANNOTATION
            )
            if not raw:
                raise rollout_state.RolloutFenced(
                    f"federated parent record vanished from "
                    f"{self.namespace}/{self.name} (aborted and discarded?)"
                )
            rec = mutate(ParentRecord.from_json(raw))
            lease.setdefault("metadata", {}).setdefault("annotations", {})[
                rollout_state.RECORD_ANNOTATION
            ] = rec.to_json()
            try:
                self._put_lease(lease)
                return rec
            except KubeApiError as e:
                if e.status != 409:
                    raise
                last = e
        raise KubeApiError(
            None,
            f"parent lease {self.namespace}/{self.name}: CAS kept "
            f"conflicting after {_CAS_ATTEMPTS} attempts ({last})",
        )

    def abort(self, reason: str = "operator-abort") -> ParentRecord:
        """Force-abort the federation: mark the parent aborted AND bump
        its generation. Every live shard's next sync sees a generation
        newer than the one it attached at and fences itself — the
        federated analogue of ``release_lease``'s self-fencing force
        release. A CORRUPT parent (unparseable annotation) is replaced
        by a synthetic aborted tombstone instead of tracebacking:
        ``abort`` is the documented recovery for exactly that state, and
        any shard still attached fences on the tombstone's aborted
        status at its next sync."""

        def _abort(rec: ParentRecord) -> ParentRecord:
            rec.status = PARENT_ABORTED
            rec.halted_reason = reason
            rec.generation += 1
            return rec

        try:
            return self.update(_abort)
        except ParentUnreadable as e:
            log.warning(
                "parent record %s/%s is unreadable (%s); replacing with "
                "an aborted tombstone", self.namespace, self.name, e,
            )
            return self._entomb(reason)

    def _entomb(self, reason: str) -> ParentRecord:
        """CAS-overwrite an unparseable parent annotation with a minimal
        aborted record. The aborted STATUS (checked before anything else
        a shard could trust from a corrupt document) is the operative
        fence here, not the generation."""
        tomb = ParentRecord(
            mode="?", selector="?", digest="discarded-corrupt",
            max_unavailable=1, failure_budget=None,
            status=PARENT_ABORTED,
            halted_reason=f"{reason} (previous record unreadable)",
        )
        for _ in range(_CAS_ATTEMPTS):
            lease = self._get_lease()
            lease.setdefault("metadata", {}).setdefault("annotations", {})[
                rollout_state.RECORD_ANNOTATION
            ] = tomb.to_json()
            try:
                self._put_lease(lease)
                return tomb
            except KubeApiError as e:
                if e.status != 409:
                    raise
        raise KubeApiError(
            None,
            f"parent lease {self.namespace}/{self.name}: tombstone write "
            "kept conflicting",
        )


class FederationGate:
    """One regional shard's handle on the parent record.

    Constructed per shard, attached once (capturing the parent
    generation as this shard's fence token), then passed to
    ``RollingReconfigurator(federation=...)`` which calls :meth:`sync`
    at every wave boundary inside the ``federation-boundary`` crash
    point. ``sync`` pushes this region's spend/status up, folds the
    global spend down, and raises ``RolloutFenced`` the moment the
    parent fences this shard out."""

    def __init__(
        self,
        store: ParentStore,
        region: str,
        metrics=None,
        offline_grace_s: float | None = None,
        clock=time.monotonic,
        wall=time.time,
    ) -> None:
        self.store = store
        self.region = region
        self.metrics = metrics
        self.generation: int | None = None
        self.digest: str | None = None
        self.regions_total: int = 0
        #: Heterogeneous per-region cap (None = global budget only).
        self.region_budget: int | None = None
        #: This shard's escrowed slice of the global budget — what it may
        #: charge autonomously while the parent plane is dark. None when
        #: the federation has no budget at all (nothing to escrow).
        self.escrow_balance: int | None = None
        #: The global spend union at the last SUCCESSFUL sync: anything
        #: in the local record beyond this is dark spend still pending
        #: reconciliation, charged against the escrow balance.
        self.acked_spend: set[str] = set()
        #: Cumulative spend this region itself charged (mirrors the
        #: parent's per-region attribution).
        self.charged: set[str] = set()
        self.wall = wall
        self.offline = OfflineTracker(
            grace_s=(
                offline_grace_s if offline_grace_s is not None
                else federation_offline_grace_s()
            ),
            clock=clock,
        )
        self._was_engaged = False

    def attach(self, parent: ParentRecord) -> None:
        """Adopt the parent's coordinates as this shard's fence token,
        and CAS-reserve this region's attach-time escrow slice. A parent
        plane already dark at attach leaves a provisional slice computed
        from the last-seen snapshot (still bounded by the invariant —
        the reservation lands on the first successful sync)."""
        self.generation = parent.generation
        self.digest = parent.digest
        self.regions_total = max(len(parent.regions), 1)
        self.region_budget = parent.region_budgets.get(self.region)
        self.acked_spend = set(parent.budget_spend)
        self.charged = parent.region_charged(self.region)
        if parent.failure_budget is None:
            self.escrow_balance = None
            return
        try:
            live = self.store.update(self._reserve_only)
        except KubeApiError as e:
            if not is_outage_error(e):
                raise
            self.offline.note_failure()
            self.escrow_balance = self._escrow_target(
                parent, self.charged, terminal=False
            )
            log.warning(
                "region %s: parent plane dark at attach; provisional "
                "escrow slice %s", self.region, self.escrow_balance,
            )
            return
        self.offline.note_success()
        self.escrow_balance = live.escrow.get(self.region, 0)
        self.acked_spend = set(live.budget_spend)
        self.charged = live.region_charged(self.region)

    def _reserve_only(self, rec: ParentRecord) -> ParentRecord:
        """Mutator for the attach-time reservation: fence checks plus
        the escrow slice, no status/progress merge."""
        self._guard(rec)
        target = self._escrow_target(
            rec, rec.region_charged(self.region) | self.charged,
            terminal=False,
        )
        if target is not None:
            rec.escrow[self.region] = target
        return rec

    def _escrow_target(
        self, rec: ParentRecord, charged: set[str], terminal: bool
    ) -> int | None:
        """How much of the global budget this region should hold in
        escrow right now. None when there is no budget (nothing to
        bound); 0 for terminal regions (unused escrow returned). The
        slice is the region's remaining heterogeneous allowance when one
        is set, else a fair ceil-share of the remaining global budget —
        always capped so len(budget_spend) + sum(escrow) never exceeds
        failure_budget."""
        if rec.failure_budget is None:
            return None
        if terminal:
            return 0
        others = sum(
            v for r, v in rec.escrow.items() if r != self.region
        )
        spend = len(rec.budget_spend)
        free = max(0, rec.failure_budget - spend - others)
        rb = rec.region_budgets.get(self.region)
        if rb is not None:
            want = max(0, rb - len(charged))
        else:
            remaining = max(0, rec.failure_budget - spend)
            want = -(-remaining // max(len(rec.regions) or 1, 1))
        return min(want, free)

    def _guard(self, rec: ParentRecord) -> None:
        """The hierarchical fence checks every parent write runs behind:
        generation advance (force-abort), aborted status, and plan
        digest (an abort-and-recreate during a blackout must fence the
        stale shard even if the new plan reset the generation)."""
        if rec.generation > self.generation:
            self._count("fenced")
            if self.metrics is not None:
                self.metrics.record_federation_fence("parent-generation")
            raise rollout_state.RolloutFenced(
                f"region {self.region}: parent generation "
                f"{rec.generation} > attached {self.generation} "
                "(force-aborted; this shard is fenced)"
            )
        if rec.status == PARENT_ABORTED:
            self._count("fenced")
            if self.metrics is not None:
                self.metrics.record_federation_fence("parent-aborted")
            raise rollout_state.RolloutFenced(
                f"region {self.region}: federated rollout aborted "
                f"({rec.halted_reason or 'no reason recorded'})"
            )
        if self.digest and rec.digest != self.digest:
            self._count("fenced")
            if self.metrics is not None:
                self.metrics.record_federation_fence("parent-digest")
            raise rollout_state.RolloutFenced(
                f"region {self.region}: parent record belongs to a "
                f"different rollout (digest {rec.digest} != attached "
                f"{self.digest})"
            )

    def to_record_dict(self) -> dict:
        """What the regional RolloutRecord persists so a crash +
        ``--resume`` successor can reconnect to the parent. With a
        budget in play this carries the escrow ledger (balance, acked
        spend, attribution — format v6): a successor resuming WHILE the
        parent is still dark must know exactly how much it may keep
        charging."""
        d = {
            "region": self.region,
            "regions": self.regions_total,
            "parent_namespace": self.store.namespace,
            "parent_name": self.store.name,
            "generation": self.generation,
            "digest": self.digest,
        }
        if self.escrow_balance is not None:
            d["escrow"] = int(self.escrow_balance)
            d["acked_spend"] = sorted(self.acked_spend)
            d["charged"] = sorted(self.charged)
            if self.region_budget is not None:
                d["region_budget"] = int(self.region_budget)
        return d

    @classmethod
    def from_record_dict(
        cls, api: KubeApi, fed: dict, metrics=None,
        offline_grace_s: float | None = None, clock=time.monotonic,
    ) -> "FederationGate":
        """Rebuild a shard's gate from its regional record's persisted
        ``federation`` field (the --resume path). The fence token is
        re-read from the LIVE parent — a resume is a new attachment, not
        a replay of the dead shard's token — but the digest must match:
        a parent that was aborted and recreated for a different plan
        must refuse the stale regional record.

        When the parent plane is DARK (transport error) and the record
        carries the escrow ledger, the gate resumes degraded from the
        persisted ledger instead of refusing: a mid-blackout SIGKILL
        must not wedge its successor. The first successful sync
        re-validates the adopted token against the live parent."""
        store = ParentStore(
            api,
            namespace=str(fed.get("parent_namespace") or "") or None,
            name=str(fed.get("parent_name") or PARENT_LEASE_NAME),
        )
        gate = cls(
            store, region=str(fed["region"]), metrics=metrics,
            offline_grace_s=offline_grace_s, clock=clock,
        )
        try:
            parent = store.load()
        except KubeApiError as e:
            if not is_outage_error(e) or "escrow" not in fed:
                raise
            gate.generation = int(fed.get("generation") or 1)
            gate.digest = str(fed.get("digest") or "") or None
            gate.regions_total = max(int(fed.get("regions") or 1), 1)
            gate.escrow_balance = (
                int(fed["escrow"]) if fed.get("escrow") is not None else None
            )
            gate.acked_spend = {str(n) for n in fed.get("acked_spend") or []}
            gate.charged = {str(n) for n in fed.get("charged") or []}
            gate.region_budget = (
                int(fed["region_budget"])
                if fed.get("region_budget") is not None else None
            )
            gate.offline.note_failure()
            log.warning(
                "region %s: parent plane dark at resume; continuing "
                "degraded on persisted escrow (balance=%s, pending "
                "reconciliation=%d)", gate.region, gate.escrow_balance,
                len(gate.charged - gate.acked_spend),
            )
            return gate
        if parent is None:
            raise rollout_state.RolloutFenced(
                "regional record is federated but the parent record is "
                "gone; abort the regional record to discard it"
            )
        if fed.get("digest") and parent.digest != fed["digest"]:
            raise rollout_state.RolloutFenced(
                "federated parent record belongs to a different rollout "
                f"(digest {parent.digest} != recorded {fed['digest']})"
            )
        if parent.status == PARENT_ABORTED:
            raise rollout_state.RolloutFenced(
                "federated rollout was aborted "
                f"({parent.halted_reason or 'no reason recorded'}); "
                "abort the regional record to discard it"
            )
        gate.attach(parent)
        return gate

    def _count(self, outcome: str) -> None:
        if self.metrics is not None:
            self.metrics.record_federation_sync(outcome)

    @property
    def degraded(self) -> bool:
        """Whether this shard has declared parent-plane degraded mode
        (dark past the offline grace)."""
        return self._was_engaged

    def sync(
        self,
        spend,
        status: str = PARENT_IN_PROGRESS,
        done: int = 0,
        total: int = 0,
        halted_reason: str | None = None,
        lease_generation: int | None = None,
    ) -> dict:
        """One wave-boundary exchange with the parent.

        Pushes this region's budget spend (union-merged — exactly-once
        under CAS races), status and progress, re-reserves the escrow
        slice; returns ``{"spend": [global union], "halted": bool,
        "reason": ...}``. Raises ``RolloutFenced`` when the parent
        generation has advanced past this shard's token (force-abort),
        the parent is aborted, or the plan digest changed under it —
        the wedged-shard self-fence.

        TRANSPORT-level failures (the parent plane is dark) do not
        raise: the shard answers itself from the escrow ledger — keep
        rolling while dark spend stays within the escrowed slice, halt
        ``escrow-exhausted`` the moment it would exceed it. The next
        successful sync reconciles dark spend exactly-once (set union)
        and returns unused escrow."""
        if self.generation is None:
            raise rollout_state.RolloutFenced(
                "federation gate used before attach()"
            )
        regional_spend = sorted(set(spend))
        # Dark spend still pending reconciliation: everything the local
        # record charged since the last acknowledged global union.
        # Between syncs the local record only grows by LOCAL charges
        # (sibling spend arrives exclusively through the fold-down), so
        # this difference is exactly this region's attribution delta.
        pending = set(regional_spend) - self.acked_spend
        terminal = status in (PARENT_COMPLETE, PARENT_HALTED)
        regional_halt: dict = {"reason": None}

        def _merge(rec: ParentRecord) -> ParentRecord:
            regional_halt["reason"] = None
            self._guard(rec)
            rec.charge_budget(regional_spend)
            track = rec.failure_budget is not None
            charged = None
            if track:
                charged = sorted(
                    rec.region_charged(self.region) | self.charged | pending
                )
            rec.note_region(
                self.region, status, done, total,
                generation=lease_generation,
                charged=charged,
                synced_at=self.wall(),
            )
            rb = rec.region_budgets.get(self.region)
            if (
                rb is not None and charged is not None
                and len(charged) > rb and status != PARENT_HALTED
            ):
                regional_halt["reason"] = (
                    f"region {self.region}: {REGION_BUDGET_REASON} "
                    f"({len(charged)} > {rb})"
                )
            target = self._escrow_target(
                rec, set(charged or []),
                terminal=terminal or regional_halt["reason"] is not None,
            )
            if target is not None:
                rec.escrow[self.region] = target
            if status == PARENT_HALTED and rec.status == PARENT_IN_PROGRESS:
                if halted_reason and any(
                    r in halted_reason for r in _REGIONAL_ONLY_HALTS
                ):
                    # Regional-only halts (this region's escrow or
                    # heterogeneous cap ran dry) stop THIS shard without
                    # halting the federation: siblings' budgets are
                    # untouched, so they keep rolling.
                    pass
                else:
                    rec.status = PARENT_HALTED
                    rec.halted_reason = halted_reason or (
                        f"region {self.region} halted"
                    )
            elif rec.all_complete and rec.status == PARENT_IN_PROGRESS:
                rec.status = PARENT_COMPLETE
            return rec

        try:
            parent = self.store.update(_merge)
        except KubeApiError as e:
            if not is_outage_error(e):
                raise
            return self._offline_view(regional_spend, pending, status)
        reconnected = self.offline.note_success()
        self._was_engaged = False
        self.acked_spend = set(parent.budget_spend)
        if parent.failure_budget is not None:
            self.charged = parent.region_charged(self.region)
            self.escrow_balance = parent.escrow.get(self.region, 0)
        else:
            self.escrow_balance = None
        self._count("ok")
        if self.metrics is not None:
            self.metrics.set_federation_budget_spent(
                len(parent.budget_spend)
            )
            self.metrics.set_federation_offline_seconds(0.0)
            if self.escrow_balance is not None:
                self.metrics.set_federation_escrow(self.escrow_balance, 0)
        halted = parent.status == PARENT_HALTED and status != PARENT_HALTED
        reason = parent.halted_reason if halted else None
        if regional_halt["reason"] and status != PARENT_HALTED:
            halted = True
            reason = regional_halt["reason"]
        return {
            "spend": list(parent.budget_spend),
            "halted": halted,
            "reason": reason,
            "parent_status": parent.status,
            "offline": False,
            "degraded": False,
            "offline_edge": False,
            "reconnected": reconnected,
            "escrow": self.escrow_balance,
        }

    def _offline_view(
        self, regional_spend: list[str], pending: set[str], status: str
    ) -> dict:
        """The shard's self-answered sync while the parent plane is
        dark: local union only, halt verdict strictly from the escrow
        ledger. ``offline_edge`` flips True exactly once per outage, the
        first sync past the grace — the caller's cue to journal
        parent-offline and cross the parent-offline crash point."""
        self.offline.note_failure()
        engaged = self.offline.engaged
        edge = engaged and not self._was_engaged
        if edge:
            self._was_engaged = True
        self._count("offline")
        if self.metrics is not None:
            self.metrics.set_federation_offline_seconds(
                self.offline.offline_seconds
            )
            if self.escrow_balance is not None:
                self.metrics.set_federation_escrow(
                    self.escrow_balance, len(pending)
                )
        halted = False
        reason = None
        terminal = status in (PARENT_COMPLETE, PARENT_HALTED)
        if (
            not terminal
            and self.escrow_balance is not None
            and len(pending) > self.escrow_balance
        ):
            # The regional remainder of a heterogeneous cap IS the
            # escrow slice, so this one comparison covers both ledgers.
            halted = True
            reason = ESCROW_EXHAUSTED_REASON
        if pending:
            self.charged = self.charged | pending
        return {
            "spend": sorted(self.acked_spend | set(regional_spend)),
            "halted": halted,
            "reason": reason,
            "parent_status": PARENT_OFFLINE,
            "offline": True,
            "degraded": engaged,
            "offline_seconds": round(self.offline.offline_seconds, 3),
            "offline_edge": edge,
            "reconnected": False,
            "escrow": self.escrow_balance,
            "escrow_pending": len(pending),
        }


def describe_parent(
    parent: ParentRecord | None, wall=time.time,
    offline_grace_s: float | None = None,
) -> str:
    """One operator-readable block for ``tpu-cc-ctl status`` /
    ``rollout --regions`` output: global ledger, then per region its
    progress, escrow balance/heterogeneous cap, and last-sync age (a
    region silent past the offline grace is flagged STALE — the
    parent-side view of a possibly-degraded shard). The age is display
    only; fencing never reads it."""
    if parent is None:
        return "federation: no parent record"
    grace = (
        offline_grace_s if offline_grace_s is not None
        else federation_offline_grace_s()
    )
    escrowed = sum(parent.escrow.values())
    lines = [
        f"federation: mode={parent.mode} status={parent.status} "
        f"gen={parent.generation} digest={parent.digest} "
        f"budget_spend={len(parent.budget_spend)}"
        + (f"/{parent.failure_budget}" if parent.failure_budget is not None
           else "")
        + (f" escrowed={escrowed}" if parent.escrow else "")
    ]
    for name in sorted(parent.regions):
        r = parent.regions[name]
        line = (
            f"  region {name}: {r.get('status')} "
            f"{r.get('done')}/{r.get('total')} group(s)"
            + (f" gen={r.get('generation')}" if r.get("generation") else "")
        )
        if name in parent.region_budgets:
            line += (
                f" budget={len(parent.region_charged(name))}"
                f"/{parent.region_budgets[name]}"
            )
        if name in parent.escrow:
            line += f" escrow={parent.escrow[name]}"
        synced_at = r.get("synced_at")
        if synced_at is not None:
            age = max(0.0, wall() - float(synced_at))
            line += f" synced {age:.0f}s ago"
            if grace > 0 and age >= grace and r.get("status") not in (
                PARENT_COMPLETE, PARENT_HALTED,
            ):
                line += " (STALE — parent plane dark or shard dead?)"
        lines.append(line)
    if parent.halted_reason:
        lines.append(f"  halted: {parent.halted_reason}")
    return "\n".join(lines)
