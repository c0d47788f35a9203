"""Crash-safe rollout state: single-writer lease + resumable record.

The per-node agents survive crashes and terminal faults; the
rolling orchestrator (ccmanager/rolling.py) was the last component with no
crash story — a bare CLI process whose SIGKILL between windows stranded a
half-flipped pool with no resumable record, and whose concurrent
invocations raced each other's label writes unfenced. This module supplies
both missing properties on top of the kubeclient Lease verbs
(coordination.k8s.io/v1, kubeclient/api.py):

**Single writer with a fencing token.** :class:`RolloutLease` wraps one
Lease object (default ``tpu-operator/tpu-cc-rollout``). Acquisition is a
resourceVersion compare-and-swap: create if absent, else take over only
when the previous holder's ``renewTime + leaseDurationSeconds`` has
passed, bumping ``leaseTransitions`` — which doubles as the **monotonic
fencing token** (the rollout *generation*). A background renewal loop
keeps ``renewTime`` fresh; any CAS loss, holder change, or renewal gap
longer than the lease duration marks the lease **lost**, after which
:class:`FencedKube` refuses every further write with
:class:`RolloutFenced` (counted in ``tpu_cc_rollout_fenced_writes_total``)
— a stale pre-crash orchestrator that wakes up cannot patch a pool a
successor now owns.

**Resumable record.** :class:`RolloutRecord` (mode, selector, generation,
the full ordered group plan, per-group outcomes, failure-budget spend)
is checkpointed into the Lease's ``metadata.annotations`` at every window
boundary — the same CAS write that renews the lease, so a checkpoint from
a fenced-out orchestrator is structurally impossible. A successor reads
the record back during acquisition and resumes exactly where the dead
orchestrator stopped: converged groups are never re-bounced, pre-crash
failures still count against ``--failure-budget``, and quarantined-node
skips are recomputed fresh (ccmanager/rolling.py).

Every desired-mode patch the fenced rollout writes also carries the
generation in :data:`ROLLOUT_GEN_LABEL`, so the pool itself records which
rollout generation last drove each node (``tpu-cc-ctl status``).
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Mapping

from tpu_cc_manager_torch import labels as labels_mod
from tpu_cc_manager_torch.kubeclient.api import KubeApi, KubeApiError, WatchEvent
from tpu_cc_manager_torch.utils import metrics as metrics_mod
from tpu_cc_manager_torch.utils import locks as locks_mod
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

#: Where the rollout lease lives. One lease per cluster: a rollout is a
#: pool-level operation and two rollouts racing over overlapping selectors
#: is exactly the hazard the single-writer lock exists to prevent.
LEASE_NAMESPACE_ENV = "CC_ROLLOUT_LEASE_NAMESPACE"
DEFAULT_LEASE_NAMESPACE = "tpu-operator"
LEASE_NAME = "tpu-cc-rollout"

#: Lease annotation carrying the checkpointed rollout record (JSON).
#: Wire names centralized in labels.py (cclint surface contract).
RECORD_ANNOTATION = labels_mod.ROLLOUT_RECORD_ANNOTATION

#: Node label stamped (with the rollout generation) alongside every
#: desired-mode patch a fenced rollout writes.
ROLLOUT_GEN_LABEL = labels_mod.ROLLOUT_GEN_LABEL

DEFAULT_LEASE_DURATION_S = 15.0

RECORD_IN_PROGRESS = "in-progress"
RECORD_COMPLETE = "complete"
RECORD_HALTED = "halted"

#: Checkpoint format version this orchestrator writes. History:
#: 1 (implicit): single-shard records with no version field.
#: 2: adds ``version`` and ``wave_shards`` (sharded rollout waves).
#: 3: adds ``surge`` (surge rollouts) — written ONLY when surge > 0, so
#: non-surge records stay v2 and older orchestrators keep resuming them;
#: a surge record resumed by a surge-unaware binary would silently strand
#: the spares' NoSchedule taints, which is exactly the silent field drop
#: the version refusal exists to prevent.
#: 4: adds ``slo_gate`` (SLO-paced rollouts) — written ONLY when a gate
#: is configured, by the same downgrade-compat logic: a latency-gated
#: record resumed by a gate-unaware binary would silently drop the gate
#: and bounce a burning pool at full speed. The parser accepts every
#: version <= the current one — v1 records resume under the sharded
#: orchestrator unchanged (the wave partition is derived from the plan,
#: never persisted) — and refuses newer versions loudly rather than
#: silently dropping fields a successor relied on.
#: 5: adds ``federation`` (region-sharded rollouts) — written ONLY when
#: this record is one regional slice of a MULTI-region federated rollout
#: (ccmanager/federation.py). A federated slice resumed by a
#: federation-unaware binary would re-drive one region unfenced against
#: the GLOBAL failure budget (spending nobody else can see), so v5 is
#: refused loudly by older parsers. A single-region federation is just a
#: plain rollout and serializes <= v4, so it round-trips through the
#: legacy resume path.
#: 6: the ``federation`` dict gains the budget-escrow ledger (``escrow``
#: balance, ``acked_spend``, ``charged`` — parent-plane partition
#: tolerance), written ONLY when the federation has a failure budget to
#: escrow. A v5 binary resuming an escrow-bearing slice would drop the
#: ledger and keep charging while the parent plane is dark with no
#: bound at all — the precise overspend the escrow exists to prevent —
#: so v6 is refused loudly by escrow-unaware parsers; budgetless
#: federated slices stay v5.
#: 7: adds ``ledger`` (the continuous-prestage capacity ledger): every
#: in-flight headroom reservation for a wave-N+1 prestage, plus the
#: per-node charge/release counters that prove exactly-once accounting
#: across a crash. Written ONLY when the ledger has ever been touched. A
#: ledger-unaware binary resuming a v7 record would silently drop the
#: reservations: armed prestages would neither converge against their
#: plan digest nor release their headroom — the successor could stack
#: fresh prestages on top of invisible old ones and spend the knee slack
#: the SLO gate is protecting — so v7 is refused loudly by older
#: parsers. Rollouts that never prestage keep writing <= v6.
#: 8: adds ``failslow`` (journaled fail-slow verdicts): one entry per
#: concluded peer-relative verdict (keyed by the vetter's monotonic id)
#: with the node, the verdict, and whether the orchestrator has ACTED
#: on it yet — journaled behind the ``failslow-vetted`` crash point
#: BEFORE acting, so a SIGKILL mid-containment resumes to the same
#: single quarantine instead of re-deriving (or double-acting) the
#: verdict. Written ONLY when a verdict has been journaled. A
#: failslow-unaware binary resuming a v8 record would drop the acted
#: markers and re-run the ladder from scratch — the double-quarantine
#: the journal exists to prevent — so v8 is refused loudly by older
#: parsers. Rollouts that never concluded a verdict keep writing <= v7.
RECORD_VERSION = 8
#: What records WITHOUT the newer optional fields write (compat floors).
RECORD_VERSION_NO_FAILSLOW = 7
RECORD_VERSION_NO_LEDGER = 6
RECORD_VERSION_NO_ESCROW = 5
RECORD_VERSION_NO_FEDERATION = 4
RECORD_VERSION_NO_SLO = 3
RECORD_VERSION_NO_SURGE = 2

#: Capacity-ledger entry states. ``reserved``: headroom charged, the
#: arm annotation not yet (durably) written. ``armed``: the PRESTAGE
#: annotation is on the node; its agent is (or will be) running the
#: full journaled flip + warmup — the node is in transition and
#: consumes headroom. ``held``: the agent published a valid prestaged
#: record and re-admitted — the node serves again (at the target mode,
#: holding), so it no longer consumes transition headroom; the entry
#: stays until the node's flip window converges it (release) or the
#: plan moves past it (invalidate).
LEDGER_RESERVED = "reserved"
LEDGER_ARMED = "armed"
LEDGER_HELD = "held"
_LEDGER_STATES = (LEDGER_RESERVED, LEDGER_ARMED, LEDGER_HELD)


def plan_digest(mode: str, gid: str, names) -> str:
    """Short content digest of one group's flip plan (target mode +
    group identity + membership). A ledger entry is only adoptable while
    the digest it was reserved under still matches the live plan — a
    stale prestaged node must re-flip, never converge against an old
    plan (rolling.py continuous prestage)."""
    basis = "|".join([str(mode), str(gid)] + sorted(str(n) for n in names))
    return hashlib.sha256(basis.encode("utf-8")).hexdigest()[:12]


@dataclass
class CapacityLedger:
    """Journaled headroom reservations for continuous prestage (record
    format v7). One entry per prestaging node; ``charged``/``released``
    are per-node lifetime counters, persisted so "balances to zero, no
    double charge" is provable across a crash: the ledger is balanced
    iff total charges minus total releases equals the live entry count,
    and a node was never double-charged iff its charge count stayed at
    one. All mutation happens under the orchestrator's record lock
    (rolling.py brackets every mutation + checkpoint)."""

    entries: dict[str, dict] = field(default_factory=dict)
    charged: dict[str, int] = field(default_factory=dict)
    released: dict[str, int] = field(default_factory=dict)

    def entry(self, node: str) -> dict | None:
        return self.entries.get(node)

    def in_transition(self) -> int:
        """Entries currently consuming headroom (reserved/armed — the
        node is mid-prestage). Held entries serve again and count 0."""
        return sum(
            1 for e in self.entries.values()
            if e.get("state") != LEDGER_HELD
        )

    def active(self) -> int:
        return len(self.entries)

    def reserve(
        self, node: str, gid: str, digest: str, generation: int,
        limit: int,
    ) -> bool:
        """CAS-reserve one node of headroom. Refused (False, nothing
        charged) when the node already holds an entry — re-reserving is
        the double charge the ledger exists to prevent; a resume adopts
        the existing entry instead — or when the reservation would push
        the in-transition count past ``limit``. The caller checkpoints
        the record after a successful reserve: the durable write IS the
        reservation."""
        if node in self.entries:
            return False
        if self.in_transition() >= max(0, int(limit)):
            return False
        self.entries[node] = {
            "gid": str(gid),
            "digest": str(digest),
            "generation": int(generation),
            "state": LEDGER_RESERVED,
        }
        self.charged[node] = self.charged.get(node, 0) + 1
        return True

    def mark(self, node: str, state: str, generation: int | None = None) -> None:
        """Advance an entry's state (reserved -> armed -> held). A
        resume re-stamps the fence generation it adopted the entry
        under."""
        assert state in _LEDGER_STATES, state
        e = self.entries.get(node)
        if e is None:
            return
        e["state"] = state
        if generation is not None:
            e["generation"] = int(generation)

    def release(self, node: str) -> bool:
        """Drop an entry (converged / invalidated / aborted / degraded)
        and count the release. Releasing an absent node is a no-op
        (False) so the counters can never drift from the entry map — a
        crash between an in-memory release and its checkpoint re-runs
        the release idempotently on resume."""
        if self.entries.pop(node, None) is None:
            return False
        self.released[node] = self.released.get(node, 0) + 1
        return True

    def charges_total(self) -> int:
        return sum(self.charged.values())

    def releases_total(self) -> int:
        return sum(self.released.values())

    def balanced(self) -> bool:
        """The conservation invariant: every charge is either still an
        entry or exactly one release. Zero entries + balanced means the
        ledger balances to zero."""
        return (
            self.charges_total() - self.releases_total()
            == len(self.entries)
        )

    def double_charged(self) -> list[str]:
        """Nodes charged more than once over the rollout's lifetime —
        must stay empty across any kill/resume interleaving."""
        return sorted(n for n, c in self.charged.items() if c > 1)

    def to_dict(self) -> dict:
        return {
            "entries": {n: dict(e) for n, e in sorted(self.entries.items())},
            "charged": dict(sorted(self.charged.items())),
            "released": dict(sorted(self.released.items())),
        }

    @classmethod
    def from_dict(cls, obj: dict) -> "CapacityLedger":
        return cls(
            entries={
                str(n): dict(e)
                for n, e in (obj.get("entries") or {}).items()
            },
            charged={
                str(n): int(c)
                for n, c in (obj.get("charged") or {}).items()
            },
            released={
                str(n): int(c)
                for n, c in (obj.get("released") or {}).items()
            },
        )

    def touched(self) -> bool:
        """Whether this ledger has ever recorded anything — an untouched
        ledger is dropped from the serialized record so non-prestaging
        rollouts keep their downgrade-compatible <= v6 format."""
        return bool(self.entries or self.charged)


def lease_namespace() -> str:
    return os.environ.get(LEASE_NAMESPACE_ENV, DEFAULT_LEASE_NAMESPACE)


class RolloutFenced(Exception):
    """This orchestrator no longer holds the rollout lease: a successor
    (or expiry) fenced it out, and it must stop writing immediately."""


class LeaseHeld(Exception):
    """Another live orchestrator holds the rollout lease."""

    def __init__(self, holder: str, renew_age_s: float | None = None):
        age = (
            f", last renewed {renew_age_s:.0f}s ago"
            if renew_age_s is not None
            else ""
        )
        super().__init__(f"rollout lease held by {holder!r}{age}")
        self.holder = holder


@dataclass
class RolloutRecord:
    """The durable state of one pool rollout (JSON in the lease
    annotation). ``groups`` is the FULL ordered plan decided at start;
    ``done`` maps finished group ids to their outcome; ``budget_spend``
    is the set of node names already charged against ``failure_budget``
    (quarantined-or-failed), which must survive a crash so a successor's
    budget math starts from the pre-crash spend, not from zero."""

    mode: str
    selector: str
    generation: int
    groups: list[tuple[str, tuple[str, ...]]]
    done: dict[str, dict] = field(default_factory=dict)
    budget_spend: list[str] = field(default_factory=list)
    max_unavailable: int = 1
    failure_budget: int | None = None
    status: str = RECORD_IN_PROGRESS
    # Sharded rollout waves (format v2): how many concurrent lease-fenced
    # sub-rollouts the recording orchestrator ran; a plain resume inherits
    # it like max_unavailable/failure_budget.
    wave_shards: int = 1
    # Surge rollouts (format v3, written only when non-zero): how many
    # spare nodes the recording orchestrator flipped first behind the
    # surge taint. Carried for visibility and for the resume's stale-
    # taint reclaim — a resume never re-runs the surge phase itself
    # (rolling.py: re-picking "spares" from serving nodes would exceed
    # max_unavailable behind a taint that evicts nothing).
    surge: int = 0
    # SLO-paced rollouts (format v4, written only when configured): the
    # gate's parameters (rolling.SloGateConfig.to_dict() — max burn
    # rate, p99 target, window, pause budget, metrics source), persisted
    # so a crash + --resume re-arms the gate instead of silently
    # resuming a latency-gated rollout ungated.
    slo_gate: dict | None = None
    # Federated region-sharded rollouts (format v5, written only for a
    # regional slice of a MULTI-region federation): this shard's region
    # name plus the parent-record coordinates
    # (ccmanager/federation.py FederationGate.to_record_dict()) so a
    # crash + --resume reconnects the successor to the parent's global
    # budget instead of silently resuming one region unfenced.
    federation: dict | None = None
    # Continuous-prestage capacity ledger (format v7, written only once
    # touched): in-flight wave-N+1 headroom reservations plus the
    # per-node charge/release counters. A successor adopts armed
    # entries as-is (no re-surge, no second charge) and invalidates
    # entries whose plan digest no longer matches.
    ledger: CapacityLedger | None = None
    # Journaled fail-slow verdicts (format v8, written only when one
    # exists): vetter verdict id (str) -> {"node", "verdict",
    # "deviation", "acted"}. Journal-then-act: an entry lands here (and
    # is checkpointed) BEFORE the remediation ladder runs, behind the
    # failslow-vetted crash point, so a successor acts each verdict
    # exactly once — already-acted entries are skipped, unacted ones
    # retried (the ladder's actions are idempotent).
    failslow: dict[str, dict] = field(default_factory=dict)

    def charge_budget(self, nodes) -> None:
        self.budget_spend = sorted(set(self.budget_spend) | set(nodes))

    def note_group(
        self, gid: str, ok: bool, states: dict, seconds: float,
        skipped: bool = False,
    ) -> None:
        self.done[gid] = {
            "ok": bool(ok),
            "states": dict(states),
            "seconds": round(float(seconds), 3),
            "skipped": bool(skipped),
        }

    def to_json(self) -> str:
        # A single-region "federation" is a plain rollout: drop the field
        # so the record stays <= v4 and the legacy resume path round-trips
        # it (the downgrade-compat contract, tests/test_federation.py).
        federation = self.federation if (
            self.federation and int(self.federation.get("regions") or 0) > 1
        ) else None
        ledger = (
            self.ledger if self.ledger is not None and self.ledger.touched()
            else None
        )
        if self.failslow:
            # A verdict is journaled: a failslow-unaware resume would
            # drop the acted markers and double-act the ladder, so
            # refuse downgrade.
            version = RECORD_VERSION
        elif ledger is not None:
            # The rollout prestaged: a ledger-unaware resume would drop
            # the reservations and stack fresh prestages on invisible
            # old ones, so refuse downgrade.
            version = RECORD_VERSION_NO_FAILSLOW
        elif federation and "escrow" in federation:
            # The shard holds an escrow ledger (parent-plane partition
            # tolerance): an escrow-unaware resume would keep charging
            # unbounded while the parent is dark, so refuse downgrade.
            version = RECORD_VERSION_NO_LEDGER
        elif federation:
            version = RECORD_VERSION_NO_ESCROW
        elif self.slo_gate:
            version = RECORD_VERSION_NO_FEDERATION
        elif self.surge:
            version = RECORD_VERSION_NO_SLO
        else:
            version = RECORD_VERSION_NO_SURGE
        body = {
            "version": version,
            "mode": self.mode,
            "selector": self.selector,
            "generation": self.generation,
            "groups": [[gid, list(nodes)] for gid, nodes in self.groups],
            "done": self.done,
            "budget_spend": list(self.budget_spend),
            "max_unavailable": self.max_unavailable,
            "failure_budget": self.failure_budget,
            "status": self.status,
            "wave_shards": self.wave_shards,
            "surge": self.surge,
            "slo_gate": self.slo_gate,
        }
        if federation:
            body["federation"] = federation
        if ledger is not None:
            body["ledger"] = ledger.to_dict()
        if self.failslow:
            body["failslow"] = self.failslow
        return json.dumps(body, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, data: str) -> "RolloutRecord":
        try:
            obj = json.loads(data)
            version = int(obj.get("version") or 1)
            if version > RECORD_VERSION:
                # A newer orchestrator checkpointed fields this one cannot
                # represent; resuming would silently drop them.
                raise RolloutFenced(
                    f"rollout record format v{version} is newer than this "
                    f"orchestrator understands (max v{RECORD_VERSION}); "
                    "upgrade, or --abort to discard"
                )
            return cls(
                mode=str(obj["mode"]),
                selector=str(obj["selector"]),
                generation=int(obj["generation"]),
                groups=[
                    (str(gid), tuple(str(n) for n in nodes))
                    for gid, nodes in obj["groups"]
                ],
                done={str(k): dict(v) for k, v in (obj.get("done") or {}).items()},
                budget_spend=[str(n) for n in obj.get("budget_spend") or []],
                max_unavailable=int(obj.get("max_unavailable") or 1),
                failure_budget=(
                    int(obj["failure_budget"])
                    if obj.get("failure_budget") is not None
                    else None
                ),
                status=str(obj.get("status") or RECORD_IN_PROGRESS),
                wave_shards=int(obj.get("wave_shards") or 1),
                surge=int(obj.get("surge") or 0),
                slo_gate=(
                    dict(obj["slo_gate"])
                    if isinstance(obj.get("slo_gate"), dict) else None
                ),
                federation=(
                    dict(obj["federation"])
                    if isinstance(obj.get("federation"), dict) else None
                ),
                ledger=(
                    CapacityLedger.from_dict(obj["ledger"])
                    if isinstance(obj.get("ledger"), dict) else None
                ),
                failslow=(
                    {str(k): dict(v) for k, v in obj["failslow"].items()}
                    if isinstance(obj.get("failslow"), dict) else {}
                ),
            )
        except RolloutFenced:
            raise
        except (ValueError, KeyError, TypeError) as e:
            raise RolloutFenced(f"unreadable rollout record: {e}") from e


def record_of_lease(lease: dict) -> RolloutRecord | None:
    """Parse the checkpointed record out of a Lease object (None when the
    annotation is absent). An unreadable record raises RolloutFenced — a
    corrupt checkpoint must be surfaced, not silently restarted over."""
    raw = ((lease.get("metadata") or {}).get("annotations") or {}).get(
        RECORD_ANNOTATION
    )
    return RolloutRecord.from_json(raw) if raw else None


def _now_rfc3339(wall) -> str:
    # divmod AFTER scaling to whole microseconds: rounding the fraction
    # alone can yield 1000000 µs (a 7-digit field a real apiserver's
    # MicroTime parser rejects) when the wall clock sits within half a
    # microsecond of the next second.
    secs, micros = divmod(int(round(wall() * 1e6)), 1_000_000)
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(secs)) + (
        ".%06dZ" % micros
    )


def _parse_rfc3339(value: str | None) -> float | None:
    if not value:
        return None
    try:
        base, _, frac = value.rstrip("Z").partition(".")
        import calendar

        stamp = calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
        return stamp + (float("0." + frac) if frac else 0.0)
    except (ValueError, OverflowError):
        return None


def lease_holder_alive(lease: dict, wall=time.time) -> tuple[str | None, bool]:
    """(holderIdentity or None, whether that hold is still live) for a
    Lease object — the shared expiry predicate for status display and the
    --abort live-holder guard."""
    spec = lease.get("spec") or {}
    holder = spec.get("holderIdentity") or None
    if holder is None:
        return None, False
    renew = _parse_rfc3339(spec.get("renewTime") or spec.get("acquireTime"))
    duration = float(spec.get("leaseDurationSeconds") or 0)
    return holder, renew is not None and (wall() - renew) < duration


def release_lease(api: KubeApi, namespace: str, name: str = LEASE_NAME) -> None:
    """Force-release: empty the holder and discard the record via CAS
    update — NOT delete. Keeping the Lease object preserves the
    ``leaseTransitions`` counter, so the fencing generation stays
    monotonic across an abort (a deleted-and-recreated lease would
    restart at 1 and the rollout-gen labels would go backwards). A live
    wedged holder's next renewal 409s against this write, re-reads a
    holder that is no longer it, and fences itself immediately."""
    for _ in range(4):
        lease = api.get_lease(namespace, name)
        lease["spec"]["holderIdentity"] = ""
        ((lease.get("metadata") or {}).get("annotations") or {}).pop(
            RECORD_ANNOTATION, None
        )
        try:
            api.update_lease(namespace, name, lease)
            return
        except KubeApiError as e:
            if e.status != 409:
                raise
    raise KubeApiError(
        None, f"lease {namespace}/{name}: force-release kept conflicting"
    )


def describe_lease(lease: dict, wall=time.time) -> str:
    """One operator-readable line about the rollout lease + record, for
    ``tpu-cc-ctl status``: who holds it, whether the hold is live or
    expired (resumable), the fencing generation, and groups done/total."""
    spec = lease.get("spec") or {}
    holder = spec.get("holderIdentity") or "-"
    renew = _parse_rfc3339(spec.get("renewTime") or spec.get("acquireTime"))
    duration = float(spec.get("leaseDurationSeconds") or 0)
    if not holder or holder == "-":
        liveness = "released"
    elif renew is None or wall() - renew >= duration:
        liveness = "EXPIRED (resumable)"
    else:
        liveness = f"live, renewed {wall() - renew:.0f}s ago"
    parts = [
        f"holder={holder}", f"({liveness})",
        f"generation={spec.get('leaseTransitions', '?')}",
    ]
    try:
        record = record_of_lease(lease)
    except RolloutFenced:
        record = None
        parts.append("record=UNREADABLE")
    if record is not None:
        done_ok = sum(1 for d in record.done.values() if d.get("ok"))
        parts.insert(0, f"mode={record.mode} selector={record.selector}")
        parts.append(f"groups={done_ok}/{len(record.groups)} done")
        parts.append(f"status={record.status}")
    return "ROLLOUT " + " ".join(parts)


class RolloutLease:
    """One orchestrator's hold on the rollout lease.

    ``wall`` (epoch seconds, for the cross-process expiry decision baked
    into the Lease object) and ``clock`` (monotonic, for this process's
    own validity window) are injectable so crash/fencing tests control
    time deterministically.
    """

    def __init__(
        self,
        api: KubeApi,
        holder: str,
        namespace: str | None = None,
        name: str = LEASE_NAME,
        duration_s: float = DEFAULT_LEASE_DURATION_S,
        metrics: metrics_mod.MetricsRegistry | None = None,
        wall=time.time,
        clock=time.monotonic,
        max_clock_skew_s: float = 0.0,
    ) -> None:
        self.api = api
        self.holder = holder
        self.namespace = namespace or lease_namespace()
        self.name = name
        self.duration_s = max(0.001, duration_s)
        # Cross-region skew tolerance. When > 0, a wall-clock "expired"
        # verdict against another holder is never trusted directly —
        # their renewTime was stamped by THEIR wall clock, and a skew of
        # ±max_clock_skew_s can fabricate expiry on a healthy holder.
        # Instead acquire() treats renewTime as an opaque token and
        # observes it over one lease duration of LOCAL monotonic time:
        # an alive holder must advance it in that window regardless of
        # what either wall clock reads. 0 keeps the legacy wall-only
        # verdict (single-cluster, one wall clock).
        self.max_clock_skew_s = max(0.0, max_clock_skew_s)
        self.metrics = metrics if metrics is not None else metrics_mod.REGISTRY
        self.wall = wall
        self.clock = clock
        #: The fencing token: leaseTransitions at our acquisition. Every
        #: desired-mode patch carries it; strictly increases across
        #: holders because every acquisition CAS-increments it.
        self.generation: int | None = None
        self.lost = False
        self._lease: dict | None = None  # cclint: guarded-by(_lock)
        self._last_renew: float | None = None  # cclint: guarded-by(_lock)
        self._lock = locks_mod.make_lock("rollout-lease.state")
        # Serializes whole lease WRITES within this process: without it
        # the renewer thread can CAS between the main thread's read and
        # write, turning every window-boundary checkpoint into a
        # conflict. (Cross-process conflicts are still resolved by
        # holder identity + retry in checkpoint().)
        self._write_lock = locks_mod.make_lock("rollout-lease.write")
        self._renew_stop: threading.Event | None = None
        self._renew_thread: threading.Thread | None = None

    # -- acquisition ----------------------------------------------------

    def _expired(self, spec: dict) -> tuple[bool, float | None]:
        renew = _parse_rfc3339(
            spec.get("renewTime") or spec.get("acquireTime")
        )
        if renew is None:
            return True, None  # never renewed / unparseable: claimable
        duration = float(spec.get("leaseDurationSeconds") or self.duration_s)
        age = self.wall() - renew
        return age >= duration, age

    def acquire(self) -> RolloutRecord | None:
        """Create or take over the lease; returns the checkpointed record
        of a previous (dead) holder, or None when starting fresh. Raises
        :class:`LeaseHeld` when a live holder exists, and propagates
        KubeApiError (including the lease-unsupported marker) untouched
        so the caller can degrade."""
        now = _now_rfc3339(self.wall)
        try:
            lease = self.api.get_lease(self.namespace, self.name)
        except KubeApiError as e:
            if e.status != 404:
                raise
            try:
                created = self.api.create_lease(
                    self.namespace, self.name,
                    {
                        "holderIdentity": self.holder,
                        "leaseDurationSeconds": int(round(self.duration_s)) or 1,
                        "acquireTime": now,
                        "renewTime": now,
                        "leaseTransitions": 1,
                    },
                )
            except KubeApiError as e2:
                if e2.status == 409:
                    raise LeaseHeld("<concurrent creator>") from e2
                raise
            with self._lock:
                self._adopt(created, 1)
            log.info(
                "acquired rollout lease %s/%s (generation 1)",
                self.namespace, self.name,
            )
            self.metrics.record_lease_transition()
            return None
        spec = lease.get("spec") or {}
        prev_holder = spec.get("holderIdentity")
        expired, age = self._expired(spec)
        if prev_holder and prev_holder != self.holder:
            # A stamp more than 1 s in OUR future can only come from a
            # skewed remote wall clock; wall math would keep a dead
            # holder "live" until our clock catches up, so it is as
            # suspect as an expired one.
            future_stamp = age is not None and age < -1.0
            if self.max_clock_skew_s > 0 and (expired or future_stamp):
                # The wall clocks disagree about this holder (expired,
                # or stamped from the future) — but their stamp came
                # from a different region's clock, so neither verdict
                # is trustworthy. Confirm skew-free before fencing:
                # watch renewTime as an opaque token for one lease
                # duration of LOCAL monotonic time. An alive holder
                # must advance it; a dead one cannot.
                lease = self._observe_holder(lease, prev_holder)
                spec = lease.get("spec") or {}
            elif not expired:
                raise LeaseHeld(prev_holder, age)
        record = record_of_lease(lease)
        transitions = int(spec.get("leaseTransitions") or 0) + 1
        updated = copy.deepcopy(lease)
        updated["spec"] = {
            "holderIdentity": self.holder,
            "leaseDurationSeconds": int(round(self.duration_s)) or 1,
            "acquireTime": now,
            "renewTime": now,
            "leaseTransitions": transitions,
        }
        try:
            stored = self.api.update_lease(self.namespace, self.name, updated)
        except KubeApiError as e:
            if e.status == 409:
                raise LeaseHeld("<concurrent acquirer>") from e
            raise
        with self._lock:
            self._adopt(stored, transitions)
        log.info(
            "took over rollout lease %s/%s from %r (generation %d%s)",
            self.namespace, self.name, prev_holder, transitions,
            ", resumable record found" if record else "",
        )
        self.metrics.record_lease_transition()
        return record

    def _observe_holder(self, lease: dict, prev_holder: str) -> dict:
        """Skew-free liveness check on another holder: poll the lease for
        one lease duration of LOCAL monotonic time, treating renewTime +
        leaseTransitions purely as an opaque change-token. Any change
        (renewal, or a third party's takeover) proves a live writer →
        :class:`LeaseHeld`; a token frozen for a full duration proves the
        holder dead on ITS OWN terms (it must renew within its advertised
        duration or self-fence) → return the last-seen lease so the
        caller takes over. No wall clock is consulted."""
        spec = lease.get("spec") or {}
        token = (spec.get("renewTime"), spec.get("leaseTransitions"))
        deadline = self.clock() + self.duration_s
        poll = max(0.05, min(1.0, self.duration_s / 5.0))
        while True:
            remaining = deadline - self.clock()
            if remaining <= 0:
                return lease
            retry_mod.wait(min(poll, remaining))
            try:
                lease = self.api.get_lease(self.namespace, self.name)
            except KubeApiError as e:
                if e.status == 404:
                    # Holder (or an aborter) deleted it; acquire() has
                    # already passed the 404 branch, so surface as a
                    # held-then-released race for the caller to retry.
                    raise LeaseHeld(
                        f"{prev_holder!r} (lease deleted mid-observation)"
                    ) from e
                raise
            spec = lease.get("spec") or {}
            now_token = (spec.get("renewTime"), spec.get("leaseTransitions"))
            if now_token != token:
                raise LeaseHeld(
                    spec.get("holderIdentity") or prev_holder,
                )

    def _adopt(self, lease: dict, generation: int) -> None:  # cclint: requires(_lock)
        self._lease = lease
        self.generation = generation
        self._last_renew = self.clock()
        self.lost = False

    # -- validity / fencing ---------------------------------------------

    @property
    def valid(self) -> bool:
        with self._lock:
            return (
                not self.lost
                and self._last_renew is not None
                and (self.clock() - self._last_renew) < self.duration_s
            )

    def check(self) -> None:
        """Raise RolloutFenced unless this process still plausibly holds
        the lease: never explicitly lost AND renewed within the lease
        duration. The time bound is the stale-orchestrator guard — a
        process that slept past its own lease duration must assume a
        successor took over and stop writing, even before any apiserver
        round trip confirms it."""
        if not self.valid:
            self.lost = True
            raise RolloutFenced(
                f"rollout lease {self.namespace}/{self.name} no longer held "
                f"by {self.holder!r} (generation {self.generation})"
            )

    # -- renewal / checkpointing -----------------------------------------

    def checkpoint(self, record: RolloutRecord | None = None,
                   clear_record: bool = False) -> None:
        """Renew the lease and (optionally) persist the rollout record in
        one CAS write. A 409 means someone else wrote the lease; since
        only the holder writes it, that someone is a successor — except
        when a write of OUR OWN landed out from under us (a retried
        ambiguous attempt, or the renewer thread racing across
        processes), which the re-read disambiguates by holder identity.
        In the still-ours case THIS write is retried on the fresh
        resourceVersion — merely adopting the re-read lease would
        silently drop the record update (the conflicting write was
        usually a bare renew), and a successor would then resume from a
        stale checkpoint and re-bounce converged groups."""
        self.check()
        with self._write_lock:
            for _ in range(4):
                with self._lock:
                    lease = copy.deepcopy(self._lease)
                lease["spec"]["renewTime"] = _now_rfc3339(self.wall)
                lease["spec"]["holderIdentity"] = self.holder
                annotations = lease["metadata"].setdefault("annotations", {})
                if record is not None:
                    record.generation = self.generation or record.generation
                    annotations[RECORD_ANNOTATION] = record.to_json()
                elif clear_record:
                    annotations.pop(RECORD_ANNOTATION, None)
                try:
                    stored = self.api.update_lease(
                        self.namespace, self.name, lease
                    )
                except KubeApiError as e:
                    if e.status != 409:
                        raise  # transient apiserver failure: not (yet) fenced
                    resolved = self._resolve_conflict()
                    if resolved is None:
                        raise RolloutFenced(
                            f"rollout lease {self.namespace}/{self.name} was "
                            f"taken over (CAS conflict); {self.holder!r} is "
                            "fenced out"
                        ) from e
                    with self._lock:
                        self._lease = resolved
                        self._last_renew = self.clock()
                    continue  # still ours: retry THIS write on the fresh rv
                with self._lock:
                    self._lease = stored
                    self._last_renew = self.clock()
                return
        # Only reachable if our own writes keep colliding — transient by
        # construction (each round re-read a lease we still hold), so let
        # the caller's retry policy decide.
        raise KubeApiError(
            None,
            f"rollout lease {self.namespace}/{self.name}: checkpoint kept "
            "conflicting with our own writes",
        )

    def _resolve_conflict(self) -> dict | None:
        """After a 409: re-read the lease. Still ours → our earlier write
        landed (adopt it); any other holder → fenced."""
        try:
            stored = self.api.get_lease(self.namespace, self.name)
        except KubeApiError:
            return None  # cannot prove we still hold it: fail safe
        if (stored.get("spec") or {}).get("holderIdentity") == self.holder:
            return stored
        self.lost = True
        return None

    def renew(self) -> None:
        self.checkpoint()

    def start_renewer(self, interval_s: float | None = None) -> None:
        """Background renewal at duration/3 (leader-election convention).
        Transient failures are logged and retried next tick — the local
        validity window in :meth:`check` is what actually fences when
        renewals stop landing."""
        if self._renew_thread is not None:
            return
        interval = interval_s if interval_s is not None else self.duration_s / 3.0
        stop = threading.Event()

        def loop() -> None:
            while not stop.wait(interval):
                try:
                    self.renew()
                except RolloutFenced as e:
                    log.error("rollout lease renewal fenced: %s", e)
                    return
                except KubeApiError as e:
                    log.warning("rollout lease renewal failed: %s", e)

        t = threading.Thread(target=loop, name="rollout-lease-renew", daemon=True)
        self._renew_stop = stop
        self._renew_thread = t
        t.start()

    def stop_renewer(self) -> None:
        if self._renew_stop is not None:
            self._renew_stop.set()
        if self._renew_thread is not None:
            self._renew_thread.join(timeout=2.0)
        self._renew_stop = None
        self._renew_thread = None

    def release(self, clear_record: bool = False) -> None:
        """Give the lease up cleanly (holderIdentity emptied so the next
        orchestrator acquires without waiting out the duration). Best
        effort: a fenced or unreachable lease is simply left to expire."""
        self.stop_renewer()
        if self.lost:
            return
        try:
            self.checkpoint(clear_record=clear_record)
            with self._lock:
                lease = copy.deepcopy(self._lease)
            lease["spec"]["holderIdentity"] = ""
            self.api.update_lease(self.namespace, self.name, lease)
            log.info(
                "released rollout lease %s/%s", self.namespace, self.name
            )
        except (KubeApiError, RolloutFenced) as e:
            log.warning("could not release rollout lease cleanly: %s", e)


class FencedKube(KubeApi):
    """KubeApi wrapper that refuses every WRITE once the rollout lease is
    lost. Reads pass through unfenced — a stale orchestrator looking is
    harmless, a stale orchestrator patching is the split-brain the lease
    exists to prevent. Refusals raise :class:`RolloutFenced` and count in
    ``tpu_cc_rollout_fenced_writes_total``."""

    def __init__(
        self,
        inner: KubeApi,
        lease: RolloutLease,
        metrics: metrics_mod.MetricsRegistry | None = None,
    ) -> None:
        self.inner = inner
        self.lease = lease
        self.metrics = metrics if metrics is not None else lease.metrics
        self.retries_internally = getattr(inner, "retries_internally", False)

    def _fence(self, op: str) -> None:
        try:
            self.lease.check()
        except RolloutFenced:
            self.metrics.record_fenced_write()
            log.error(
                "REFUSED %s: this orchestrator (generation %s) no longer "
                "holds the rollout lease", op, self.lease.generation,
            )
            raise

    # Writes: fenced.

    def patch_node_labels(self, name: str, labels: Mapping[str, str | None]) -> dict:
        self._fence(f"patch_node_labels({name})")
        return self.inner.patch_node_labels(name, labels)

    def patch_node_annotations(
        self, name: str, annotations: Mapping[str, str | None]
    ) -> dict:
        self._fence(f"patch_node_annotations({name})")
        return self.inner.patch_node_annotations(name, annotations)

    def patch_node_taints(
        self, name: str, add: list[dict], remove_keys: list[str]
    ) -> dict:
        self._fence(f"patch_node_taints({name})")
        return self.inner.patch_node_taints(name, add, remove_keys)

    # Reads and best-effort signals: pass through.

    def get_node(self, name: str) -> dict:
        return self.inner.get_node(name)

    def list_nodes(self, label_selector: str | None = None) -> list[dict]:
        return self.inner.list_nodes(label_selector)

    def list_nodes_page(
        self,
        label_selector: str | None = None,
        limit: int | None = None,
        continue_token: str | None = None,
    ) -> dict:
        return self.inner.list_nodes_page(label_selector, limit, continue_token)

    def watch_nodes_pool(
        self,
        label_selector: str | None = None,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        return self.inner.watch_nodes_pool(
            label_selector, resource_version, timeout_seconds
        )

    def list_pods(
        self,
        namespace: str,
        label_selector: str | None = None,
        field_selector: str | None = None,
    ) -> list[dict]:
        return self.inner.list_pods(namespace, label_selector, field_selector)

    def watch_nodes(
        self,
        name: str,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        return self.inner.watch_nodes(name, resource_version, timeout_seconds)

    def create_event(self, namespace: str, event: dict) -> dict:
        return self.inner.create_event(namespace, event)

    def self_subject_access_review(
        self, verb: str, resource: str, namespace: str | None = None
    ) -> bool:
        return self.inner.self_subject_access_review(verb, resource, namespace)

    def get_lease(self, namespace: str, name: str) -> dict:
        return self.inner.get_lease(namespace, name)

    def create_lease(self, namespace: str, name: str, spec: dict) -> dict:
        return self.inner.create_lease(namespace, name, spec)

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict:
        return self.inner.update_lease(namespace, name, lease)

    def delete_lease(self, namespace: str, name: str) -> None:
        return self.inner.delete_lease(namespace, name)
