"""tpu-cc-ctl: operator CLI for pool-level operations.

The reference has no pool tooling (its only entry point is the per-node
agent); this CLI drives the new coordination layers:

- ``rollout``  rolling CC reconfiguration across a pool
  (ccmanager/rolling.py; BASELINE.json configs[3]),
- ``attest``   cross-slice attestation verification
  (ccmanager/multislice.py; configs[4]),
- ``status``   one-line-per-node view of desired/actual/ready labels.

Usage: ``python -m tpu_cc_manager_torch.ctl <command> ...`` or the
``tpu-cc-ctl`` console script.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from tpu_cc_manager_torch.ccmanager.multislice import (
    PoolAttestationError,
    pool_report,
    verify_pool_attestation,
)
from tpu_cc_manager_torch.ccmanager.rolling import (
    SLICE_ID_LABEL,
    SURGE_TAINT_KEY,
    RollingReconfigurator,
)
from tpu_cc_manager_torch.kubeclient.api import node_labels
from tpu_cc_manager_torch.kubeclient.rest import ClusterConfig, RestKube
from tpu_cc_manager_torch.labels import (
    CC_MODE_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    VALID_MODES,
)
from tpu_cc_manager_torch.utils.logging import setup_logging

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-cc-ctl")
    p.add_argument("--kubeconfig", default=None)
    p.add_argument("-d", "--debug", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("rollout", help="rolling CC reconfiguration over a pool")
    r.add_argument("--selector", required=True, help="node label selector, e.g. pool=tpu")
    r.add_argument(
        "--mode", default=None,
        help=f"target mode: {VALID_MODES} (optional with --resume, which "
        "adopts the persisted record's mode)",
    )
    r.add_argument(
        "--max-unavailable", type=str, default=None,
        help="concurrent group budget (default 1; a resumed rollout "
        "inherits the record's value unless this flag is passed). With "
        "--regions, accepts per-region overrides — '2,r2=3' caps r2 at "
        "3 with every other region at 2",
    )
    r.add_argument("--node-timeout", type=float, default=600.0)
    r.add_argument("--continue-on-failure", action="store_true")
    r.add_argument(
        "--rollback-on-failure", action="store_true",
        help="on halt, revert already-converged groups to their prior "
        "desired mode (the failed group is left for the operator)",
    )
    r.add_argument(
        "--failure-budget", type=str, default=None,
        help="pool failure budget: halt (and refuse to start) when MORE "
        "than this many nodes are quarantined or already failed this "
        "rollout (pre-crash failures persist in the record) — a "
        "fleet-level circuit breaker (default: no budget). With "
        "--regions, accepts heterogeneous per-region budgets — "
        "'r1=2,r2=5' (every region must be named; the global budget is "
        "their sum, and a region halts alone at its own cap)",
    )
    r.add_argument(
        "--wave-shards", type=int, default=None,
        help="sharded rollout waves: run up to N concurrent sub-rollouts "
        "partitioned by zone (topology.kubernetes.io/zone; groups "
        "without a zone partition alone) under ONE failure budget and "
        "ONE resumable record — total in-flight disruption is "
        "wave-shards × max-unavailable (default 1: the classic strictly "
        "rolling single queue; a resume inherits the record's value)",
    )
    r.add_argument(
        "--surge", type=int, default=None,
        help="surge rollout: flip up to N spare nodes FIRST behind the "
        f"{SURGE_TAINT_KEY} NoSchedule taint "
        "(unschedulable-for-workloads for exactly their flip window), "
        "then reclaim them — the rolling waves migrate workloads onto "
        "already-flipped capacity, so measured pool unavailability stays "
        "<= max-unavailable throughout (default 0: no surge; a resume "
        "inherits the record's value)",
    )
    r.add_argument(
        "--prestage", action="store_true",
        help="zero-bounce spares: with --surge, arm the spares' "
        "pre-staging (surge taint + prestage annotation — each agent "
        "runs the full journaled flip + compile warmup ahead of the "
        "wave and holds) and await their records before opening the "
        "flip window, which then converges in ~drain+readmit time; "
        "spares already armed by --prestage-only flip instantly. "
        "Agents that never pre-stage fall back to the full flip after "
        "--prestage-timeout",
    )
    r.add_argument(
        "--prestage-only", action="store_true",
        help="arm + await spare pre-staging and EXIT without flipping "
        "anything (requires --surge N and --mode): run it while the "
        "pool is still serving at full capacity, then the later "
        "--surge --prestage rollout's spare window opens instantly. "
        "The surge taint is kept on armed spares until that rollout "
        "reclaims them",
    )
    r.add_argument(
        "--prestage-timeout", type=float, default=None,
        help="seconds to await the spares' pre-staged records before "
        "falling back to the full flip (default: --node-timeout)",
    )
    r.add_argument(
        "--prestage-continuous", action="store_true",
        help="whole-fleet zero-bounce: prestage upcoming REGULAR "
        "windows (wave N+1 arms while wave N flips) under a "
        "crash-journaled capacity ledger in the record (v7 — older "
        "binaries refuse it loudly). Concurrency is bounded by "
        "min(--prestage-knee-rps slack, max-unavailable); SLO burn "
        "pauses prestage (never the wave); a prestage failure "
        "downgrades that node to the full flip path. A resume of a "
        "ledgered record re-enables this automatically unless "
        "--no-prestage",
    )
    r.add_argument(
        "--no-prestage", action="store_true",
        help="degraded-mode escape hatch: disable continuous prestage "
        "even when resuming a record that carries a capacity ledger "
        "(its entries are invalidated and released on adoption; every "
        "node takes the full flip path — see docs/operations.md)",
    )
    r.add_argument(
        "--prestage-knee-rps", type=float, default=None,
        help="the serving pool's measured knee (hack/serve_bench.py "
        "--sweep): with --slo-source, the continuous-prestage headroom "
        "gate scrapes tpu_cc_serve_offered_rps and allows prestage "
        "only while offered load leaves whole nodes of slack under "
        "this knee (no knee or no source: allowance defaults to "
        "max-unavailable)",
    )
    r.add_argument(
        "--no-adopt", action="store_true",
        help="do NOT adopt nodes created mid-rollout (autoscaler "
        "scale-up) into a trailing wave; by default new selector-matching "
        "nodes receive the desired mode + generation label before the "
        "rollout reports done",
    )
    r.add_argument(
        "--no-informer", action="store_true",
        help="poll with full pool listings instead of the watch-driven "
        "informer cache (the pre-informer O(pool) behavior; the cache "
        "needs `watch nodes` RBAC, which the DaemonSet role grants)",
    )
    r.add_argument(
        "--resume", action="store_true",
        help="resume an interrupted rollout from the record checkpointed "
        "in the rollout lease (converged groups are never re-bounced; "
        "also auto-detected when an in-progress record matches this "
        "invocation)",
    )
    r.add_argument(
        "--abort", dest="abort_rollout", action="store_true",
        help="release the rollout lease and DISCARD the persisted record "
        "(the escape hatch for a dead orchestrator's leftovers; safe — "
        "node agents keep converging on whatever desired labels were "
        "already written). Refuses a LIVE holder unless --force is also "
        "given",
    )
    r.add_argument(
        "--force", action="store_true",
        help="with --abort: fence out a LIVE (wedged) holder — its next "
        "lease write is refused and it stops. Never use this to jump the "
        "queue past a healthy rollout",
    )
    r.add_argument(
        "--no-lease", action="store_true",
        help="run UNFENCED without the single-writer lease/record "
        "(legacy behavior: no crash resume, concurrent rollouts race)",
    )
    r.add_argument(
        "--lease-duration", type=float, default=None,
        help="rollout lease duration in seconds (default 15; a dead "
        "orchestrator's lease becomes claimable this long after its "
        "last renewal)",
    )
    r.add_argument(
        "--lease-namespace", default=None,
        help="namespace of the rollout lease (default: "
        "$CC_ROLLOUT_LEASE_NAMESPACE or tpu-operator)",
    )
    r.add_argument(
        "--flight-file", default=None,
        help="rollout flight-recorder JSONL path (default: a selector-"
        "derived file under $CC_FLIGHT_DIR, so a crash+--resume on the "
        "same host appends to the interrupted timeline; read it back "
        "with `rollout-timeline`)",
    )
    r.add_argument(
        "--no-flight", action="store_true",
        help="do not record the flight-recorder timeline",
    )
    r.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve the orchestrator's /metrics + /rolloutz (live "
        "flight-recorder snapshot) on this port for the rollout's "
        "duration (0 = off)",
    )
    r.add_argument(
        "--slo-max-burn-rate", type=float, default=None,
        help="SLO-paced rollout: pause the next wave while the serving "
        "pool's error-budget burn rate exceeds this (1.0 = spending "
        "exactly as provisioned); sustained burn halts like "
        "--failure-budget. Requires --slo-source. A --resume inherits "
        "the record's persisted gate when these flags are omitted",
    )
    r.add_argument(
        "--slo-p99-target-ms", type=float, default=None,
        help="SLO-paced rollout: also pause while the pool's windowed "
        "p99 latency exceeds this many milliseconds",
    )
    r.add_argument(
        "--slo-window", type=float, default=None,
        help="which exported SLO window (seconds) the gate judges "
        "(default: the fastest the pool exports)",
    )
    r.add_argument(
        "--slo-max-pause", type=float, default=None,
        help="pause budget in seconds: SLO burn sustained past this "
        "halts the rollout (default 300; on --resume an omitted flag "
        "keeps the record's persisted value)",
    )
    r.add_argument(
        "--slo-source", default=None,
        help="URL of the serving pool's /metrics exposition the SLO "
        "gate polls at wave boundaries (tpu_cc_serve_slo_p99_seconds / "
        "tpu_cc_serve_error_budget_burn)",
    )
    r.add_argument(
        "--regions", default=None,
        help="federated rollout: comma-separated region names "
        "(topology.kubernetes.io/region label values). One regional "
        "orchestrator shard per region, each with its own rollout "
        "lease and its own regional slice of ONE federated record; "
        "--failure-budget and --max-unavailable are GLOBAL (spent "
        "across all regions via the CAS-fenced parent record) unless "
        "given per-region overrides (see their help). "
        "'r1=ctx1,r2=ctx2' drives each region through a named "
        "kubeconfig context — a real multi-cluster federation, with "
        "the parent record on the default cluster. "
        "--resume resumes every region's slice; --abort force-aborts "
        "the whole federation (live shards self-fence on their next "
        "parent sync)",
    )

    tl = sub.add_parser(
        "rollout-timeline",
        help="render a rollout's flight-recorder timeline (obs/flight.py)"
        ": every orchestrator decision in order — plan, waves, windows, "
        "per-node outcomes, budget charges, halts, resumes — plus the "
        "exactly-once reconstruction; the answer to 'why did wave 3 "
        "halt', after the fact and across a crash+--resume",
    )
    tl.add_argument(
        "--selector", default=None,
        help="pool selector the rollout used (derives the default "
        "flight-file path, like `rollout` does)",
    )
    tl.add_argument(
        "--file", dest="flight_file", default=None,
        help="read this flight-recorder JSONL file instead of the "
        "selector-derived default",
    )
    tl.add_argument(
        "--stitch", nargs="+", default=None, metavar="FILE",
        help="stitch N shard/region flight files into one federated "
        "timeline (lease-generation then timestamp ordering, exact "
        "cross-stream duplicates collapsed, torn tails tolerated per "
        "stream) — the offline twin of the fleet gateway's "
        "/fleetz?rollout=",
    )
    tl.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print raw events + reconstruction as JSON",
    )
    tl.add_argument(
        "--trace", action="store_true",
        help="also render the stitched causal trace tree for the "
        "rollout's trace id, read from a span JSONL file (--spans; the "
        "CC_TRACE_FILE sink's format) — the offline twin of "
        "/tracez?trace_id=",
    )
    tl.add_argument(
        "--spans", default=None,
        help="span JSONL file (CC_TRACE_FILE format) to stitch --trace "
        "from; agents' and the orchestrator's sinks can be concatenated",
    )

    a = sub.add_parser("attest", help="verify cross-slice attestation coherence")
    a.add_argument("--selector", required=True)
    a.add_argument("--mode", required=True)
    a.add_argument("--slices", type=int, default=None, help="expected slice count")
    a.add_argument("--max-age", type=float, default=3600.0)
    a.add_argument(
        "--allow-fake", action="store_true",
        help="admit fake-platform quotes (HMAC, shared test key) — only "
        "for pools running the fake device layer",
    )
    a.add_argument(
        "--no-verify-signatures", action="store_true",
        help="digest-labels-only check (r4 behavior): trusts node-patch "
        "RBAC instead of platform signatures",
    )
    a.add_argument(
        "--challenge", action="store_true",
        help="challenged re-attestation: publish a fresh per-node nonce, "
        "wait for each agent to re-quote bound to it, then verify — a "
        "replayed quote that passes every signature check fails this "
        "path (without it, freshness rests on token exp only)",
    )
    a.add_argument(
        "--challenge-timeout", type=float, default=30.0,
        help="seconds to wait for agents to answer the challenge before "
        "verifying (unanswered nodes then fail verification)",
    )

    s = sub.add_parser("status", help="per-node CC state table")
    s.add_argument("--selector", required=True)
    s.add_argument(
        "--lease-namespace", default=None,
        help="where to look for the rollout lease (default: "
        "$CC_ROLLOUT_LEASE_NAMESPACE or tpu-operator) — pass the same "
        "value the rollout used or its ROLLOUT line stays invisible",
    )

    q = sub.add_parser(
        "quarantine",
        help="manually quarantine a node: NoSchedule taint + "
        "cc.quarantined label + ready.state=false; rollouts and pool "
        "attestation skip it (ccmanager/remediation.py)",
    )
    q.add_argument("--node", required=True)
    q.add_argument(
        "--reason", default="operator",
        help="recorded in the remediation annotation and node event",
    )

    uq = sub.add_parser(
        "unquarantine",
        help="lift a quarantine: remove the taint + label, restore "
        "ready.state from the current mode.state, reset the ladder",
    )
    uq.add_argument("--node", required=True)
    uq.add_argument("--reason", default="operator")

    jn = sub.add_parser(
        "journal",
        help="show a node's live intent journal (open hardware-transition "
        "intents, deferred label patches, last replay outcome) by reading "
        "the agent's /journalz debug endpoint — the first stop when a "
        "node rode out an apiserver outage (ccmanager/intent_journal.py)",
    )
    jn.add_argument("--node", default=None, help="node whose agent to query")
    jn.add_argument(
        "--port", type=int,
        default=int(os.environ.get("CC_METRICS_PORT") or 0) or 9099,
        help="agent metrics/debug port (default: $CC_METRICS_PORT or 9099)",
    )
    jn.add_argument(
        "--url", default=None,
        help="query this /journalz URL directly instead of resolving the "
        "node's address through the apiserver",
    )
    jn.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print the raw JSON payload instead of the summary view",
    )

    rb = sub.add_parser(
        "rbac-check",
        help="prove this identity holds every verb the agent needs "
        "(SelfSubjectAccessReview)",
    )
    rb.add_argument(
        "--namespace", default="tpu-operator",
        help="operator namespace for the pod-list check",
    )

    dsub = sub.add_parser(
        "drain-subscribe",
        help="sidecar: join the workload drain handshake without writing "
        "code — runs a checkpoint command when the node's manager "
        "requests a drain, then acks (drain/handshake.py)",
    )
    dsub.add_argument(
        "--job", required=True,
        help="job name for the subscriber label (label-sanitized)",
    )
    dsub.add_argument(
        "--node", default=None,
        help="node to watch (default: $NODE_NAME, the downward-API env "
        "every pod spec can set)",
    )
    dsub.add_argument(
        "--on-drain", required=True, metavar="CMD",
        help="shell command that durably checkpoints the job; exit 0 "
        "publishes the ack, non-zero is retried next poll",
    )
    dsub.add_argument(
        "--on-resume", default=None, metavar="CMD",
        help="optional shell command run when the drain request clears",
    )
    from tpu_cc_manager_torch.drain.handshake import DEFAULT_ACK_POLL_INTERVAL_S

    dsub.add_argument(
        "--poll-interval", type=float,
        default=DEFAULT_ACK_POLL_INTERVAL_S,
        help="seconds between node polls during a drain "
        "(idle polls back off 5x)",
    )
    return p


def _parse_regions(spec: str) -> tuple[list[str], dict[str, str]]:
    """``--regions`` syntax: ``r1,r2`` (shards over one cluster, region-
    sliced selectors) or ``r1=ctx1,r2=ctx2`` (one kubeconfig context per
    region — a real multi-cluster federation). All-or-nothing on the
    contexts: half a federation silently sharing the local cluster is
    exactly the mixup the explicit form exists to prevent."""
    regions: list[str] = []
    contexts: dict[str, str] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        region, sep, ctx = entry.partition("=")
        region = region.strip()
        if not region:
            raise ValueError(f"--regions: bad entry {entry!r}")
        regions.append(region)
        if sep:
            if not ctx.strip():
                raise ValueError(
                    f"--regions: empty kubeconfig context for {region!r}"
                )
            contexts[region] = ctx.strip()
    if len(regions) != len(set(regions)):
        raise ValueError("--regions: duplicate region names")
    if contexts and len(contexts) != len(regions):
        missing = sorted(set(regions) - set(contexts))
        raise ValueError(
            "--regions: kubeconfig contexts must be given for EVERY "
            f"region or none (missing: {', '.join(missing)})"
        )
    return regions, contexts


def _parse_per_region_int(
    spec: str | None, flag: str, regions: list[str],
) -> tuple[int | None, dict[str, int]]:
    """Per-region integer flag syntax (``--failure-budget``,
    ``--max-unavailable`` under ``--regions``): a bare ``N`` is the
    default for every region, ``r=N`` overrides one. Returns
    ``(default, per_region)``; unknown region names are refused."""
    if spec is None:
        return None, {}
    default: int | None = None
    per: dict[str, int] = {}
    for entry in str(spec).split(","):
        entry = entry.strip()
        if not entry:
            continue
        region, sep, value = entry.partition("=")
        if not sep:
            if default is not None:
                raise ValueError(f"{flag}: more than one bare value")
            default = int(entry)
            continue
        region = region.strip()
        if region not in regions:
            raise ValueError(
                f"{flag}: unknown region {region!r} (not in --regions)"
            )
        if region in per:
            raise ValueError(f"{flag}: duplicate region {region!r}")
        per[region] = int(value)
    return default, per


def _plain_int_flag(value, flag: str) -> int | None:
    """Non-federated rollouts take these flags as plain integers; the
    per-region ``r=N`` syntax only means something under ``--regions``."""
    if value is None or isinstance(value, int):
        return value
    if "=" in str(value) or "," in str(value):
        raise ValueError(
            f"{flag}: per-region syntax ({value!r}) requires --regions"
        )
    return int(value)


def _abort_rollout(api, namespace: str | None, force: bool = False) -> int:
    """Release the rollout lease and discard its record. Safe against the
    pool: desired labels already written stay written and the node agents
    keep converging on them — aborting only removes the orchestrator-side
    lock + checkpoint. The lease OBJECT is kept (holder emptied via CAS,
    not deleted) so ``leaseTransitions`` — the fencing generation — stays
    monotonic across the abort. A LIVE holder is refused without
    ``--force``: aborting a healthy rollout opens exactly the concurrent-
    writer window the lease exists to close."""
    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.kubeclient.api import KubeApiError

    namespace = namespace or rollout_state.lease_namespace()
    try:
        lease = api.get_lease(namespace, rollout_state.LEASE_NAME)
    except KubeApiError as e:
        if e.status == 404:
            print(f"no rollout lease in {namespace}; nothing to abort")
            return 0
        raise
    holder, alive = rollout_state.lease_holder_alive(lease)
    if alive and not force:
        log.error(
            "the rollout lease is held by a LIVE orchestrator (%s); "
            "aborting it would let two writers race the same pool. If it "
            "is wedged, re-run with --force (its next lease write is then "
            "refused and it stops); otherwise just wait", holder,
        )
        return 1
    rollout_state.release_lease(api, namespace, rollout_state.LEASE_NAME)
    print(
        f"rollout lease {namespace}/{rollout_state.LEASE_NAME} "
        + ("force-released (live holder fenced out)" if alive else "released")
        + "; persisted record discarded"
    )
    return 0


def cmd_rollout(api, args) -> int:
    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.kubeclient.api import KubeApiError, is_lease_unsupported
    from tpu_cc_manager_torch.labels import canonical_mode

    lease_namespace = getattr(args, "lease_namespace", None)
    if getattr(args, "regions", None):
        return _rollout_federated(api, args)
    if getattr(args, "abort_rollout", False):
        return _abort_rollout(
            api, lease_namespace, force=getattr(args, "force", False)
        )
    mode = canonical_mode(args.mode) if getattr(args, "mode", None) else None
    if mode is not None and mode not in VALID_MODES:
        # Fail BEFORE touching the lease: a typo'd mode must not leave a
        # held lease behind that blocks the corrected retry for a whole
        # lease duration.
        raise ValueError(f"invalid CC mode {mode!r} (valid: {VALID_MODES})")
    # Same pre-lease discipline for the flag syntax: the per-region
    # ``r=N`` form is only valid under --regions (handled above).
    args.failure_budget = _plain_int_flag(
        getattr(args, "failure_budget", None), "--failure-budget"
    )
    args.max_unavailable = _plain_int_flag(
        getattr(args, "max_unavailable", None), "--max-unavailable"
    )
    resume_requested = getattr(args, "resume", False)
    if resume_requested and getattr(args, "no_lease", False):
        # Contradictory: resume reads the record checkpointed in the
        # lease the other flag refuses to touch.
        raise ValueError("--resume cannot be combined with --no-lease")
    if getattr(args, "prestage_only", False):
        # Arm + await spare pre-staging and exit — writes only the surge
        # taint + prestage annotations (no desired-mode labels), is
        # idempotent, and touches no lease: the later --surge --prestage
        # rollout owns the fenced flip.
        if mode is None:
            raise ValueError("--prestage-only requires --mode")
        surge_n = getattr(args, "surge", None) or 0
        if surge_n <= 0:
            raise ValueError("--prestage-only requires --surge N")
        roller = RollingReconfigurator(
            api,
            args.selector,
            node_timeout_s=args.node_timeout,
            surge=surge_n,
            prestage=True,
            prestage_timeout_s=getattr(args, "prestage_timeout", None),
        )
        summary = roller.prestage_spares(mode)
        print(json.dumps(summary))
        return 0 if summary["ok"] else 1
    lease = None
    resume_record = None
    if not getattr(args, "no_lease", False):
        import os as _os
        import socket as _socket

        lease = rollout_state.RolloutLease(
            api,
            holder=f"{_socket.gethostname()}-{_os.getpid()}",
            namespace=lease_namespace,
            duration_s=(
                getattr(args, "lease_duration", None)
                or rollout_state.DEFAULT_LEASE_DURATION_S
            ),
        )
        try:
            record = lease.acquire()
        except rollout_state.LeaseHeld as e:
            log.error(
                "another rollout is already in progress: %s — wait for it "
                "to finish (or its lease to expire). Only if that holder "
                "is WEDGED: `tpu-cc-ctl rollout --abort --force` fences it "
                "out", e,
            )
            return 1
        except rollout_state.RolloutFenced as e:
            # An unreadable/corrupt checkpointed record (partial write,
            # manual edit): surface it cleanly with the escape hatch
            # instead of a traceback.
            log.error(
                "rollout record on the lease is unreadable (%s); "
                "`tpu-cc-ctl rollout --abort` discards it", e,
            )
            return 1
        except KubeApiError as e:
            if not is_lease_unsupported(e):
                log.error("could not acquire the rollout lease: %s", e)
                return 1
            if resume_requested:
                # An explicit --resume must not silently degrade into a
                # fresh unfenced rollout that re-plans from scratch.
                log.error(
                    "--resume: this client has no Lease support, so no "
                    "persisted record can be read"
                )
                return 2
            log.warning(
                "this client has no Lease support; running UNFENCED "
                "(no crash resume, concurrent rollouts race)"
            )
            lease = None
            record = None
        if record is not None:
            matches = record.selector == args.selector and (
                mode is None or record.mode == mode
            )
            if resume_requested:
                if record.status == rollout_state.RECORD_COMPLETE:
                    log.error(
                        "--resume: the persisted rollout already completed; "
                        "start a fresh rollout (or --abort to clear)"
                    )
                    lease.release()
                    return 2
                if not matches:
                    log.error(
                        "--resume: persisted record (mode=%s selector=%s) "
                        "does not match this invocation", record.mode,
                        record.selector,
                    )
                    lease.release()
                    return 2
                resume_record = record
            elif record.status == rollout_state.RECORD_IN_PROGRESS:
                # Auto-detect a dead orchestrator's unfinished rollout: a
                # matching invocation resumes it; a mismatched one must
                # not silently bulldoze a half-flipped pool.
                if matches:
                    log.warning(
                        "found an in-progress rollout record from a dead "
                        "orchestrator; resuming it (use --abort to discard)"
                    )
                    resume_record = record
                else:
                    log.error(
                        "an unfinished rollout record exists (mode=%s "
                        "selector=%s, %d/%d groups done) and does not match "
                        "this invocation — resume it with matching "
                        "arguments, or --abort to discard it",
                        record.mode, record.selector,
                        sum(1 for d in record.done.values() if d.get("ok")),
                        len(record.groups),
                    )
                    lease.release()
                    return 2
        elif resume_requested and lease is not None:
            log.error("--resume: no persisted rollout record found")
            lease.release()
            return 2
    federation_gate = None
    if resume_record is not None and resume_record.federation:
        # A regional slice of a MULTI-region federation: the successor
        # must re-attach to the parent record (global budget, fencing
        # generation) before touching a node — resuming it unfenced
        # would spend budget the siblings never see. Single-region
        # federated records persist as <=v4 and never reach here.
        from tpu_cc_manager_torch.ccmanager import federation as federation_mod

        try:
            federation_gate = federation_mod.FederationGate.from_record_dict(
                api, resume_record.federation
            )
        except rollout_state.RolloutFenced as e:
            log.error(
                "resume: this record is a regional slice of a federated "
                "rollout and its parent refused the attachment (%s); "
                "`rollout --abort` discards the regional record", e,
            )
            lease.release()
            return 1
        log.warning(
            "resume: regional slice of a federated rollout (region %s of "
            "%d); re-attached to the parent record",
            federation_gate.region, federation_gate.regions_total,
        )
    failure_budget = getattr(args, "failure_budget", None)
    # None = flag omitted (the parser's default), distinguishable from an
    # explicit `--max-unavailable 1`.
    max_unavailable = getattr(args, "max_unavailable", None)
    wave_shards = getattr(args, "wave_shards", None)
    surge = getattr(args, "surge", None)
    if resume_record is not None:
        mode = resume_record.mode
        # The record also carries the dead orchestrator's settings: a
        # resume that wasn't explicitly re-parameterized must keep them —
        # above all the failure budget, or the fleet-level circuit
        # breaker (and its persisted pre-crash spend) silently vanishes
        # on resume. An explicitly-passed flag still wins.
        if failure_budget is None:
            failure_budget = resume_record.failure_budget
        if max_unavailable is None:
            max_unavailable = resume_record.max_unavailable
        if wave_shards is None:
            wave_shards = resume_record.wave_shards
        if surge is None:
            surge = resume_record.surge
    if max_unavailable is None:
        max_unavailable = 1
    if wave_shards is None:
        wave_shards = 1
    if surge is None:
        surge = 0
    # SLO-paced rollout: flags build the gate config. A --resume starts
    # from the gate persisted in the record (a latency-gated rollout
    # must stay latency-gated across a crash) and overlays any flags
    # explicitly passed — so `--resume --slo-max-pause 600` extends the
    # pause budget instead of being silently dropped.
    from tpu_cc_manager_torch.ccmanager.rolling import SloGateConfig, metrics_gate

    slo_flag_values = {
        name: getattr(args, name, None)
        for name in (
            "slo_max_burn_rate", "slo_p99_target_ms", "slo_window",
            "slo_max_pause", "slo_source",
        )
    }
    slo_flags_given = any(v is not None for v in slo_flag_values.values())
    slo_config = None
    if resume_record is not None and resume_record.slo_gate:
        slo_config = SloGateConfig.from_dict(resume_record.slo_gate)
        if slo_flag_values["slo_max_burn_rate"] is not None:
            slo_config.max_burn_rate = slo_flag_values["slo_max_burn_rate"]
        if slo_flag_values["slo_p99_target_ms"] is not None:
            slo_config.p99_target_ms = slo_flag_values["slo_p99_target_ms"]
        if slo_flag_values["slo_window"] is not None:
            slo_config.window_s = slo_flag_values["slo_window"]
        if slo_flag_values["slo_max_pause"] is not None:
            slo_config.max_pause_s = slo_flag_values["slo_max_pause"]
        if slo_flag_values["slo_source"] is not None:
            slo_config.source = slo_flag_values["slo_source"]
        log.warning(
            "resume: re-arming the persisted SLO gate (burn<=%s, "
            "p99<=%sms, source=%s)",
            slo_config.max_burn_rate, slo_config.p99_target_ms,
            slo_config.source,
        )
    elif slo_flags_given:
        slo_config = SloGateConfig(
            max_burn_rate=(
                slo_flag_values["slo_max_burn_rate"]
                if slo_flag_values["slo_max_burn_rate"] is not None
                else 1.0
            ),
            p99_target_ms=slo_flag_values["slo_p99_target_ms"],
            window_s=slo_flag_values["slo_window"],
            max_pause_s=(
                slo_flag_values["slo_max_pause"]
                if slo_flag_values["slo_max_pause"] is not None else 300.0
            ),
            source=slo_flag_values["slo_source"],
        )
        if not slo_config.source:
            if lease is not None:
                lease.release()
            raise ValueError(
                "SLO gate flags need --slo-source (the serving pool's "
                "/metrics URL the gate polls)"
            )
    slo_gate = None
    if slo_config is not None:
        if not slo_config.source:
            # A record persisted by an in-process gate (ServeHarness)
            # has no pollable source; resuming from ctl cannot rebuild
            # the callable — say so instead of silently ungating.
            if lease is not None:
                lease.release()
            raise ValueError(
                "persisted SLO gate has no metrics source; re-run with "
                "--slo-source (or --abort to discard the record)"
            )
        slo_gate = metrics_gate(slo_config)
    # Continuous prestage (record v7 capacity ledger): the explicit
    # flag, or inherited on --resume from a record that carries a
    # ledger — a ledgered rollout must stay ledgered across a crash
    # (its checkpointed entries need adoption), unless the operator
    # degrades it deliberately with --no-prestage.
    continuous_prestage = getattr(args, "prestage_continuous", False)
    if getattr(args, "no_prestage", False):
        if continuous_prestage:
            if lease is not None:
                lease.release()
            raise ValueError(
                "--prestage-continuous and --no-prestage are "
                "contradictory"
            )
        if (
            resume_record is not None
            and resume_record.ledger is not None
            and resume_record.ledger.entries
        ):
            log.warning(
                "resume: --no-prestage on a ledgered record — its %d "
                "prestage entr(ies) will be released and every node "
                "takes the full flip path",
                len(resume_record.ledger.entries),
            )
    elif (
        not continuous_prestage
        and resume_record is not None
        and resume_record.ledger is not None
    ):
        continuous_prestage = True
        log.warning(
            "resume: the record carries a capacity ledger (%d live "
            "entr(ies)); re-enabling continuous prestage "
            "(--no-prestage to degrade)",
            len(resume_record.ledger.entries),
        )
    prestage_knee_rps = getattr(args, "prestage_knee_rps", None)
    if prestage_knee_rps and not continuous_prestage:
        if lease is not None:
            lease.release()
        raise ValueError(
            "--prestage-knee-rps needs --prestage-continuous (or a "
            "--resume of a ledgered record)"
        )
    if (
        continuous_prestage and prestage_knee_rps
        and (slo_config is None or not slo_config.source)
    ):
        if lease is not None:
            lease.release()
        raise ValueError(
            "--prestage-knee-rps needs --slo-source (the serving "
            "pool's /metrics URL the headroom gate scrapes for "
            "tpu_cc_serve_offered_rps)"
        )
    if mode is None:
        if lease is not None:
            lease.release()
        raise ValueError("--mode is required (unless --resume)")
    # Flight recorder: on by default (an appended JSONL line per
    # decision costs nothing next to an apiserver round trip), at a
    # selector-derived path so a --resume finds the interrupted
    # timeline without flag plumbing.
    from tpu_cc_manager_torch.obs import flight as flight_mod

    flight = None
    if not getattr(args, "no_flight", False):
        flight = flight_mod.FlightRecorder(
            getattr(args, "flight_file", None)
            or flight_mod.flight_path_for(args.selector),
            generation=lease.generation if lease is not None else None,
        )
        if lease is not None:
            flight.record(
                flight_mod.EVENT_LEASE_ACQUIRED,
                holder=lease.holder,
                resumed=resume_record is not None or None,
            )
    metrics_server = None
    metrics_port = getattr(args, "metrics_port", 0)
    if lease is not None:
        lease.start_renewer()
    informer = None
    try:
        # Inside the try on purpose (metrics server AND informer): a
        # bind failure (port in use) or a client whose watch connect
        # raises eagerly (not the lazy "unsupported" probe) must hit
        # the BaseException lease-release below — failing BEFORE the
        # try would strand a held lease with the renewer still running,
        # and every later invocation would be refused with LeaseHeld
        # until the process dies.
        if metrics_port:
            from tpu_cc_manager_torch.ccmanager.metrics_server import (
                start_metrics_server,
            )
            from tpu_cc_manager_torch.utils import metrics as metrics_mod

            metrics_server = start_metrics_server(
                metrics_port, metrics_mod.REGISTRY, flight=flight,
            )
        if not getattr(args, "no_informer", False):
            from tpu_cc_manager_torch.ccmanager.informer import NodeInformer
            from tpu_cc_manager_torch.kubeclient.api import (
                is_pool_watch_unsupported,
            )

            try:
                informer = NodeInformer(api, args.selector).start()
            except KubeApiError as e:
                if not is_pool_watch_unsupported(e):
                    raise
                log.warning(
                    "this client has no pool-watch support; the rollout "
                    "falls back to O(pool) polling listings"
                )
                informer = None
        headroom_gate = None
        if continuous_prestage and prestage_knee_rps:
            # Whole-node slack under the measured knee, judged from the
            # pool's live offered-rate gauge. The node count is the
            # live selector population (a gate call is one scrape; the
            # count is re-read so autoscaling doesn't skew the slack).
            from tpu_cc_manager_torch.ccmanager.rolling import (
                headroom_gate_from_source,
            )

            n_nodes = max(1, len(api.list_nodes(args.selector)))
            headroom_gate = headroom_gate_from_source(
                slo_config.source, prestage_knee_rps, n_nodes,
            )
        roller = RollingReconfigurator(
            api,
            args.selector,
            max_unavailable=max_unavailable,
            node_timeout_s=args.node_timeout,
            continue_on_failure=args.continue_on_failure,
            rollback_on_failure=args.rollback_on_failure,
            failure_budget=failure_budget,
            lease=lease,
            resume_record=resume_record,
            informer=informer,
            wave_shards=wave_shards,
            surge=surge,
            prestage=getattr(args, "prestage", False),
            prestage_timeout_s=getattr(args, "prestage_timeout", None),
            continuous_prestage=continuous_prestage,
            headroom_gate=headroom_gate,
            adopt_new_nodes=not getattr(args, "no_adopt", False),
            flight=flight,
            slo_gate=slo_gate,
            slo_config=slo_config,
            federation=federation_gate,
        )
        result = roller.rollout(mode)
    except rollout_state.RolloutFenced as e:
        log.error(
            "rollout fenced out mid-flight (%s); a successor owns the pool "
            "now — this process wrote nothing after losing the lease", e,
        )
        if flight is not None:
            flight.record(flight_mod.EVENT_FENCED, error=str(e))
        return 1
    except BaseException:
        # Any unexpected failure (usage error, apiserver crash mid-plan,
        # Ctrl-C) must not strand a held lease that blocks the corrected
        # retry for a whole lease duration; the checkpointed record (if
        # any) survives the release for --resume.
        if lease is not None:
            lease.release()
        raise
    finally:
        if informer is not None:
            informer.stop()
        if lease is not None:
            lease.stop_renewer()
        if metrics_server is not None:
            metrics_server.shutdown()
    if lease is not None:
        # A finished rollout clears its record (nothing to resume); a
        # failed/halted one keeps it so `--resume` can pick up after the
        # operator intervenes — either way the lease itself is released
        # so the next orchestrator need not wait out the duration.
        lease.release(clear_record=result.ok)
    print(json.dumps(result.summary()))
    return 0 if result.ok else 1


def _abort_federated(
    api, store, regions, region_apis, lease_namespace,
    federation_mod, rollout_state,
) -> int:
    """``rollout --regions ... --abort``: discard the parent record (live
    shards self-fence at their next sync) and force-release every
    regional lease. Partition-hardened on purpose: a corrupt parent is
    entombed, not a traceback, and a transport error against the parent
    plane must NOT strand the regional leases — they are released
    regardless, each on its own cluster when per-region contexts are in
    play."""
    from tpu_cc_manager_torch.kubeclient.api import KubeApiError

    known_regions = set(regions)
    aborted = None
    unreadable = False
    parent_error: Exception | None = None
    try:
        parent = store.load()
    except federation_mod.ParentUnreadable as e:
        log.warning(
            "--abort --regions: parent record unreadable (%s); "
            "discarding it", e,
        )
        parent = None
        unreadable = True
    except KubeApiError as e:
        parent = None
        parent_error = e
    if parent is not None:
        known_regions |= set(parent.regions)
    if parent is None and not unreadable and parent_error is None:
        log.error("--abort --regions: no federated parent record")
        return 1
    if parent_error is None:
        try:
            aborted = store.abort()
        except KubeApiError as e:
            parent_error = e
    released: list[str] = []
    for region in sorted(known_regions):
        try:
            rollout_state.release_lease(
                region_apis.get(region, api),
                lease_namespace or rollout_state.lease_namespace(),
                name=federation_mod.regional_lease_name(region),
            )
            released.append(region)
        except KubeApiError as e:
            log.warning(
                "--abort --regions: could not release the %s regional "
                "lease (%s); it expires on its own after the lease "
                "duration", region, e,
            )
    if parent_error is not None:
        log.error(
            "--abort --regions: the parent plane is unreachable (%s). "
            "Regional leases released: %s. Re-run --abort once the "
            "parent apiserver is back so live shards fence at their "
            "next sync", parent_error, ", ".join(released) or "none",
        )
        return 1
    if aborted is None:
        log.error("--abort --regions: abort did not complete")
        return 1
    log.warning(
        "federated rollout aborted (generation now %d); every live "
        "shard is fenced at its next parent sync", aborted.generation,
    )
    return 0


def _rollout_federated(api, args) -> int:
    """``rollout --regions r1,r2,...``: one regional orchestrator shard
    per region (own lease, own flight file, own regional slice of the
    pool via the topology region label), federated under ONE parent
    record carrying the global plan digest and the single global
    failure budget / max-unavailable. Shards run as threads here; at
    fleet scale each shard is its own process against its own regional
    apiserver (hack/scale_bench.py --federation) — the parent-record
    protocol is identical."""
    import os as _os
    import socket as _socket
    import threading as _threading

    from tpu_cc_manager_torch.ccmanager import federation as federation_mod
    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.labels import canonical_mode
    from tpu_cc_manager_torch.obs import flight as flight_mod

    regions, region_contexts = _parse_regions(args.regions)
    if getattr(args, "no_lease", False):
        raise ValueError(
            "--regions cannot run --no-lease: the federation IS the "
            "fencing hierarchy"
        )
    lease_namespace = getattr(args, "lease_namespace", None)
    # Per-region kubeconfig contexts: each shard drives ITS cluster while
    # the parent record stays on the default one — the coordination plane
    # and the data planes are different apiservers, which is exactly the
    # partition SCALE_r04 drills.
    region_apis: dict[str, object] = {}
    if region_contexts:
        from tpu_cc_manager_torch.kubeclient.rest import ClusterConfig, RestKube

        for region, ctx in region_contexts.items():
            region_apis[region] = RestKube(
                ClusterConfig.load(args.kubeconfig, context=ctx)
            )
    store = federation_mod.ParentStore(api, namespace=lease_namespace)
    if getattr(args, "abort_rollout", False):
        return _abort_federated(
            api, store, regions, region_apis, lease_namespace,
            federation_mod, rollout_state,
        )
    mode = canonical_mode(args.mode) if getattr(args, "mode", None) else None
    if mode is not None and mode not in VALID_MODES:
        raise ValueError(f"invalid CC mode {mode!r} (valid: {VALID_MODES})")
    resume_requested = getattr(args, "resume", False)
    fb_default, region_budgets = _parse_per_region_int(
        getattr(args, "failure_budget", None), "--failure-budget", regions
    )
    if region_budgets and fb_default is not None:
        # '3,r2=5' is ambiguous — is the global budget 3, or the sum?
        # Heterogeneous budgets name every region; the global is their
        # sum by construction.
        raise ValueError(
            "--failure-budget: cannot mix a bare global value with "
            "per-region budgets"
        )
    if region_budgets and set(region_budgets) != set(regions):
        missing = sorted(set(regions) - set(region_budgets))
        raise ValueError(
            "--failure-budget: per-region budgets must name EVERY "
            f"region (missing: {', '.join(missing)})"
        )
    failure_budget = (
        sum(region_budgets.values()) if region_budgets else fb_default
    )
    mu_default, region_max_unavailable = _parse_per_region_int(
        getattr(args, "max_unavailable", None), "--max-unavailable", regions
    )
    max_unavailable = mu_default
    flags_budget_given = getattr(args, "failure_budget", None) is not None
    flags_mu_given = getattr(args, "max_unavailable", None) is not None
    if resume_requested:
        existing = store.load()
        if existing is None:
            log.error("--resume --regions: no federated parent record")
            return 2
        # The parent carries the dead federation's settings; explicit
        # flags still win (same inheritance rule as a regional resume).
        mode = mode or existing.mode
        if not flags_budget_given:
            failure_budget = existing.failure_budget
            region_budgets = dict(existing.region_budgets)
        if not flags_mu_given:
            max_unavailable = existing.max_unavailable
            region_max_unavailable = dict(existing.region_max_unavailable)
    if mode is None:
        raise ValueError("--mode is required (unless --resume)")
    if max_unavailable is None:
        max_unavailable = 1
    parent = store.initialize(
        federation_mod.ParentRecord.fresh(
            mode, args.selector, regions,
            max_unavailable=max_unavailable,
            failure_budget=failure_budget,
            region_budgets=region_budgets or None,
            region_max_unavailable=region_max_unavailable or None,
        ),
        resume=resume_requested,
    )
    results: dict[str, object] = {}
    errors: dict[str, BaseException] = {}
    flight_files: dict[str, str] = {}

    def run_region(region: str) -> None:
        rapi = region_apis.get(region, api)
        # With a per-region cluster the WHOLE pool there belongs to the
        # region — slicing by the topology label would select nothing on
        # clusters that don't stamp it.
        regional_selector = (
            args.selector if region in region_apis
            else federation_mod.regional_selector(args.selector, region)
        )
        lease = rollout_state.RolloutLease(
            rapi,
            holder=f"{_socket.gethostname()}-{_os.getpid()}-{region}",
            namespace=lease_namespace,
            name=federation_mod.regional_lease_name(region),
            duration_s=(
                getattr(args, "lease_duration", None)
                or rollout_state.DEFAULT_LEASE_DURATION_S
            ),
        )
        try:
            record = lease.acquire()
        except (rollout_state.LeaseHeld, rollout_state.RolloutFenced) as e:
            log.error("region %s: cannot acquire regional lease: %s",
                      region, e)
            results[region] = None
            return
        resume_record = None
        if record is not None and (
            record.status == rollout_state.RECORD_IN_PROGRESS
            or (resume_requested
                and record.status == rollout_state.RECORD_HALTED)
        ):
            fed = record.federation or {}
            if fed.get("digest") and fed["digest"] != parent.digest:
                log.error(
                    "region %s: regional record belongs to a different "
                    "federation (digest %s != %s); abort it first",
                    region, fed["digest"], parent.digest,
                )
                lease.release()
                results[region] = None
                return
            resume_record = record
        gate = federation_mod.FederationGate(store, region)
        try:
            gate.attach(parent)
        except rollout_state.RolloutFenced as e:
            log.error(
                "region %s: parent refused the attachment (%s)", region, e,
            )
            lease.release()
            results[region] = None
            return
        flight = None
        if not getattr(args, "no_flight", False):
            flight = flight_mod.FlightRecorder(
                getattr(args, "flight_file", None)
                and f"{args.flight_file}.{region}"
                or flight_mod.flight_path_for(regional_selector),
                generation=lease.generation,
            )
            flight_files[region] = flight.path
            flight.record(
                flight_mod.EVENT_LEASE_ACQUIRED, holder=lease.holder,
                region=region, resumed=resume_record is not None or None,
            )
        lease.start_renewer()
        result = None
        try:
            roller = RollingReconfigurator(
                rapi,
                regional_selector,
                max_unavailable=region_max_unavailable.get(
                    region, max_unavailable
                ),
                node_timeout_s=args.node_timeout,
                continue_on_failure=args.continue_on_failure,
                rollback_on_failure=args.rollback_on_failure,
                # The GLOBAL budget: a region's own cap (region_budgets)
                # is enforced by the gate at every parent sync, so one
                # blown region halts alone while the federation's total
                # spend still stops everyone.
                failure_budget=failure_budget,
                lease=lease,
                resume_record=resume_record,
                flight=flight,
                federation=gate,
            )
            result = roller.rollout(mode)
            results[region] = result
        except rollout_state.RolloutFenced as e:
            log.error(
                "region %s: shard fenced out mid-flight (%s); it wrote "
                "nothing after losing its fence", region, e,
            )
            if flight is not None:
                flight.record(
                    flight_mod.EVENT_FENCED, error=str(e), region=region
                )
            results[region] = None
        except BaseException as e:  # noqa: BLE001  # cclint: crash-ok(shard thread trampoline: the exception is stashed in `errors` and re-raised verbatim in the caller after join — a modeled SIGKILL still escapes through that re-raise)
            errors[region] = e
            results[region] = None
        finally:
            lease.stop_renewer()
            lease.release(
                clear_record=result is not None and result.ok
            )

    threads = [
        _threading.Thread(
            target=run_region, args=(region,),
            name=f"federation-{region}", daemon=True,
        )
        for region in regions
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        region, error = sorted(errors.items())[0]
        log.error("region %s shard died: %s", region, error)
        raise error
    final = store.load()
    ok = (
        final is not None
        and final.status == federation_mod.PARENT_COMPLETE
        and all(
            getattr(r, "ok", False) for r in results.values()
        )
    )
    if final is not None:
        print(federation_mod.describe_parent(final), file=sys.stderr)
    print(json.dumps({
        "ok": ok,
        "mode": mode,
        "regions": {
            region: (r.summary() if r is not None else None)
            for region, r in sorted(results.items())
        },
        "parent_status": final.status if final is not None else None,
        "budget_spend": len(final.budget_spend) if final is not None else 0,
        "flight_files": dict(sorted(flight_files.items())),
    }))
    return 0 if ok else 1


def cmd_rollout_timeline(api, args) -> int:
    """Render a rollout flight-recorder timeline (obs/flight.py): the
    raw decision stream in order plus the exactly-once reconstruction —
    and, with ``--trace``, the stitched orchestrator→agents span tree
    read from a CC_TRACE_FILE-format span JSONL."""
    from tpu_cc_manager_torch.obs import flight as flight_mod

    stitch = getattr(args, "stitch", None)
    if stitch:
        events, torn = flight_mod.stitch_files(list(stitch))
        path = "+".join(stitch)
    else:
        path = getattr(args, "flight_file", None)
        if not path:
            if not getattr(args, "selector", None):
                raise ValueError(
                    "rollout-timeline: --selector (to derive the default "
                    "flight-file path) or --file is required"
                )
            path = flight_mod.flight_path_for(args.selector)
        events, torn = flight_mod.read_events(path)
    if not events:
        log.error("no flight-recorder events in %s", path)
        return 1
    if getattr(args, "as_json", False):
        print(json.dumps({
            "path": path,
            "torn_lines": torn,
            "events": events,
            "reconstruction": flight_mod.reconstruct(events),
        }, indent=1))
        return 0
    print(f"flight recorder: {path} ({len(events)} event(s))")
    print(flight_mod.render_timeline(events, torn=torn))
    if getattr(args, "trace", False):
        trace_ids = sorted({
            e["trace_id"] for e in events if e.get("trace_id")
        })
        print(f"\nrollout trace id(s): {', '.join(trace_ids) or '-'}")
        spans_path = getattr(args, "spans", None)
        if not spans_path:
            print(
                "(pass --spans <CC_TRACE_FILE jsonl> to render the "
                "stitched orchestrator->agent span tree offline, or "
                "query /tracez?trace_id=<id> on a live agent)"
            )
            return 0
        _print_stitched_trace(spans_path, trace_ids)
    return 0


def _print_stitched_trace(spans_path: str, trace_ids: list[str]) -> None:
    """Nest every span of the rollout's trace(s) from a span JSONL file
    (the CC_TRACE_FILE sink format; agent + orchestrator files can be
    concatenated) and print the tree — `ctl rollout` down through each
    node's drain/reset/smoke."""
    from tpu_cc_manager_torch.obs.journal import Journal

    spans: list[dict] = []
    with open(spans_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                s = json.loads(line)
            except ValueError:
                continue
            if isinstance(s, dict) and s.get("trace_id") in trace_ids:
                spans.append(s)
    if not spans:
        print(f"no spans for trace(s) {trace_ids} in {spans_path}")
        return
    journal = Journal(trace_file="")

    def render(node: dict, depth: int) -> None:
        attrs = node.get("attributes") or {}
        where = attrs.get("node") or attrs.get("group") or ""
        print(
            "  " * depth
            + f"{node['name']} ({node.get('seconds', 0):.3f}s, "
            f"{node.get('status')})" + (f" [{where}]" if where else "")
        )
        for child in sorted(
            node.get("children", []), key=lambda c: c.get("start_ts") or 0
        ):
            render(child, depth + 1)

    for root in sorted(
        journal.span_tree(spans), key=lambda r: r.get("start_ts") or 0
    ):
        render(root, 0)


def cmd_quarantine(api, args) -> int:
    from tpu_cc_manager_torch.ccmanager.remediation import RemediationLadder

    ladder = RemediationLadder(api, args.node)
    if ladder.quarantined:
        print(f"{args.node}: already quarantined")
        return 0
    ladder.quarantine(reason=args.reason, manual=True)
    print(f"{args.node}: quarantined ({args.reason})")
    return 0


def cmd_unquarantine(api, args) -> int:
    from tpu_cc_manager_torch.ccmanager.remediation import RemediationLadder

    ladder = RemediationLadder(api, args.node)
    ladder.unquarantine(reason=args.reason)
    print(f"{args.node}: quarantine lifted ({args.reason})")
    return 0


def cmd_attest(api, args) -> int:
    challenges = None
    if getattr(args, "challenge", False) and getattr(
        args, "no_verify_signatures", False
    ):
        # Contradictory: challenge binding is checked inside the
        # signed quote, which this flag says not to read — reporting
        # "(challenged re-attestation)" over a digest-labels-only
        # check would claim replay protection that never ran.
        raise ValueError(
            "--challenge cannot be combined with "
            "--no-verify-signatures (the challenge is verified "
            "inside the signed quote)"
        )
    # One informer serves every membership read below (challenge fan-out,
    # answer-await, report, verification) — the answer-await especially
    # used to cost one O(pool) listing per poll tick. Clients without
    # pool-watch support fall back to the legacy listing path.
    informer = None
    from tpu_cc_manager_torch.ccmanager.informer import NodeInformer
    from tpu_cc_manager_torch.kubeclient.api import (
        KubeApiError,
        is_pool_watch_unsupported,
    )

    try:
        informer = NodeInformer(api, args.selector).start()
    except KubeApiError as e:
        if not is_pool_watch_unsupported(e):
            raise
        informer = None
    try:
        if getattr(args, "challenge", False):
            from tpu_cc_manager_torch.ccmanager import multislice

            challenges = multislice.issue_pool_challenges(
                api, args.selector, informer=informer
            )
            pending = multislice.await_challenge_answers(
                api, args.selector, challenges,
                timeout_s=getattr(args, "challenge_timeout", 30.0),
                informer=informer,
            )
            if pending:
                # Not fatal here: verification below fails the unanswered
                # nodes with the precise per-node problem.
                print(
                    f"WARN: challenge unanswered by: {', '.join(pending)}"
                )
        print(pool_report(api, args.selector, informer=informer))
        try:
            verify_pool_attestation(
                api, args.selector, args.mode,
                expected_slices=args.slices, max_age_s=args.max_age,
                allow_fake=getattr(args, "allow_fake", False),
                verify_signatures=not getattr(
                    args, "no_verify_signatures", False
                ),
                challenges=challenges,
                informer=informer,
            )
        except PoolAttestationError as e:
            print(f"FAIL: {e}")
            return 1
    finally:
        if informer is not None:
            informer.stop()
    print(
        "OK: pool attestation coherent"
        + (" (challenged re-attestation)" if challenges else "")
    )
    return 0


def _rollout_status_line(api, namespace: str | None = None) -> str | None:
    """The active/resumable rollout, from the lease + checkpointed record
    (None when there is no lease or the client lacks Lease support)."""
    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.kubeclient.api import KubeApiError

    try:
        lease = api.get_lease(
            namespace or rollout_state.lease_namespace(),
            rollout_state.LEASE_NAME,
        )
    except KubeApiError:
        return None
    try:
        record = rollout_state.record_of_lease(lease)
    except rollout_state.RolloutFenced:
        record = "unreadable"  # still worth showing: --abort clears it
    if record is None and not (lease.get("spec") or {}).get("holderIdentity"):
        # A released, record-less lease is just the leftover object of a
        # finished rollout — nothing active or resumable to report.
        return None
    return rollout_state.describe_lease(lease)


def _prestage_status_line(api, namespace: str | None = None) -> str | None:
    """The capacity-ledger block for a ledgered record: per-state entry
    counts plus the charge/release balance — the first read of the
    continuous-prestage degraded-mode runbook (docs/operations.md
    "Continuous prestage & the capacity ledger")."""
    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.kubeclient.api import KubeApiError

    try:
        lease = api.get_lease(
            namespace or rollout_state.lease_namespace(),
            rollout_state.LEASE_NAME,
        )
        record = rollout_state.record_of_lease(lease)
    except (KubeApiError, rollout_state.RolloutFenced):
        return None
    if (
        record is None
        or record.ledger is None
        or not record.ledger.touched()
    ):
        return None
    led = record.ledger
    by_state: dict[str, int] = {}
    for e in led.entries.values():
        s = str(e.get("state"))
        by_state[s] = by_state.get(s, 0) + 1
    line = (
        "PRESTAGE ledger: "
        f"{by_state.get(rollout_state.LEDGER_RESERVED, 0)} reserved, "
        f"{by_state.get(rollout_state.LEDGER_ARMED, 0)} armed, "
        f"{by_state.get(rollout_state.LEDGER_HELD, 0)} held; "
        f"charges={led.charges_total()} releases={led.releases_total()} "
        f"({'balanced' if led.balanced() else 'UNBALANCED'})"
    )
    if not led.balanced():
        line += " — resume with --no-prestage to drain"
    return line


def cmd_status(api, args) -> int:
    from tpu_cc_manager_torch import labels as labels_mod
    from tpu_cc_manager_torch.ccmanager import remediation as remediation_mod
    from tpu_cc_manager_torch.ccmanager.rollout_state import ROLLOUT_GEN_LABEL
    from tpu_cc_manager_torch.ccmanager.slicecoord import (
        SLICE_COMMIT_LABEL,
        SLICE_FENCE_LABEL,
        SLICE_STAGED_LABEL,
    )
    from tpu_cc_manager_torch.drain import handshake
    from tpu_cc_manager_torch.kubeclient.api import node_annotations
    from tpu_cc_manager_torch.labels import CC_FAILED_REASON_LABEL

    rollout_line = _rollout_status_line(
        api, getattr(args, "lease_namespace", None)
    )
    if rollout_line:
        print(rollout_line)
        prestage_line = _prestage_status_line(
            api, getattr(args, "lease_namespace", None)
        )
        if prestage_line:
            print(prestage_line)
    # Federated rollouts: when a parent record exists, show the global
    # view (per-region status + escrow balances, global budget spend,
    # last-sync staleness) above the node table — the first thing to
    # read when one region looks stuck or the parent plane was dark.
    try:
        from tpu_cc_manager_torch.ccmanager import federation as federation_mod

        try:
            parent = federation_mod.ParentStore(
                api, namespace=getattr(args, "lease_namespace", None)
            ).load()
        except federation_mod.ParentUnreadable as e:
            # A corrupt parent must read as an actionable line, not a
            # traceback or a silently missing block.
            print(
                "FEDERATION parent record UNREADABLE "
                f"({e}); `tpu-cc-ctl rollout --regions ... --abort` "
                "discards it"
            )
            parent = None
        if parent is not None:
            print(federation_mod.describe_parent(parent))
    except Exception as e:  # noqa: BLE001 - status stays best-effort
        log.debug("federated parent record unreadable: %s", e)
    rows = [
        f"{'NODE':<24} {'SLICE':<20} {'DESIRED':<10} {'STATE':<10} "
        f"{'READY':<6} {'SUSPECT':<8} {'TRACE':<17} NOTE"
    ]
    for node in api.list_nodes(args.selector):
        labels = node_labels(node)
        # The last reconcile's trace id, republished by the agent into
        # the node annotation — the jump-off point from status to
        # /tracez?trace_id=<TRACE> on that node's agent.
        trace = node_annotations(node).get(
            labels_mod.TRACE_ID_ANNOTATION
        ) or "-"
        # Transient barrier markers / failure reason / remediation ladder:
        # the things an operator staring at a stuck rollout needs first.
        notes = []
        ladder = remediation_mod.describe_annotation(
            node_annotations(node).get(remediation_mod.REMEDIATION_ANNOTATION)
        )
        if ladder:
            notes.append(ladder)
        if labels.get(SLICE_STAGED_LABEL):
            notes.append(f"barrier:staged={labels[SLICE_STAGED_LABEL]}")
        if labels.get(SLICE_COMMIT_LABEL):
            notes.append(f"barrier:commit={labels[SLICE_COMMIT_LABEL]}")
        if labels.get(SLICE_FENCE_LABEL):
            notes.append(f"barrier:fence-gen={labels[SLICE_FENCE_LABEL]}")
        if labels.get(CC_FAILED_REASON_LABEL):
            notes.append(f"reason={labels[CC_FAILED_REASON_LABEL]}")
        if labels.get(ROLLOUT_GEN_LABEL):
            notes.append(f"rollout-gen={labels[ROLLOUT_GEN_LABEL]}")
        # Zero-bounce spares: a spare whose warmup completed shows
        # PRESTAGED — while it HOLDS (desired != state) that explains
        # the deliberate divergence; after the wave landed it explains
        # why the wave opened instantly.
        raw = node_annotations(node).get(labels_mod.PRESTAGED_ANNOTATION)
        if raw:
            try:
                rec = json.loads(raw)
            except ValueError:
                rec = None
            if isinstance(rec, dict) and rec.get("mode"):
                held = labels.get(CC_MODE_LABEL) != rec.get("mode")
                notes.append(
                    f"PRESTAGED({rec['mode']},{rec.get('seconds')}s"
                    + (",holding)" if held else ")")
                )
        if node_annotations(node).get(labels_mod.PRESTAGE_ANNOTATION) and not raw:
            notes.append(
                "prestaging("
                + str(node_annotations(node).get(labels_mod.PRESTAGE_ANNOTATION))
                + ")"
            )
        token = handshake.request_token(
            labels.get(handshake.DRAIN_REQUESTED_LABEL)
        )
        if token is not None:
            subs = handshake.subscriber_labels_of(labels)
            # Same acceptance predicate as await_workload_acks: this
            # cycle's token OR the legacy bare ack (version-skewed job).
            accepted = (handshake.ack_value(token), handshake.ACKED)
            pending = sum(1 for v in subs.values() if v not in accepted)
            notes.append(
                f"drain:requested({len(subs) - pending}/{len(subs)} acked)"
            )
        # Fail-slow SUSPECT: published by the vetter (obs/failslow.py
        # publish_suspect_labels) while a node's peer-relative latency
        # deviates — green probes, gray service. Telemetry only; the
        # verdict journal in the rollout record is what acts.
        suspect = (
            "slow"
            if labels.get(labels_mod.FAILSLOW_SUSPECT_LABEL)
            else "-"
        )
        rows.append(
            f"{node['metadata']['name']:<24} "
            f"{labels.get(SLICE_ID_LABEL, '-'):<20} "
            f"{labels.get(CC_MODE_LABEL, '-'):<10} "
            f"{labels.get(CC_MODE_STATE_LABEL, '-'):<10} "
            f"{labels.get(CC_READY_STATE_LABEL, '-'):<6} "
            f"{suspect:<8} "
            f"{trace:<17} "
            f"{' '.join(notes) or '-'}"
        )
    print("\n".join(rows))
    return 0


def _node_debug_address(api, node_name: str) -> str:
    """The address `ctl journal` dials: InternalIP preferred (the debug
    port binds the pod/host network), Hostname as the fallback."""
    node = api.get_node(node_name)
    addresses = (node.get("status") or {}).get("addresses") or []
    by_type = {a.get("type"): a.get("address") for a in addresses}
    addr = (
        by_type.get("InternalIP")
        or by_type.get("ExternalIP")
        or by_type.get("Hostname")
    )
    if not addr:
        raise ValueError(
            f"node {node_name} exposes no address in status.addresses; "
            "pass --url http://<agent>:<port>/journalz directly"
        )
    return addr


def cmd_journal(api, args) -> int:
    """Show a node's live intent journal via the agent's /journalz debug
    endpoint (ccmanager/metrics_server.py)."""
    import urllib.request

    url = getattr(args, "url", None)
    if not url:
        if not getattr(args, "node", None):
            raise ValueError("journal: --node (or --url) is required")
        addr = _node_debug_address(api, args.node)
        url = f"http://{addr}:{args.port}/journalz"
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            payload = json.loads(resp.read().decode())
    except (OSError, ValueError) as e:
        log.error("could not read %s: %s", url, e)
        return 1
    if getattr(args, "as_json", False):
        print(json.dumps(payload, indent=1))
        return 0
    if payload.get("enabled") is False:
        print("intent journal: DISABLED on this agent (CC_INTENT_JOURNAL=0)")
        return 0
    print(f"intent journal: {payload.get('path')} (seq={payload.get('seq')})")
    print(f"last desired mode: {payload.get('last_desired_mode') or '-'}")
    replay = payload.get("last_replay") or {}
    if replay:
        print(
            "last replay: %d record(s), %d torn byte(s) truncated"
            % (replay.get("records", 0), replay.get("truncated_bytes", 0))
        )
    intents = payload.get("open_intents") or []
    print(f"open intents: {len(intents)}")
    for i in intents:
        print(
            f"  {i.get('txn')}: kind={i.get('kind')} phase={i.get('phase')} "
            f"mode={i.get('mode', '-')} seq={i.get('seq')}"
        )
    pending = payload.get("pending_patches") or {}
    print(
        f"deferred label patches: {len(pending)} key(s) in "
        f"{payload.get('pending_patch_records', 0)} record(s)"
    )
    for key in sorted(pending):
        print(f"  {key} = {pending[key]!r}")
    return 0


def cmd_rbac_check(api, args) -> int:
    """Check every verb the agent uses (kubeclient/rest.py; the DaemonSet
    ClusterRole in deployments/manifests/daemonset.yaml must grant exactly
    these — including list nodes, which the slice barrier's peer discovery
    and the rolling orchestrator depend on)."""
    checks = [
        ("get", "nodes", None, True),
        ("list", "nodes", None, True),
        # `patch nodes` covers BOTH the metadata (labels/annotations)
        # writes and the quarantine taint write (spec.taints rides the
        # same resource + verb; ccmanager/remediation.py).
        ("patch", "nodes", None, True),
        ("watch", "nodes", None, True),
        ("list", "pods", args.namespace, True),
        # Events are best-effort (the agent degrades without them):
        # reported, but a denial doesn't fail the check. Node events live
        # in "default" (cluster-scoped involvedObject).
        ("create", "events", "default", False),
        # Rollout lease (ccmanager/rollout_state.py): get+create+update
        # carry acquisition, renewal and the checkpointed record; without
        # them `ctl rollout` degrades to an unfenced legacy rollout, so
        # they are reported required — a fleet relying on crash-safe
        # rollouts must not discover the gap mid-incident. delete is only
        # the operator's force-release (`rollout --abort`): optional.
        ("get", "leases", args.namespace, True),
        ("create", "leases", args.namespace, True),
        ("update", "leases", args.namespace, True),
        ("delete", "leases", args.namespace, False),
    ]
    ok = True
    for verb, resource, ns, required in checks:
        allowed = api.self_subject_access_review(verb, resource, namespace=ns)
        ok = ok and (allowed or not required)
        scope = f" (ns={ns})" if ns else ""
        verdict = "allowed" if allowed else (
            "DENIED" if required else "denied (optional)"
        )
        print(f"{verb:<6} {resource}{scope}: {verdict}")
    print("OK: RBAC sufficient" if ok else "FAIL: missing permissions")
    return 0 if ok else 1


def cmd_drain_subscribe(api, args) -> int:
    """Foreground sidecar process for the drain handshake: the pod's
    checkpoint command becomes the on_drain callback. SIGTERM/SIGINT
    unregister cleanly (pod shutdown must not leave a ghost subscriber
    the manager would wait on)."""
    import os
    import signal
    import subprocess

    from tpu_cc_manager_torch.drain.handshake import DrainSubscriber

    node = args.node or os.environ.get("NODE_NAME")
    if not node:
        raise ValueError("--node or $NODE_NAME is required")

    current: dict = {"proc": None}

    def run_cmd(cmd: str) -> None:
        log.info("running: %s", cmd)
        proc = subprocess.Popen(cmd, shell=True)
        current["proc"] = proc
        try:
            rc = proc.wait()
        finally:
            current["proc"] = None
        if rc != 0:
            raise subprocess.CalledProcessError(rc, cmd)

    sub = DrainSubscriber(
        api, node, args.job,
        on_drain=lambda: run_cmd(args.on_drain),
        on_resume=(
            (lambda: run_cmd(args.on_resume)) if args.on_resume else None
        ),
        poll_interval_s=args.poll_interval,
    )
    args.subscriber = sub  # handle for callers/tests to stop() us

    def _shutdown(*_):
        # Also SIGTERM an in-flight checkpoint command: run() is blocked in
        # its wait, and the pod's grace period is ticking — if we merely set
        # the stop flag, kubelet SIGKILLs us before the unregister in
        # run()'s finally, leaving a ghost subscriber every future drain
        # would wait on.
        sub.stop(timeout_s=0)
        proc = current.get("proc")
        if proc is not None:
            proc.terminate()

    import threading

    if threading.current_thread() is threading.main_thread():
        # Signal handlers only exist on the main thread (tests drive this
        # command from a worker thread and stop via args.subscriber).
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _shutdown)
    log.info(
        "drain subscriber %s watching node %s (ctrl-c / SIGTERM to leave)",
        sub.label, node,
    )
    sub.run()  # blocks; registers on entry, unregisters on the way out
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(debug=args.debug)
    api = None
    if args.command != "rollout-timeline":
        # rollout-timeline reads only the local flight file (and an
        # optional span JSONL): no apiserver, no kubeconfig — and no
        # client-construction INFO line on stdout, which would corrupt
        # its --json output (logging goes to stdout by reference
        # parity).
        try:
            api = RestKube(ClusterConfig.load(args.kubeconfig))
        except Exception as e:  # noqa: BLE001 - any config failure is fatal here
            log.error("could not configure kubernetes client: %s", e)
            return 1
    from tpu_cc_manager_torch.kubeclient.api import KubeApiError

    try:
        return {
            "rollout": cmd_rollout,
            "rollout-timeline": cmd_rollout_timeline,
            "attest": cmd_attest,
            "status": cmd_status,
            "quarantine": cmd_quarantine,
            "unquarantine": cmd_unquarantine,
            "journal": cmd_journal,
            "rbac-check": cmd_rbac_check,
            "drain-subscribe": cmd_drain_subscribe,
        }[args.command](api, args)
    except ValueError as e:
        log.error("usage error: %s", e)
        return 2
    except KubeApiError as e:
        log.error("apiserver error: %s", e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
