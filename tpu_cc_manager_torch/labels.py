"""The node-label contract: desired state, actual state, readiness.

This is the TPU mapping of the reference's label state machine (SURVEY.md §5;
reference main.py:62, gpu_operator_eviction.py:23-38). The protocol is kept
intact — desired/actual state carried on node labels, drain via a label pause
protocol — with TPU-native names and one TPU-specific mode value.

Mode semantics (reference modes at main.py:214-296):

=========  =====================================================================
``on``     CC enabled for the node's TPU chips (reference ``on``).
``off``    CC disabled (reference ``off``).
``devtools``  CC enabled with a debug attestation policy AND a debug runtime
           configuration. Policy side: quotes are fetched and logged but
           verification failures do not fail the reconcile. Backend side
           (tpudev/tpuvm.py): the staged runtime environment file carries
           debug/trace flags (``TPU_MIN_LOG_LEVEL=0``,
           ``TPU_STDERR_LOG_LEVEL=0``, vmodule tracing), committed by the
           runtime restart like any mode change — so a devtools runtime is
           *measurably* different (the env file is on the measured-paths
           list, hence a distinct attested runtime digest), mirroring the
           reference where devtools is a real hardware mode, not a label
           (main.py:214-263).
``slice``  Slice-wide CC across every host of a multi-host ICI domain, staged
           and committed with fabric atomicity. This is the TPU analogue of
           the reference's ``ppcie`` multi-GPU Protected-PCIe mode
           (main.py:265-426): a TPU slice connected by ICI is the analogue of
           the NVLink/NVSwitch fabric, so CC state must be toggled per-slice,
           not per-chip. ``ppcie`` is accepted as a deprecated input alias.
=========  =====================================================================
"""

from __future__ import annotations

import re

# --- Desired / actual / readiness labels (reference: nvidia.com/cc.mode,
# nvidia.com/cc.mode.state, nvidia.com/cc.ready.state).
CC_MODE_LABEL = "cloud.google.com/tpu-cc.mode"
CC_MODE_STATE_LABEL = "cloud.google.com/tpu-cc.mode.state"
CC_READY_STATE_LABEL = "cloud.google.com/tpu-cc.ready.state"

# Valid desired modes. Absent/empty label means "use the default".
MODE_ON = "on"
MODE_OFF = "off"
MODE_DEVTOOLS = "devtools"
MODE_SLICE = "slice"
VALID_MODES = (MODE_ON, MODE_OFF, MODE_DEVTOOLS, MODE_SLICE)

# Deprecated input aliases (accepted on the desired label, never written back).
MODE_ALIASES = {"ppcie": MODE_SLICE}

# Actual-state values: every valid mode plus "failed"
# (reference gpu_operator_eviction.py:268).
STATE_FAILED = "failed"

# Machine-readable failure reason, set alongside state=failed and cleared on
# any other state. No reference counterpart (the reference's only failure
# signal is the bare 'failed' value); added so operators can distinguish a
# misconfigured node (e.g. slice mode on non-slice hardware) from a
# transient device fault without scraping agent logs.
CC_FAILED_REASON_LABEL = "cloud.google.com/tpu-cc.failed.reason"

# Drained components: label key on the node -> pod app label selector value.
# Reference analogue: the five nvidia.com/gpu.deploy.* components and their
# app-label map (gpu_operator_eviction.py:23-38). The TPU set covers the GKE
# TPU stack: the device plugin that advertises google.com/tpu resources, the
# DRA driver, node metrics, the CC/workload validators.
DRAIN_COMPONENT_LABELS = {
    "google.com/tpu.deploy.device-plugin": "tpu-device-plugin",
    "google.com/tpu.deploy.dra-driver": "tpu-dra-driver",
    "google.com/tpu.deploy.metrics-agent": "tpu-metrics-agent",
    "google.com/tpu.deploy.sandbox-validator": "tpu-sandbox-validator",
    "google.com/tpu.deploy.workload-validator": "tpu-workload-validator",
}

# Slice membership, published by the agent after a successful reconcile;
# nodes of one multi-host ICI slice carry the same value. Consumed by the
# rolling orchestrator (group-by-slice) and multi-slice attestation.
SLICE_ID_LABEL = "cloud.google.com/tpu-slice-id"

# Quarantine: the terminal rung of the remediation ladder
# (ccmanager/remediation.py). A quarantined node carries this label (value
# "true"), a NoSchedule taint under the same key, and ready.state=false;
# the rolling orchestrator and pool attestation skip it, and the pool
# failure budget counts it. Cleared on probation lift or manual
# `tpu-cc-ctl unquarantine`.
QUARANTINED_LABEL = "cloud.google.com/tpu-cc.quarantined"
QUARANTINE_TAINT_KEY = "cloud.google.com/tpu-cc.quarantined"

# --- Centralized wire names (cclint surface contract) -----------------------
# Every cloud.google.com/tpu-cc.* / tpu-cc.gke.io key the agent writes or
# reads lives HERE; the owning modules re-export them so their public API
# is unchanged, and the cclint label-literal check (lint/surface.py) fails
# any new inline literal. One module owns the wire names: a renamed key is
# one diff hunk, not a grep across the thread soup.

# Slice commit barrier markers (ccmanager/slicecoord.py): staged/commit
# markers carry "<mode>:<ts>", the fencing generation invalidates a round.
SLICE_STAGED_LABEL = "cloud.google.com/tpu-cc.slice.staged"
SLICE_COMMIT_LABEL = "cloud.google.com/tpu-cc.slice.commit"
SLICE_FENCE_LABEL = "cloud.google.com/tpu-cc.slice.fence"
SLICE_STAGED_GEN_LABEL = "cloud.google.com/tpu-cc.slice.staged-gen"
SLICE_COMMIT_GEN_LABEL = "cloud.google.com/tpu-cc.slice.commit-gen"

# Remediation-ladder persistence (ccmanager/remediation.py).
REMEDIATION_ANNOTATION = "cloud.google.com/tpu-cc.remediation"

# Fail-slow vetting (obs/failslow.py): "true" while peer-relative
# outlier vetting suspects the node of a gray failure — operator
# telemetry for the `ctl status` SUSPECT column, never control flow
# (the rollout record's journaled verdicts are authoritative for
# acting). Cleared when the peer-relative stats recover.
FAILSLOW_SUSPECT_LABEL = "cloud.google.com/tpu-cc.failslow.suspect"

# Crash-safe rollouts (ccmanager/rollout_state.py): the checkpointed
# record on the Lease, and the generation stamp on rolled nodes.
ROLLOUT_RECORD_ANNOTATION = "cloud.google.com/tpu-cc.rollout-record"
ROLLOUT_GEN_LABEL = "cloud.google.com/tpu-cc.rollout-gen"

# Surge rollouts (ccmanager/rolling.py): spares flip first behind this
# NoSchedule taint and are reclaimed on convergence.
SURGE_TAINT_KEY = "cloud.google.com/tpu-cc.surge"

# Spare pre-staging (zero-bounce flips, ccmanager/manager.py +
# rolling.py): the orchestrator (or an operator) writes the target mode
# into the PRESTAGE annotation; the agent runs the full journaled
# transition + compile warmup ahead of the wave, reports the truthful
# state label, HOLDS there (the prestage annotation suppresses the
# revert a desired!=state reconcile would otherwise perform), and
# publishes a JSON status record — {"mode","prior","seconds","ts"} — in
# the PRESTAGED annotation. The later desired-mode write then converges
# in ~drain+readmit time via the idempotent re-attest path. Deleting the
# PRESTAGE annotation aborts the hold (the agent reverts to the desired
# mode on its next reconcile).
PRESTAGE_ANNOTATION = "cloud.google.com/tpu-cc.prestage"
PRESTAGED_ANNOTATION = "cloud.google.com/tpu-cc.prestaged"

# Multi-slice attestation (ccmanager/multislice.py): summary quote,
# full quote payload, and the verifier-challenge nonce.
QUOTE_ANNOTATION = "cloud.google.com/tpu-cc.attestation"
QUOTE_FULL_ANNOTATION = "cloud.google.com/tpu-cc.quote"
CHALLENGE_ANNOTATION = "cloud.google.com/tpu-cc.challenge"

# Preemption handoff record (ccmanager/manager.py): published by the
# departing agent, consumed by the replacement node's agent.
HANDOFF_ANNOTATION = "cloud.google.com/tpu-cc.handoff"

# Workload drain handshake (drain/handshake.py): drain request + deadline
# hint on the node; per-job ack annotations under the subscriber prefix.
DRAIN_REQUESTED_LABEL = "cloud.google.com/tpu-cc.drain"
DRAIN_DEADLINE_LABEL = "cloud.google.com/tpu-cc.drain.deadline-s"
DRAIN_SUBSCRIBER_PREFIX = "drain-subscriber.tpu-cc.gke.io/"

# Event → span-tree correlation (ccmanager/manager.py _emit_node_event),
# and the node annotation the agent republishes its LAST reconcile's
# trace id into (ctl status surfaces it as the TRACE column, so an
# operator can jump from status straight to /tracez?trace_id=...).
TRACE_ID_ANNOTATION = "tpu-cc.gke.io/trace-id"

# Cross-process trace stitching (ccmanager/rolling.py → manager.py): the
# orchestrator stamps "<trace_id>.<span_id>" of its rollout trace into
# every desired-mode patch; the node agent adopts it as the REMOTE
# parent of its reconcile root span, so /tracez renders one causal tree
# from `ctl rollout` down through each node's drain/reset/smoke
# (obs/trace.py format_parent/parse_parent).
ROLLOUT_TRACE_LABEL = "cloud.google.com/tpu-cc.rollout-trace"

# Pause protocol (reference gpu_operator_eviction.py:43-95):
#   'true'        -> PAUSED_VALUE
#   custom 'v'    -> 'v' + PAUSED_SUFFIX
#   'false' / ''  -> unchanged (user-disabled component)
#   already paused-> unchanged
# Unpausing inverts exactly.
PAUSED_VALUE = "paused-for-tpu-cc-mode-change"
PAUSED_SUFFIX = "_paused-for-tpu-cc-mode-change"


def canonical_mode(mode: str) -> str:
    """Map deprecated aliases onto canonical mode names (``ppcie``→``slice``)."""
    return MODE_ALIASES.get(mode, mode)


_LABEL_ILLEGAL = re.compile(r"[^A-Za-z0-9_.-]")


def label_safe(value: str, max_len: int = 63) -> str:
    """Coerce a string into a valid k8s label value (ASCII alnum/-/_/. and
    at most 63 chars; must start and end alphanumeric). ASCII explicitly:
    Python's ``isalnum`` admits unicode letters/digits ('À', '٣') that the
    apiserver's label regex rejects. The single shared sanitizer — every
    module writing derived label values (slice ids, failure reasons) must
    produce identical output for identical input."""
    cleaned = _LABEL_ILLEGAL.sub("-", value)[:max_len].strip("-_.")
    return cleaned or "unknown"


def ready_state_for(state: str) -> str:
    """Derive the readiness label value from the actual-state value.

    Reference (gpu_operator_eviction.py:275-288): on/ppcie -> "true",
    off -> "false", anything else -> "". Divergence, decided explicitly per
    SURVEY.md §8.4: the reference leaves ``devtools`` with an empty ready
    state; we report ``"debug"`` so schedulers can distinguish "CC up but in
    debug-attestation mode" from "unknown/failed".
    """
    if state in (MODE_ON, MODE_SLICE):
        return "true"
    if state == MODE_OFF:
        return "false"
    if state == MODE_DEVTOOLS:
        return "debug"
    return ""
