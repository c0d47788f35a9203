"""Cross-slice attestation for multi-slice data parallelism over DCN.

BASELINE.json configs[4] ("2×v5p-64: CC attestation + Llama-3-8B DP over
DCN"); SURVEY.md §7.9 hard part #3: "cross-slice attestation + re-forming
the DCN mesh after a slice bounces". No reference counterpart.

Protocol (control-plane side — the label/annotation transport mirrors how
the reference carries all its state on node objects):

1. After a slice's CC transition verifies locally, its node agent publishes
   (a) the quote *digest* and mode as node labels — the cheap operator-
   visible summary — and (b) the FULL signed quote (platform JWT/HMAC,
   measurements, nonce) as a node annotation (``publish_quote``).
2. Before a training job re-forms its DCN mesh, it (or the rolling
   orchestrator) calls ``verify_pool_attestation``: every slice in the pool
   must present (a) the expected mode, (b) a fresh-enough quote, (c) the
   SAME runtime digest, and (d) a published quote whose PLATFORM SIGNATURE
   verifies and matches the claimed digest. (c) alone would trust whatever
   a label claims — any principal that can patch node labels could claim
   any digest; (d) is the reference's read-truth-back principle
   (reference main.py:524-528) applied across slices: the evidence is
   re-verified by the consumer, not trusted from state. A node claiming
   the right digest without a validly signed quote fails pool
   verification.
3. The data-plane side then runs
   :func:`tpu_cc_manager_torch.parallel.distributed.verify_dcn_mesh` for the
   collective-path health check before the first real step.

Trust model of (d): the peer re-checks the platform signature (RS256
against Google's JWKS for tpuvm; fail-closed), the nonce binding inside
the signed token, token expiry, and digest/mode consistency between the
signed measurements and the advertised labels.

**Verifier-challenge freshness (VERDICT weak #5).** Signature checks
alone cannot give peer-chosen-challenge freshness: the nonce was chosen
by the attesting host's own agent, so replay protection within the
token's validity window used to rest entirely on the token's ``exp``.
The challenge protocol closes that: a verifier publishes a fresh nonce
in the :data:`CHALLENGE_ANNOTATION` node annotation
(:func:`issue_pool_challenges`), the node's agent re-quotes BOUND to that
nonce and republishes (ccmanager/manager.py answers challenges from its
watch loop), and pool verification then requires the published quote to
carry the outstanding challenge nonce — a replayed quote that sails
through every signature check fails the challenged path, because its
nonce predates the challenge. Nodes with no outstanding challenge still
verify on the exp-only policy, with the downgrade logged loudly
(``tpu-cc-ctl attest --challenge`` runs the full
challenge→await→verify round).
"""

from __future__ import annotations

import json
import logging
import time

from tpu_cc_manager_torch.kubeclient.api import (
    KubeApi,
    KubeApiError,
    caller_retry_attempts,
    classify_kube_error,
    node_annotations,
    node_labels,
)
from tpu_cc_manager_torch.obs import trace as obs_trace
from tpu_cc_manager_torch.utils import retry as retry_mod
from tpu_cc_manager_torch.gpudev.attestation import (
    AttestationError,
    deserialize_quote,
    quote_digest,
    quote_problems,
    serialize_quote,
)
from tpu_cc_manager_torch.gpudev.contract import AttestationQuote

log = logging.getLogger(__name__)

from tpu_cc_manager_torch import labels as labels_mod
from tpu_cc_manager_torch.labels import (  # noqa: E402 - shared constants
    QUARANTINED_LABEL,
    SLICE_ID_LABEL,
    label_safe,
)

# Wire names centralized in labels.py (cclint surface contract).
QUOTE_ANNOTATION = labels_mod.QUOTE_ANNOTATION
# The full signed quote rides in a real annotation (values up to 256 KiB;
# label values cap at 63 chars): peers re-verify its signature instead of
# trusting the digest labels above.
QUOTE_FULL_ANNOTATION = labels_mod.QUOTE_FULL_ANNOTATION
# Verifier-published nonce challenge (JSON {"nonce": ..., "ts": ...}):
# the agent re-quotes bound to this nonce, giving pool verification
# peer-chosen-challenge freshness instead of exp-only replay protection.
CHALLENGE_ANNOTATION = labels_mod.CHALLENGE_ANNOTATION


class PoolAttestationError(Exception):
    """The pool's slices do not present coherent attestation evidence."""


def quote_label_patch(quote: AttestationQuote | None) -> dict:
    """Label entries advertising a quote — or None-clears when there is no
    quote (mode off), so pool verification can't read stale evidence.

    Returned as a plain dict so callers can fold it into a single node
    merge-patch together with other coordination labels."""
    if quote is None:
        return {
            f"{QUOTE_ANNOTATION}.digest": None,
            f"{QUOTE_ANNOTATION}.mode": None,
            f"{QUOTE_ANNOTATION}.ts": None,
        }
    # Label values are constrained (63 chars, alphanum/-/_/.); pack the
    # payload into multiple labels instead of one JSON blob.
    return {
        f"{QUOTE_ANNOTATION}.digest": quote_digest(quote),
        f"{QUOTE_ANNOTATION}.mode": quote.mode,
        f"{QUOTE_ANNOTATION}.ts": str(int(time.time())),
    }


def publish_quote_annotation(
    api: KubeApi, node_name: str, quote: AttestationQuote | None,
    strict: bool = False,
) -> None:
    """Publish (or clear, for ``quote=None``) the full signed quote in the
    node annotation peers verify. By default best-effort on clients
    without annotation support (the digest labels still work there; the
    pool verifier just reports those nodes as signature-unverifiable);
    ``strict`` re-raises instead — the challenge-answer path needs the
    failure, because swallowing it would let the caller mark an answer
    delivered that the apiserver never saw."""
    value = serialize_quote(quote) if quote is not None else None
    try:
        api.patch_node_annotations(node_name, {QUOTE_FULL_ANNOTATION: value})
    except KubeApiError as e:
        if strict:
            raise
        log.warning(
            "could not publish signed quote annotation on %s: %s",
            node_name, e,
        )


def retire_answered_challenge(api: KubeApi, node_name: str, nonce: str) -> None:
    """Clear the challenge annotation IF it still holds the nonce the
    agent just answered. The condition matters: a newer challenge issued
    while the agent was fetching its quote (a device round trip takes
    seconds) must not be erased unseen — an unconditional clear would
    leave the new verifier's await timing out on a node that never got
    the chance to answer. Best-effort: a lingering ANSWERED challenge is
    harmless (the published quote is bound to it, so verification still
    passes); the clear only keeps a one-time challenge from re-arming
    after the next reconcile republishes a self-nonce quote."""
    try:
        current = challenge_nonce_of(api.get_node(node_name))
        if current == nonce:
            api.patch_node_annotations(node_name, {CHALLENGE_ANNOTATION: None})
    except KubeApiError as e:
        log.warning(
            "could not retire answered challenge on %s: %s", node_name, e
        )


def publish_quote(
    api: KubeApi, node_name: str, quote: AttestationQuote,
    strict: bool = False,
) -> dict:
    """Publish a quote on the node: digest+mode as labels (the operator-
    visible summary) and the full signed quote as an annotation (what
    peers actually verify)."""
    patch = quote_label_patch(quote)
    api.patch_node_labels(node_name, patch)
    publish_quote_annotation(api, node_name, quote, strict=strict)
    payload = {
        "slice": quote.slice_id,
        "mode": quote.mode,
        "digest": patch[f"{QUOTE_ANNOTATION}.digest"],
        "ts": int(patch[f"{QUOTE_ANNOTATION}.ts"]),
    }
    log.info("published attestation for %s: %s", node_name, payload)
    return payload


def challenge_nonce_of(node: dict) -> str | None:
    """The outstanding verifier-challenge nonce on a node (None when no
    challenge was issued or the annotation is unreadable — an unreadable
    challenge degrades to the exp-only policy rather than crashing the
    agent that merely wants to answer it)."""
    raw = node_annotations(node).get(CHALLENGE_ANNOTATION)
    if not raw:
        return None
    try:
        nonce = json.loads(raw).get("nonce")
        return str(nonce) if nonce else None
    except (ValueError, AttributeError):
        log.warning("unreadable challenge annotation: %r", raw[:120])
        return None


def issue_pool_challenges(
    api: KubeApi, selector: str, informer=None
) -> dict[str, str]:
    """Publish a FRESH per-node nonce challenge on every healthy matching
    node; returns {node_name: nonce}. Per-node nonces (not one pool-wide
    value) so one node's answer can never satisfy another node's
    challenge. Quarantined hosts are skipped — their evidence is excluded
    from verification anyway. Best-effort on clients without annotation
    support: returns {} and verification stays on the exp-only policy.
    ``informer`` (ccmanager/informer.py, same selector) serves the
    membership read from the watch-driven cache — the writes still go to
    the apiserver, but the O(pool) listing per challenge round is gone."""
    from tpu_cc_manager_torch.gpudev import attestation as attestation_mod

    challenges: dict[str, str] = {}
    # ``synced`` gate (here and below): an informer whose first listing
    # hasn't landed reports an EMPTY pool, not an error — fall back to a
    # real listing rather than silently challenging/collecting nothing.
    for node in (informer.list() if informer is not None and informer.synced
                 else api.list_nodes(selector)):
        name = node["metadata"]["name"]
        if node_labels(node).get(QUARANTINED_LABEL) == "true":
            continue
        nonce = attestation_mod.fresh_nonce()
        try:
            api.patch_node_annotations(name, {
                CHALLENGE_ANNOTATION: json.dumps(
                    {"nonce": nonce, "ts": int(time.time())},
                    sort_keys=True, separators=(",", ":"),
                )
            })
        except KubeApiError as e:
            if e.status is None and "not supported" in (e.reason or ""):
                # Structural: this CLIENT cannot publish annotations at
                # all (the KubeApi capability default). Challenged
                # attestation is impossible here — degrade to the
                # documented exp-only fallback instead of failing every
                # healthy node on challenges they could never receive.
                log.warning(
                    "client cannot publish challenge annotations (%s); "
                    "falling back to exp-only verification", e,
                )
                return {}
            # Transient per-node flake: the node stays IN the challenge
            # set even though it never saw the challenge — it will fail
            # challenged verification loudly. Dropping it instead would
            # verify it exp-only, a silent downgrade of exactly the node
            # the flake made unattestable, in the mode whose purpose is
            # defeating replay.
            log.warning(
                "could not publish challenge on %s (%s); the node WILL "
                "fail challenged verification", name, e,
            )
        challenges[name] = nonce
    log.info(
        "issued attestation challenges to %d node(s)", len(challenges)
    )
    return challenges


def await_challenge_answers(
    api: KubeApi,
    selector: str,
    challenges: dict[str, str],
    timeout_s: float = 30.0,
    poll_interval_s: float = 1.0,
    informer=None,
) -> list[str]:
    """Wait (bounded) until every challenged node republished a quote
    bound to its challenge nonce; returns the node names still
    unanswered at the deadline (empty = all answered). Lenient like the
    drain handshake: a wedged agent delays verification by at most the
    timeout and then FAILS the challenged check — it cannot veto it."""
    pending = dict(challenges)

    def all_answered() -> bool:
        from tpu_cc_manager_torch.kubeclient.api import classify_kube_error

        try:
            nodes = (
                informer.list()
                if informer is not None and informer.synced
                else api.list_nodes(selector)
            )
        except KubeApiError as e:
            verdict = classify_kube_error(e)
            if verdict is None or not verdict.transient:
                raise
            # One throttle/blip must not abort a 30 s bounded wait whose
            # next tick would likely succeed; the deadline bounds us.
            log.warning("challenge poll listing failed (transient): %s", e)
            return False
        for node in nodes:
            name = node["metadata"]["name"]
            nonce = pending.get(name)
            if nonce is None:
                continue
            raw = node_annotations(node).get(QUOTE_FULL_ANNOTATION)
            if raw is None:
                continue
            try:
                quote = deserialize_quote(raw)
            except AttestationError:
                continue
            if quote.nonce == nonce:
                del pending[name]
        return not pending

    if informer is not None:
        # Event-driven: wake on cache changes (each answer republishes the
        # quote annotation, which is a node MODIFIED event) instead of
        # paying a pool listing per poll tick.
        informer.wait_for(
            lambda _informer: all_answered(), timeout_s,
            recheck_interval_s=poll_interval_s,
        )
    else:
        retry_mod.poll_until(all_answered, timeout_s, poll_interval_s)
    if pending:
        log.warning(
            "challenge unanswered by %s after %.0fs",
            sorted(pending), timeout_s,
        )
    return sorted(pending)


def collect_pool_quotes(
    api: KubeApi, selector: str, informer=None
) -> dict[str, dict]:
    """slice_id -> {digest, mode, ts, nodes, missing} across matching nodes.

    Every host of a slice must attest, so hosts carrying the slice label but
    no quote are recorded in ``missing`` (not silently skipped), modes must
    agree across hosts (else ``mode`` becomes "MIXED"), and ``ts`` is the
    OLDEST host's timestamp so staleness checks see the worst host. With
    an ``informer`` (same selector) the whole collection is a cache read:
    pool attestation stops costing one O(pool) listing per verification."""
    if informer is not None and informer.synced:
        nodes = informer.list()
    else:
        # Transient apiserver failures ride the shared jittered backoff; a
        # pool verification gating a DCN mesh re-form should not fail on
        # one flaky listing. One attempt when the client retries
        # internally (RestKube).
        policy = retry_mod.RetryPolicy(
            max_attempts=caller_retry_attempts(api), base_delay_s=0.5
        )
        nodes = policy.call(
            lambda: api.list_nodes(selector),
            op="pool_attest.list_nodes",
            classify=classify_kube_error,
        )
    slices: dict[str, dict] = {}
    for node in nodes:
        labels = node_labels(node)
        name = node["metadata"]["name"]
        digest = labels.get(f"{QUOTE_ANNOTATION}.digest")
        slice_id = labels.get(SLICE_ID_LABEL) or f"node/{name}"
        entry = slices.setdefault(
            slice_id,
            {"digest": None, "mode": None, "ts": None, "nodes": [],
             "missing": [], "quarantined": [], "quotes": {},
             "node_digests": {}, "challenges": {}},
        )
        entry["challenges"][name] = challenge_nonce_of(node)
        if labels.get(QUARANTINED_LABEL) == "true":
            # A quarantined host is out of the serving pool (remediation
            # ladder): its absent/stale evidence must not fail the healthy
            # hosts' verification — it is reported, not enforced. A slice
            # whose EVERY host is quarantined still fails (no evidence at
            # all reads as a missing slice, which it operationally is).
            entry["quarantined"].append(name)
            log.warning(
                "pool attestation: skipping quarantined host %s "
                "(slice %s)", name, slice_id,
            )
            continue
        if digest is None:
            entry["missing"].append(name)
            continue
        mode = labels.get(f"{QUOTE_ANNOTATION}.mode", "")
        try:
            ts = int(labels.get(f"{QUOTE_ANNOTATION}.ts", "0") or 0)
        except ValueError:
            # A forged/corrupt ts label must degrade to "maximally stale"
            # (epoch 0 → the staleness problem fires), not crash the
            # verifier outside its PoolAttestationError contract.
            ts = 0
        entry["nodes"].append(name)
        entry["digest"] = digest if entry["digest"] in (None, digest) else "MIXED"
        entry["mode"] = mode if entry["mode"] in (None, mode) else "MIXED"
        entry["ts"] = ts if entry["ts"] is None else min(entry["ts"], ts)
        # The full signed quote, when published: None records "labels only"
        # so the verifier can fail signature-required pools loudly.
        raw = node_annotations(node).get(QUOTE_FULL_ANNOTATION)
        quote = None
        if raw is not None:
            try:
                quote = deserialize_quote(raw)
            except AttestationError as e:
                log.warning("unparseable quote annotation on %s: %s", name, e)
        entry["quotes"][name] = quote
        entry["node_digests"][name] = digest
    # Slices where no host attested at all keep digest None.
    return slices


def _peer_verify_node_quote(
    sid: str,
    name: str,
    quote: AttestationQuote | None,
    label_digest: str,
    expected_mode: str,
    allow_fake: bool,
    challenge_nonce: str | None = None,
) -> list[str]:
    """Signature-grade checks for one node's published quote: present,
    platform signature + nonce binding verify, the signed quote names THIS
    node's slice, signed measurements match the advertised digest labels,
    and the runtime was actually measured.

    With ``challenge_nonce`` (a verifier-published challenge outstanding
    on the node) the quote must be bound to THAT nonce: the whole
    quote-problems pass runs against the challenge, so a replayed quote —
    valid signature, matching digest, same slice — fails here, because
    its self-chosen nonce predates the challenge. Without a challenge the
    quote's own nonce is used (exp-only freshness; the caller logs the
    downgrade)."""
    where = f"slice {sid}: node {name}"
    if quote is None:
        return [
            f"{where}: digest label without a verifiable signed quote "
            f"(annotation {QUOTE_FULL_ANNOTATION} missing or unparseable)"
        ]
    challenged = challenge_nonce is not None
    challenge_missed = challenged and quote.nonce != challenge_nonce
    # On a missed challenge, run the structural checks against the
    # quote's own nonce and report the miss ONCE below — passing the
    # challenge nonce into quote_problems too would double-report the
    # same defect ("nonce mismatch" + "not bound to the challenge").
    expected_nonce = (
        challenge_nonce if challenged and not challenge_missed
        else quote.nonce
    )
    problems = [
        f"{where}: {p}"
        for p in quote_problems(
            quote, expected_nonce, expected_mode, allow_fake=allow_fake
        )
    ]
    if challenge_missed:
        problems.append(
            f"{where}: published quote is not bound to the outstanding "
            "verifier challenge (replayed or stale evidence; exp-only "
            "freshness is not accepted once a challenge is issued)"
        )
    # Slice binding: without it, a node could replay ANOTHER slice's whole
    # evidence (labels + annotation verbatim) and pass every signature
    # check — the signed quote must name the slice this node advertises.
    # Skipped for the node/<name> fallback grouping (no slice label to
    # bind against; the label alphabet can't even contain "/").
    if not sid.startswith("node/") and label_safe(quote.slice_id) != sid:
        problems.append(
            f"{where}: signed quote names slice "
            f"{label_safe(quote.slice_id)!r}, node advertises {sid!r} — "
            "replayed evidence from another slice"
        )
    if quote_digest(quote) != label_digest:
        # The label is what digest-equality compares; a signed quote that
        # doesn't hash to it means the label claims a runtime the platform
        # never signed for.
        problems.append(
            f"{where}: advertised digest label does not match the signed "
            "quote's measurements"
        )
    if quote.measurements.get("runtime_files") == "0":
        # Without this, every unmeasured host hashes the same constant and
        # cross-slice digest equality passes vacuously (ADVICE r4 #4).
        problems.append(
            f"{where}: runtime was never measured (runtime_files=0: no "
            "measure glob matched; digest equality would be vacuous)"
        )
    return problems


def verify_pool_attestation(
    api: KubeApi,
    selector: str,
    expected_mode: str,
    expected_slices: int | None = None,
    max_age_s: float | None = 3600.0,
    allow_fake: bool = False,
    verify_signatures: bool = True,
    challenges: dict[str, str] | None = None,
    informer=None,
) -> dict[str, dict]:
    """Check every slice attests the expected mode with one common digest,
    re-verifying each node's published quote SIGNATURE — not just the
    self-published digest labels (which anyone with node-patch RBAC could
    forge).

    ``allow_fake`` admits fake-platform quotes (HMAC, shared test key) and
    must only be set when the pool runs the fake device layer.
    ``verify_signatures=False`` restores the r4 digest-labels-only check
    for clients that cannot read annotations; it downgrades the guarantee
    from platform-signed to RBAC-trust and logs accordingly.
    ``challenges`` ({node: nonce}, from :func:`issue_pool_challenges`) is
    the verifier's AUTHORITATIVE challenge set: quotes on those nodes
    must be bound to those nonces. When None, outstanding challenge
    annotations are read opportunistically from the nodes (weaker: a
    principal with node-patch RBAC could clear an annotation to force
    the exp-only fallback, which is why the fallback is logged).

    Returns the slice map on success; raises PoolAttestationError with the
    full discrepancy list otherwise."""
    with obs_trace.span(
        "pool_attest.verify", selector=selector, expected_mode=expected_mode
    ) as sp:
        slices = _verify_pool_attestation(
            api, selector, expected_mode, expected_slices, max_age_s,
            allow_fake, verify_signatures, challenges, informer,
        )
        sp.set_attribute("slices", len(slices))
        return slices


def _verify_pool_attestation(
    api: KubeApi,
    selector: str,
    expected_mode: str,
    expected_slices: int | None,
    max_age_s: float | None,
    allow_fake: bool,
    verify_signatures: bool,
    challenges: dict[str, str] | None = None,
    informer=None,
) -> dict[str, dict]:
    slices = collect_pool_quotes(api, selector, informer=informer)
    if challenges is not None:
        # The verifier's own challenge set overrides whatever the nodes
        # advertise — an annotation a hostile writer cleared (or never
        # relayed) must not quietly downgrade a challenged verification.
        for entry in slices.values():
            entry["challenges"] = {
                name: challenges.get(name)
                for name in list(entry.get("challenges") or {})
            }
    problems: list[str] = []
    if not any(e["nodes"] for e in slices.values()):
        problems.append("no slice published any attestation")
    if expected_slices is not None and len(slices) != expected_slices:
        problems.append(f"expected {expected_slices} slices, found {len(slices)}")
    if not verify_signatures:
        log.warning(
            "pool attestation running digest-labels-only (signature "
            "verification disabled): label forgery is NOT detected"
        )
    now = time.time()
    digests = set()
    # Nodes verified on exp-only freshness (no outstanding verifier
    # challenge): aggregated into ONE warning after the walk — a per-node
    # warning would emit O(pool) identical lines on every plain attest.
    exp_only_nodes: list[str] = []
    for sid, entry in sorted(slices.items()):
        if entry["missing"]:
            problems.append(
                f"slice {sid}: host(s) without attestation: "
                f"{sorted(entry['missing'])}"
            )
        if entry["quarantined"] and not entry["nodes"] and not entry["missing"]:
            # Quarantined hosts are skipped, but a slice with NO healthy
            # host left has no evidence at all — it must not read as
            # verified just because its failures were contained.
            problems.append(
                f"slice {sid}: every host quarantined "
                f"({sorted(entry['quarantined'])}); no attestable host left"
            )
        if entry["digest"] is None:
            continue  # covered by the missing/quarantined problems above
        if entry["digest"] == "MIXED":
            problems.append(f"slice {sid}: hosts disagree on runtime digest")
        else:
            digests.add(entry["digest"])
        if entry["mode"] == "MIXED":
            problems.append(f"slice {sid}: hosts disagree on attested mode")
        elif entry["mode"] != expected_mode:
            problems.append(
                f"slice {sid}: mode {entry['mode']!r} != expected {expected_mode!r}"
            )
        if max_age_s is not None and now - entry["ts"] > max_age_s:
            problems.append(f"slice {sid}: quote is stale ({int(now - entry['ts'])}s)")
        if verify_signatures:
            for name in sorted(entry["nodes"]):
                challenge = (entry.get("challenges") or {}).get(name)
                if challenge is None:
                    exp_only_nodes.append(f"{sid}/{name}")
                problems.extend(_peer_verify_node_quote(
                    sid, name, entry["quotes"].get(name),
                    entry["node_digests"][name], expected_mode, allow_fake,
                    challenge_nonce=challenge,
                ))
    if exp_only_nodes:
        shown = ", ".join(exp_only_nodes[:6])
        if len(exp_only_nodes) > 6:
            shown += f", … ({len(exp_only_nodes) - 6} more)"
        log.warning(
            "pool attestation: %d node(s) verified with exp-only "
            "freshness (no verifier challenge outstanding: %s) — run "
            "`tpu-cc-ctl attest --challenge` for challenged "
            "re-attestation", len(exp_only_nodes), shown,
        )
    if len(digests) > 1:
        problems.append(
            f"slices report {len(digests)} distinct runtime digests: "
            f"{sorted(digests)}"
        )
    if problems:
        raise PoolAttestationError("; ".join(problems))
    log.info(
        "pool attestation verified: %d slice(s), digest=%s, mode=%s, "
        "signatures=%s",
        len(slices), next(iter(digests)), expected_mode,
        "verified" if verify_signatures else "SKIPPED",
    )
    return slices


def pool_report(api: KubeApi, selector: str, informer=None) -> str:
    """Human-readable attestation table (CLI helper)."""
    slices = collect_pool_quotes(api, selector, informer=informer)
    lines = [
        f"{'SLICE':<28} {'MODE':<10} {'DIGEST':<18} {'ATTESTED':<9} "
        f"{'MISSING':<8} QUAR"
    ]
    for sid, e in sorted(slices.items()):
        lines.append(
            f"{sid:<28} {str(e['mode'] or '-'):<10} "
            f"{str(e['digest'] or '-'):<18} {len(e['nodes']):<9} "
            f"{len(e['missing']):<8} {len(e['quarantined'])}"
        )
    return "\n".join(lines)
