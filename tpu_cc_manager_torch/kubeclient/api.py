"""KubeApi: the exact apiserver surface the manager needs, as an interface.

Reference analogue: the subset of kubernetes.client.CoreV1Api used by
main.py:129-140/580-684 and gpu_operator_eviction.py (read_node, patch_node,
list_namespaced_pod, watch.Watch). Defining it as an interface lets tests and
bench.py swap in the in-memory fake (SURVEY.md §4 test plan, step 2).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Iterator, Mapping


class KubeApiError(Exception):
    """Apiserver error with an HTTP status, mirroring ApiException.status
    (the reference branches on 410 Gone at main.py:670).

    ``retry_after_s`` carries a server-directed minimum backoff (a 429's
    ``Retry-After`` header) for the shared retry policy to honor."""

    def __init__(
        self,
        status: int | None,
        reason: str = "",
        retry_after_s: float | None = None,
    ):
        super().__init__(f"kube api error status={status} reason={reason}")
        self.status = status
        self.reason = reason
        self.retry_after_s = retry_after_s


# Transient statuses worth another try on idempotent verbs; status=None is
# a transport-level failure (connection reset, timeout) and equally
# transient. 410 Gone is NOT here: it is a protocol signal (resync), not a
# flake.
RETRYABLE_STATUS = (429, 500, 502, 503, 504)


def classify_kube_error(e: BaseException) -> "retry_mod.Classification | None":
    """Shared transient-vs-permanent verdict for apiserver failures, used
    by every call site that retries through utils/retry.py. A 4xx (other
    than 429) will not improve with repetition; anything transport-level
    or throttling/5xx-shaped will plausibly clear."""
    from tpu_cc_manager_torch.utils import retry as retry_mod

    if not isinstance(e, KubeApiError):
        return None
    if getattr(e, "circuit_open", False):
        # The client's breaker is open: retrying cannot help until the
        # recovery window passes — fail fast, as the breaker intends.
        return retry_mod.Classification(False, "circuit-open")
    if e.status is None:
        return retry_mod.Classification(True, "connection", e.retry_after_s)
    if e.status == 429:
        return retry_mod.Classification(True, "throttled", e.retry_after_s)
    if e.status in RETRYABLE_STATUS:
        return retry_mod.Classification(True, f"http-{e.status}", e.retry_after_s)
    return retry_mod.Classification(False, f"http-{e.status}")


@dataclass
class WatchEvent:
    """One event from a watch stream: type ∈ ADDED|MODIFIED|DELETED|BOOKMARK|ERROR,
    object is the raw (JSON-decoded) Kubernetes object."""

    type: str
    object: dict


def node_annotations(node: dict) -> dict:
    """metadata.annotations of a node object (never None)."""
    return (node.get("metadata") or {}).get("annotations") or {}


def node_labels(node: dict) -> dict:
    """Labels of a node dict ({} if unset)."""
    return (node.get("metadata") or {}).get("labels") or {}


def resource_version(obj: dict) -> str:
    return str((obj.get("metadata") or {}).get("resourceVersion") or "")


def is_lease_unsupported(e: BaseException) -> bool:
    """Whether an error is the KubeApi default's lease-unsupported marker
    (as opposed to a real apiserver failure): callers use it to degrade to
    an unfenced rollout on minimal clients while still surfacing genuine
    lease errors."""
    return (
        isinstance(e, KubeApiError)
        and e.status is None
        and KubeApi.LEASE_UNSUPPORTED in (e.reason or "")
    )


def is_pool_watch_unsupported(e: BaseException) -> bool:
    """Whether an error is the KubeApi default's pool-watch-unsupported
    marker: the informer cache uses it to fail construction loudly (a
    cache that silently never updates would be worse than no cache)."""
    return (
        isinstance(e, KubeApiError)
        and e.status is None
        and KubeApi.POOL_WATCH_UNSUPPORTED in (e.reason or "")
    )


def caller_retry_attempts(api: "KubeApi", default: int = 3) -> int:
    """How many attempts a CALLER-side retry policy should make against
    ``api``: 1 when the client already retries transients internally
    (RestKube), ``default`` otherwise (fakes, chaos wrappers). Prevents the
    nested-ladder amplification where a caller's 3 attempts each expand
    into the client's 3 — up to 9 HTTP requests per logical call against
    an apiserver that is already degraded."""
    return 1 if getattr(api, "retries_internally", False) else default


def list_nodes_chunked(
    api: "KubeApi", label_selector: str | None = None,
    limit: int | None = None,
) -> tuple[list[dict], str]:
    """Full listing through the chunked-list protocol: pages of ``limit``
    via ``list_nodes_page`` until the continue token runs dry. Returns
    (items, resourceVersion-of-the-listing) — the rv is what a follow-up
    watch resumes from, which is why the informer cache uses this instead
    of plain ``list_nodes`` (whose return type carries no rv)."""
    items: list[dict] = []
    token: str | None = None
    rv = ""
    while True:
        page = api.list_nodes_page(
            label_selector, limit=limit, continue_token=token
        )
        items.extend(page.get("items") or [])
        meta = page.get("metadata") or {}
        rv = str(meta.get("resourceVersion") or rv)
        token = meta.get("continue") or None
        if not token:
            return items, rv


class KubeApi(abc.ABC):
    """Typed facade over the apiserver operations the control plane performs."""

    #: True when this client retries transient failures internally; caller-
    #: side policies consult caller_retry_attempts() so exactly ONE backoff
    #: ladder runs per logical call.
    retries_internally = False

    POOL_WATCH_UNSUPPORTED = "pool watch not supported by this client"

    @abc.abstractmethod
    def get_node(self, name: str) -> dict:
        """GET /api/v1/nodes/{name}. Raises KubeApiError (404 if absent)."""

    @abc.abstractmethod
    def patch_node_labels(self, name: str, labels: Mapping[str, str | None]) -> dict:
        """JSON merge-patch {"metadata": {"labels": labels}} onto the node.

        A ``None`` value deletes the label (merge-patch semantics). Returns
        the patched node. This deliberately never writes anything but labels
        (SURVEY.md §8.3)."""

    def patch_node_annotations(
        self, name: str, annotations: Mapping[str, str | None]
    ) -> dict:
        """JSON merge-patch {"metadata": {"annotations": ...}} onto the node.

        Annotations carry payloads too large for label values (the signed
        attestation quote, ccmanager/multislice.py); a ``None`` value
        deletes. Optional capability — the default raises KubeApiError so
        callers degrade cleanly on clients without it."""
        raise KubeApiError(
            None, "annotation patching not supported by this client"
        )

    def patch_node_taints(
        self, name: str, add: list[dict], remove_keys: list[str]
    ) -> dict:
        """Add/remove taints on the node's ``spec.taints``.

        ``add`` entries are taint dicts ({key, value, effect}); existing
        taints with the same key are replaced, and ``remove_keys`` are
        deleted. Taints are a LIST in the node spec, so implementations do
        a read-modify-write and replace the whole list in one merge-patch
        — same ``patch nodes`` RBAC verb as the label writes. Used by
        quarantine (ccmanager/remediation.py) to fence workloads off a
        condemned node with ``NoSchedule``. Optional capability — the
        default raises so callers degrade cleanly."""
        raise KubeApiError(None, "taint patching not supported by this client")

    @abc.abstractmethod
    def list_nodes(self, label_selector: str | None = None) -> list[dict]:
        """GET /api/v1/nodes, optionally filtered by an equality label
        selector ("k=v" or "k" presence, comma-separated)."""

    def list_nodes_page(
        self,
        label_selector: str | None = None,
        limit: int | None = None,
        continue_token: str | None = None,
    ) -> dict:
        """One page of GET /api/v1/nodes with ``limit``/``continue``
        chunking, returned NodeList-shaped: ``{"items": [...], "metadata":
        {"resourceVersion": ..., "continue": ...}}``. An absent/empty
        ``metadata.continue`` ends the listing. The default degrades to a
        single unchunked page through :meth:`list_nodes` (minimal clients
        keep working; they just pay the one big response a real 10k-node
        listing would chunk)."""
        if continue_token:
            # The default never hands out a token, so receiving one back
            # means the caller mixed clients mid-listing.
            raise KubeApiError(
                410, "continue token not recognized by this client"
            )
        return {
            "items": self.list_nodes(label_selector),
            "metadata": {"resourceVersion": ""},
        }

    @abc.abstractmethod
    def list_pods(
        self,
        namespace: str,
        label_selector: str | None = None,
        field_selector: str | None = None,
    ) -> list[dict]:
        """GET /api/v1/namespaces/{ns}/pods with optional selectors.

        The manager uses label_selector="app=<component>" plus
        field_selector="spec.nodeName=<node>" while polling the drain
        (reference gpu_operator_eviction.py:185-207)."""

    @abc.abstractmethod
    def watch_nodes(
        self,
        name: str,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        """Watch a single node (field selector metadata.name=<name>).

        Yields WatchEvents until the server-side timeout elapses, then
        returns. Transport errors raise KubeApiError; a stale
        resourceVersion raises KubeApiError(410) either immediately or as an
        ERROR event translated by the caller (reference main.py:622-638)."""

    def watch_nodes_pool(
        self,
        label_selector: str | None = None,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        """Watch EVERY node matching a label selector (one stream for a
        whole pool — the informer cache's transport,
        ccmanager/informer.py).

        Same event contract as :meth:`watch_nodes` (ADDED/MODIFIED/
        DELETED/BOOKMARK/ERROR, 410 on a stale resourceVersion), plus the
        real apiserver's selector-scoping rule: an object that STOPS
        matching the selector is delivered as DELETED — the cache must
        drop it, not keep serving its stale last-matching state. Optional
        capability: the default raises the POOL_WATCH_UNSUPPORTED marker
        so callers can degrade to polling listings."""
        raise KubeApiError(None, self.POOL_WATCH_UNSUPPORTED)

    def create_event(self, namespace: str, event: dict) -> dict:
        """POST a core/v1 Event (``kubectl describe node`` visibility).

        Optional capability — the default raises, and callers must treat
        emission as best-effort (events are operator convenience, never
        control-plane state). Not retried on failure: POST is not
        idempotent and a lost event is acceptable."""
        raise KubeApiError(None, "event creation not supported by this client")

    # -- coordination.k8s.io/v1 Leases ---------------------------------
    #
    # The single-writer primitive for fleet-scale operations: the rolling
    # orchestrator holds a Lease while it flips a pool, with the rollout
    # record checkpointed into the Lease's annotations so a successor can
    # resume (ccmanager/rollout_state.py). All four verbs are OPTIONAL
    # capabilities (the defaults raise the LEASE_UNSUPPORTED marker) so
    # minimal clients degrade to an unfenced legacy rollout instead of
    # crashing. ``update_lease`` is the optimistic-concurrency hinge:
    # implementations MUST reject a stale ``metadata.resourceVersion``
    # with 409 Conflict — that CAS is what makes the fencing token
    # trustworthy.

    LEASE_UNSUPPORTED = "lease operations not supported by this client"

    def get_lease(self, namespace: str, name: str) -> dict:
        """GET a coordination.k8s.io/v1 Lease (404 if absent)."""
        raise KubeApiError(None, self.LEASE_UNSUPPORTED)

    def create_lease(self, namespace: str, name: str, spec: dict) -> dict:
        """POST a new Lease with the given ``spec`` (holderIdentity,
        leaseDurationSeconds, acquireTime, renewTime, leaseTransitions).
        Raises 409 AlreadyExists when the Lease exists — the loser of a
        create race must observe the winner, never overwrite it."""
        raise KubeApiError(None, self.LEASE_UNSUPPORTED)

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict:
        """PUT the full Lease object back. ``lease`` must carry the
        ``metadata.resourceVersion`` the caller read; a mismatch with the
        stored object raises 409 Conflict (optimistic concurrency — the
        compare-and-swap every lease transition and rollout checkpoint
        rides on). Never retried internally: a retry after an ambiguous
        first attempt would 409 against its own write."""
        raise KubeApiError(None, self.LEASE_UNSUPPORTED)

    def delete_lease(self, namespace: str, name: str) -> None:
        """DELETE a Lease (404 if absent) — the operator's force-release
        escape hatch for a wedged rollout lease."""
        raise KubeApiError(None, self.LEASE_UNSUPPORTED)

    def self_subject_access_review(
        self, verb: str, resource: str, namespace: str | None = None
    ) -> bool:
        """Whether THIS identity may perform verb on resource (SSAR).

        Optional capability with a clean failure mode (``tpu-cc-ctl
        rbac-check`` reports it instead of crashing on AttributeError);
        RestKube implements the real apiserver call."""
        raise KubeApiError(
            None, "SelfSubjectAccessReview not supported by this client"
        )
