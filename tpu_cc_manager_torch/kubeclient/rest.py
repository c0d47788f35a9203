"""Real apiserver client over stdlib http.client + ssl.

Replaces the reference's external ``kubernetes`` package dependency
(requirements.txt, main.py:129-140). Supports the same two auth paths, in the
same order of preference: in-cluster service-account config, then kubeconfig
fallback (reference main.py:131-140).

Only the four verbs the control plane needs are implemented (see
:mod:`tpu_cc_manager_torch.kubeclient.api`); the watch uses the apiserver's
streaming JSON-lines protocol with server-side timeoutSeconds, matching the
reference's ``watch.Watch().stream(..., timeout_seconds=300)`` behavior
(main.py:622-632).
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import os
import ssl
import tempfile
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Iterator, Mapping

from tpu_cc_manager_torch.kubeclient.api import (
    RETRYABLE_STATUS,
    KubeApi,
    KubeApiError,
    WatchEvent,
    classify_kube_error,
)
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class ClusterConfig:
    """Where the apiserver is and how to authenticate to it."""

    server: str  # e.g. https://10.0.0.1:443
    token: str | None = None
    ca_file: str | None = None
    client_cert_file: str | None = None
    client_key_file: str | None = None
    insecure_skip_tls_verify: bool = False

    @classmethod
    def in_cluster(cls) -> "ClusterConfig":
        """Service-account config, present in every pod with a mounted SA."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token_path = os.path.join(SERVICEACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICEACCOUNT_DIR, "ca.crt")
        if not host or not os.path.exists(token_path):
            raise KubeApiError(None, "not running in-cluster")
        with open(token_path, "r", encoding="utf-8") as f:
            token = f.read().strip()
        return cls(
            server=f"https://{host}:{port}",
            token=token,
            ca_file=ca_path if os.path.exists(ca_path) else None,
        )

    @classmethod
    def from_kubeconfig(
        cls, path: str | None = None, context: str | None = None,
    ) -> "ClusterConfig":
        """Parse one context of a kubeconfig file — ``context`` names it,
        None means the file's current-context. Per-region federation
        shards (``--regions r1=ctx1,...``) select their cluster this way
        from a single shared kubeconfig.

        Supports token, client-certificate(-data)/client-key(-data), and
        insecure-skip-tls-verify — the auth shapes kind and GKE emit.
        """
        import yaml  # baked into the image; only needed on this path

        path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
        with open(path, "r", encoding="utf-8") as f:
            cfg = yaml.safe_load(f) or {}

        def by_name(section: str, name: str) -> dict:
            for item in cfg.get(section) or []:
                if item.get("name") == name:
                    return item.get(section.rstrip("s")) or {}
            raise KubeApiError(None, f"kubeconfig: {section} entry {name!r} not found")

        ctx_name = context or cfg.get("current-context")
        if not ctx_name:
            raise KubeApiError(None, "kubeconfig: no current-context")
        ctx = by_name("contexts", ctx_name)
        cluster = by_name("clusters", ctx.get("cluster", ""))
        user = by_name("users", ctx.get("user", ""))

        def materialize(data_key: str, file_key: str, src: dict) -> str | None:
            if src.get(file_key):
                return src[file_key]
            data = src.get(data_key)
            if not data:
                return None
            f = tempfile.NamedTemporaryFile(
                prefix="tpucc-kubeconfig-", suffix=".pem", delete=False
            )
            f.write(base64.b64decode(data))
            f.close()
            return f.name

        return cls(
            server=cluster.get("server", ""),
            token=user.get("token"),
            ca_file=materialize("certificate-authority-data", "certificate-authority", cluster),
            client_cert_file=materialize("client-certificate-data", "client-certificate", user),
            client_key_file=materialize("client-key-data", "client-key", user),
            insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify")),
        )

    @classmethod
    def load(
        cls, kubeconfig: str | None = None, context: str | None = None,
    ) -> "ClusterConfig":
        """In-cluster first, kubeconfig fallback (reference main.py:129-140).
        A named ``context`` skips the in-cluster probe outright: asking
        for a specific cluster and silently getting the local one is
        exactly the cross-region mixup per-region contexts exist to
        prevent."""
        if context:
            cfg = cls.from_kubeconfig(kubeconfig, context=context)
            log.info(
                "using kubeconfig at %s (context %s)",
                kubeconfig or "<default>", context,
            )
            return cfg
        try:
            cfg = cls.in_cluster()
            log.info("using in-cluster kubernetes configuration")
            return cfg
        except KubeApiError:
            cfg = cls.from_kubeconfig(kubeconfig)
            log.info("using kubeconfig at %s", kubeconfig or "<default>")
            return cfg


class RestKube(KubeApi):
    # Transient statuses worth one more try on the non-watch verbs; a watch
    # stream has its own reconnect loop in the caller (manager.py) and is
    # never retried here. (Kept as a class attribute for compatibility;
    # classification itself lives in kubeclient.api.classify_kube_error.)
    RETRYABLE_STATUS = RETRYABLE_STATUS
    # Caller-side policies collapse to one attempt against this client
    # (kubeclient.api.caller_retry_attempts): the ladder lives HERE.
    retries_internally = True

    def __init__(
        self,
        config: ClusterConfig,
        retry_attempts: int = 3,
        retry_base_delay_s: float = 0.5,
        retry_policy: retry_mod.RetryPolicy | None = None,
        breaker: retry_mod.CircuitBreaker | None = None,
        metrics=None,
    ):
        # Per-verb apiserver request accounting
        # (tpu_cc_apiserver_requests_total{verb}): every HTTP round trip
        # this client performs — retries included, since each one lands on
        # the apiserver — so the exported QPS is what the server actually
        # absorbs, not the logical call rate.
        from tpu_cc_manager_torch.utils import metrics as metrics_mod

        self.metrics = metrics if metrics is not None else metrics_mod.REGISTRY
        self.config = config
        self.retry_attempts = max(1, retry_attempts)
        self.retry_base_delay_s = retry_base_delay_s
        # The shared backoff policy (full jitter, Retry-After honoring);
        # injectable for tests/chaos. max_attempts rides per-call so the
        # legacy retry_attempts knob keeps working.
        self.retry_policy = retry_policy or retry_mod.RetryPolicy(
            max_attempts=self.retry_attempts,
            base_delay_s=retry_base_delay_s,
            max_delay_s=30.0,
        )
        # One breaker per client instance: a flapping apiserver fails fast
        # after the threshold instead of absorbing every caller's full
        # retry ladder. Generous threshold — the watch loop's own
        # consecutive-error cap (10) should normally fire first.
        self.breaker = breaker or retry_mod.CircuitBreaker(
            "apiserver", failure_threshold=12, recovery_time_s=15.0
        )
        self._ssl_ctx = self._build_ssl_context(config)

    @staticmethod
    def _build_ssl_context(config: ClusterConfig) -> ssl.SSLContext | None:
        if not config.server.startswith("https"):
            return None
        ctx = ssl.create_default_context(cafile=config.ca_file)
        if config.insecure_skip_tls_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if config.client_cert_file:
            ctx.load_cert_chain(config.client_cert_file, config.client_key_file)
        return ctx

    # ---- low-level HTTP --------------------------------------------------

    def _open(self, method: str, path: str, query: dict | None = None,
              body: bytes | None = None, content_type: str | None = None,
              read_timeout: float = 30.0):
        url = self.config.server.rstrip("/") + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(url, data=body, method=method)
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        if content_type:
            req.add_header("Content-Type", content_type)
        req.add_header("Accept", "application/json")
        try:
            return urllib.request.urlopen(req, timeout=read_timeout, context=self._ssl_ctx)
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace")[:512]
            except Exception:
                pass
            raise KubeApiError(
                e.code,
                f"{method} {path}: {detail or e.reason}",
                retry_after_s=retry_mod.parse_retry_after(
                    e.headers.get("Retry-After") if e.headers else None
                ),
            ) from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise KubeApiError(None, f"{method} {path}: {e}") from e

    _VERB_OF_METHOD = {
        "GET": "get", "PATCH": "patch", "PUT": "update",
        "POST": "create", "DELETE": "delete",
    }

    def _request_json(self, method: str, path: str, query: dict | None = None,
                      body: dict | None = None, content_type: str | None = None,
                      verb: str | None = None) -> dict:
        """One apiserver round trip through the shared retry policy
        (utils/retry.py: full jitter, Retry-After honoring) behind the
        apiserver circuit breaker. Only idempotent verbs (GET, label
        merge-patch) are retried — enforced here, not just documented, so a
        future non-idempotent route (e.g. a POST eviction) cannot silently
        inherit retry-after-ambiguous-failure. Client-side errors (4xx)
        propagate immediately — a 404/409 will not improve with
        repetition."""
        raw = json.dumps(body).encode() if body is not None else None
        retryable_verb = method in ("GET", "PATCH")
        counted_verb = verb or self._VERB_OF_METHOD.get(method, method.lower())

        def attempt() -> dict:
            try:
                self.breaker.before_call()
            except retry_mod.CircuitOpenError as e:
                # Same exception surface as any other transport failure
                # (callers already handle KubeApiError(None)) — but marked
                # so the classifier treats it as PERMANENT: sleeping
                # through a retry ladder against a known-open circuit
                # would defeat the fail-fast the breaker exists for.
                err = KubeApiError(None, str(e))
                err.circuit_open = True
                raise err from e
            # Counted only once the request demonstrably REACHED the
            # apiserver — a 2xx response, an HTTP error status, or a
            # failure while reading a response that started arriving. A
            # circuit-open refusal or connect-level failure (refused,
            # DNS, timeout: KubeApiError with status None) never got
            # there, and counting it would export phantom server QPS at
            # full retry speed during an outage — the exact signal the
            # metric's HELP text tells operators to read as real load.
            try:
                resp_cm = self._open(method, path, query, raw, content_type)
            except KubeApiError as e:
                if e.status is not None:
                    self.metrics.record_apiserver_request(counted_verb)
                verdict = classify_kube_error(e)
                if verdict is not None and verdict.transient:
                    self.breaker.record_failure()
                else:
                    # A definitive 4xx proves the apiserver is answering.
                    self.breaker.record_success()
                raise
            self.metrics.record_apiserver_request(counted_verb)
            try:
                with resp_cm as resp:
                    result = json.loads(resp.read().decode("utf-8"))
            except (OSError, ValueError, http.client.HTTPException) as e:
                # Failures AFTER the connection opened (reset mid-body,
                # IncompleteRead on a truncated stream, garbled JSON) are
                # transport flakes too: wrap them so the retry policy and
                # breaker see them instead of a raw exception escaping
                # both.
                self.breaker.record_failure()
                raise KubeApiError(
                    None, f"{method} {path}: response read failed: {e}"
                ) from e
            self.breaker.record_success()
            return result

        return self.retry_policy.call(
            attempt,
            op=f"kube.{method.lower()}",
            classify=classify_kube_error,
            max_attempts=self.retry_attempts if retryable_verb else 1,
        )

    # ---- KubeApi ---------------------------------------------------------

    def get_node(self, name: str) -> dict:
        return self._request_json("GET", f"/api/v1/nodes/{name}")

    def patch_node_labels(self, name: str, labels: Mapping[str, str | None]) -> dict:
        return self._request_json(
            "PATCH",
            f"/api/v1/nodes/{name}",
            body={"metadata": {"labels": dict(labels)}},
            content_type="application/merge-patch+json",
        )

    def patch_node_annotations(
        self, name: str, annotations: Mapping[str, str | None]
    ) -> dict:
        return self._request_json(
            "PATCH",
            f"/api/v1/nodes/{name}",
            body={"metadata": {"annotations": dict(annotations)}},
            content_type="application/merge-patch+json",
        )

    def patch_node_taints(
        self, name: str, add: list[dict], remove_keys: list[str]
    ) -> dict:
        """Read-modify-write of ``spec.taints`` (a list, so a merge-patch
        replaces it wholesale — the RMW keeps foreign taints intact). A
        concurrent writer between the GET and the PATCH loses its edit to
        ours; acceptable for the quarantine taint, whose only writers are
        this agent and the operator CLI, and the patch is idempotent."""
        node = self.get_node(name)
        taints = list((node.get("spec") or {}).get("taints") or [])
        doomed = set(remove_keys) | {t.get("key") for t in add}
        taints = [t for t in taints if t.get("key") not in doomed]
        taints.extend(dict(t) for t in add)
        return self._request_json(
            "PATCH",
            f"/api/v1/nodes/{name}",
            body={"spec": {"taints": taints}},
            content_type="application/merge-patch+json",
        )

    def list_nodes(self, label_selector: str | None = None) -> list[dict]:
        query: dict = {}
        if label_selector:
            query["labelSelector"] = label_selector
        return self._request_json(
            "GET", "/api/v1/nodes", query, verb="list"
        ).get("items", [])

    def list_nodes_page(
        self,
        label_selector: str | None = None,
        limit: int | None = None,
        continue_token: str | None = None,
    ) -> dict:
        """One chunk of the apiserver's paginated LIST protocol. The
        ``continue`` token is served from a consistent snapshot server-
        side; an expired token answers 410, which
        ``list_nodes_chunked``'s callers treat as "restart the listing"
        (the informer relist path)."""
        query: dict = {}
        if label_selector:
            query["labelSelector"] = label_selector
        if limit:
            query["limit"] = str(int(limit))
        if continue_token:
            query["continue"] = continue_token
        return self._request_json("GET", "/api/v1/nodes", query, verb="list")

    def list_pods(self, namespace: str, label_selector: str | None = None,
                  field_selector: str | None = None) -> list[dict]:
        query: dict = {}
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        return self._request_json(
            "GET", f"/api/v1/namespaces/{namespace}/pods", query, verb="list"
        ).get("items", [])

    def create_event(self, namespace: str, event: dict) -> dict:
        return self._request_json(
            "POST",
            f"/api/v1/namespaces/{namespace}/events",
            body=event,
            content_type="application/json",
        )

    # Lease verbs (coordination.k8s.io/v1). GET retries like any read;
    # POST/PUT/DELETE run exactly one attempt (the idempotent-verb gate in
    # _request_json): a PUT retried after an ambiguous first attempt would
    # 409 against its own write, and the lease renew loop is itself the
    # retry layer.

    @staticmethod
    def _lease_path(namespace: str, name: str | None = None) -> str:
        path = f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"
        return f"{path}/{name}" if name else path

    def get_lease(self, namespace: str, name: str) -> dict:
        return self._request_json("GET", self._lease_path(namespace, name))

    def create_lease(self, namespace: str, name: str, spec: dict) -> dict:
        return self._request_json(
            "POST",
            self._lease_path(namespace),
            body={
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": name, "namespace": namespace},
                "spec": dict(spec),
            },
            content_type="application/json",
        )

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict:
        return self._request_json(
            "PUT",
            self._lease_path(namespace, name),
            body=lease,
            content_type="application/json",
        )

    def delete_lease(self, namespace: str, name: str) -> None:
        self._request_json("DELETE", self._lease_path(namespace, name))

    def self_subject_access_review(
        self, verb: str, resource: str, namespace: str | None = None
    ) -> bool:
        """Ask the apiserver whether THIS identity may perform verb on
        resource (SelfSubjectAccessReview). Used by ``tpu-cc-ctl
        rbac-check`` to prove the DaemonSet RBAC covers every verb the
        agent needs before a rollout, instead of discovering a 403 mid-
        drain. POST, so never retried (the idempotent-verb gate in
        _request_json); SSAR is cheap and the caller just re-runs."""
        attrs: dict = {"verb": verb, "resource": resource}
        if namespace:
            attrs["namespace"] = namespace
        resp = self._request_json(
            "POST",
            "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews",
            body={
                "apiVersion": "authorization.k8s.io/v1",
                "kind": "SelfSubjectAccessReview",
                "spec": {"resourceAttributes": attrs},
            },
            content_type="application/json",
        )
        return bool(resp.get("status", {}).get("allowed", False))

    def watch_nodes(self, name: str, resource_version: str | None = None,
                    timeout_seconds: int = 300) -> Iterator[WatchEvent]:
        query = {
            "watch": "true",
            "fieldSelector": f"metadata.name={name}",
            "timeoutSeconds": str(timeout_seconds),
            # Bookmarks keep the tracked resourceVersion fresh on quiet
            # nodes, so reconnects don't 410-expire after etcd compaction;
            # the manager's loop handles the BOOKMARK event type.
            "allowWatchBookmarks": "true",
        }
        if resource_version:
            query["resourceVersion"] = resource_version
        return self._watch("/api/v1/nodes", query, timeout_seconds)

    def watch_nodes_pool(
        self,
        label_selector: str | None = None,
        resource_version: str | None = None,
        timeout_seconds: int = 300,
    ) -> Iterator[WatchEvent]:
        query = {
            "watch": "true",
            "timeoutSeconds": str(timeout_seconds),
            "allowWatchBookmarks": "true",
        }
        if label_selector:
            query["labelSelector"] = label_selector
        if resource_version:
            query["resourceVersion"] = resource_version
        return self._watch("/api/v1/nodes", query, timeout_seconds)

    def _watch(self, path: str, query: dict,
               timeout_seconds: int) -> Iterator[WatchEvent]:
        # Client-side read timeout a bit above the server-side one so the
        # server closes first in the normal case. Counted only once the
        # connect succeeded (or the server answered an HTTP error): a
        # refused connect never reached the apiserver.
        try:
            resp = self._open(
                "GET", path, query, read_timeout=timeout_seconds + 15
            )
        except KubeApiError as e:
            if e.status is not None:
                self.metrics.record_apiserver_request("watch")
            raise
        self.metrics.record_apiserver_request("watch")
        try:
            while True:
                try:
                    line = resp.readline()
                except (OSError, TimeoutError) as e:
                    raise KubeApiError(None, f"watch stream: {e}") from e
                if not line:
                    return  # server closed (timeout elapsed)
                line = line.strip()
                if not line:
                    continue
                try:
                    payload = json.loads(line)
                except json.JSONDecodeError as e:
                    raise KubeApiError(None, f"watch stream: bad JSON frame: {e}") from e
                yield WatchEvent(payload.get("type", "ERROR"), payload.get("object") or {})
        finally:
            resp.close()
