"""Watch-driven informer cache: pool state at O(changes) apiserver cost.

Every pool-shaped decision used to re-list the pool: the rolling
orchestrator listed all nodes at every await poll and window boundary,
pool attestation listed per verification, the slice barrier listed its
peers once per second while waiting. Each of those listings is O(pool)
apiserver work and O(pool) response bytes — fine at 8 nodes, ruinous at
10k (ROADMAP open item #1). The per-node agent already had the answer in
miniature: its watch loop (manager.py) tracks a resourceVersion, rides
bookmarks, resyncs on 410 Gone and reconnects on a jittered ladder — but
only for its OWN node. :class:`NodeInformer` generalizes exactly that
machinery to a label selector:

- **one chunked list** (``limit``/``continue`` pagination, so a 10k-node
  pool arrives in bounded pages) establishes the cache and the
  resourceVersion to watch from;
- **one watch stream** per selector (``KubeApi.watch_nodes_pool``) keeps
  it fresh: ADDED/MODIFIED upsert, DELETED drops (a real apiserver
  delivers "stopped matching the selector" as DELETED — the cache must
  not serve a node that left the pool), BOOKMARK advances the
  resourceVersion on quiet pools so reconnects never 410-expire;
- **410 Gone** (immediate, or as an ERROR event) triggers a full relist —
  the same resync the agent's loop performs;
- transport errors reconnect on the shared jittered backoff ladder
  (utils/retry.py), capped, never giving up: a cache that silently died
  would be worse than no cache, so the thread runs until :meth:`stop`.

Consumers read the **thread-safe local index** — by node name and by
slice label — and block on :meth:`wait` for event-driven wakeups instead
of polling listings: an await loop wakes when the cache changes, checks
its predicate against local state, and costs the apiserver nothing.

Consistency contract (locked in by tests/test_informer.py): after the
stream has caught up, the cache equals a fresh ``list_nodes`` of the same
selector — under any seeded FaultPlan schedule of hangups, stale-rv 410s
and blackouts. Node dicts handed out by :meth:`list`/:meth:`get` are the
cache's own snapshots and MUST be treated as read-only (copying 10k nodes
per read would reintroduce the O(pool) cost client-side).
"""

from __future__ import annotations

import logging
import threading
import time

from tpu_cc_manager_torch.kubeclient.api import (
    KubeApi,
    KubeApiError,
    list_nodes_chunked,
    node_labels,
    resource_version,
)
from tpu_cc_manager_torch.labels import SLICE_ID_LABEL
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

DEFAULT_PAGE_LIMIT = 500
DEFAULT_WATCH_TIMEOUT_S = 300


class NodeInformer:
    """One list+watch per selector, with a thread-safe local index.

    ``version`` increments on every cache mutation; :meth:`wait` blocks
    until it moves past a caller-observed value (or a timeout), which is
    what turns polling loops into event-driven ones.
    """

    def __init__(
        self,
        api: KubeApi,
        selector: str | None = None,
        page_limit: int = DEFAULT_PAGE_LIMIT,
        watch_timeout_s: int = DEFAULT_WATCH_TIMEOUT_S,
        reconnect_delay_s: float = 1.0,
        reconnect_max_delay_s: float = 30.0,
        name: str | None = None,
    ) -> None:
        self.api = api
        self.selector = selector
        self.page_limit = page_limit
        self.watch_timeout_s = watch_timeout_s
        self.name = name or f"informer[{selector or '*'}]"
        self._reconnect_policy = retry_mod.RetryPolicy(
            base_delay_s=max(0.001, reconnect_delay_s),
            max_delay_s=max(reconnect_delay_s, reconnect_max_delay_s),
        )
        self._cond = threading.Condition()
        self._nodes: dict[str, dict] = {}  # cclint: guarded-by(_cond)
        self._by_slice: dict[str, set[str]] = {}  # cclint: guarded-by(_cond)
        self._slice_of: dict[str, str] = {}  # cclint: guarded-by(_cond)
        self._rv: str = ""  # cclint: guarded-by(_cond)
        self._version = 0  # cclint: guarded-by(_cond)
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Observability counters (tests and the scale bench read these).
        self.relists = 0
        self.events_seen = 0

    # ------------------------------------------------------------------
    # lifecycle

    def start(self, sync_timeout_s: float = 30.0) -> "NodeInformer":
        """Spawn the list+watch thread and block until the first listing
        populated the cache (or ``sync_timeout_s`` passes — callers that
        can make progress unsynced may pass 0)."""
        if self._thread is not None:
            return self
        # Capability probe, synchronous on purpose: the KubeApi default
        # for watch_nodes_pool raises its unsupported marker immediately
        # (it is not a generator), while real implementations hand back a
        # lazy stream with no side effects. Without this, a minimal
        # client's informer would sync once off the listing and then
        # silently serve stale state forever — worse than no cache.
        stream = self.api.watch_nodes_pool(
            self.selector, None, self.watch_timeout_s
        )
        close = getattr(stream, "close", None)
        if close is not None:
            close()
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True
        )
        self._thread.start()
        if sync_timeout_s:
            self.wait_for_sync(sync_timeout_s)
        return self

    def wait_for_sync(self, timeout_s: float = 30.0) -> bool:
        return self._synced.wait(timeout_s)

    def stop(self, join_timeout_s: float = 2.0) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
            self._thread = None

    def __enter__(self) -> "NodeInformer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # reads (thread-safe; returned dicts are read-only snapshots)

    @property
    def synced(self) -> bool:
        return self._synced.is_set()

    @property
    def version(self) -> int:
        with self._cond:
            return self._version

    def list(self) -> list[dict]:
        """Every cached node of the selector, name-sorted (deterministic
        like a listing)."""
        with self._cond:
            return [self._nodes[n] for n in sorted(self._nodes)]

    def get(self, name: str) -> dict | None:
        with self._cond:
            return self._nodes.get(name)

    def names(self) -> set[str]:
        with self._cond:
            return set(self._nodes)

    def slice_members(self, slice_value: str) -> list[dict]:
        """Cached nodes carrying ``SLICE_ID_LABEL == slice_value`` — the
        slice barrier's peer listing, served locally."""
        with self._cond:
            return [
                self._nodes[n]
                for n in sorted(self._by_slice.get(slice_value, ()))
                if n in self._nodes
            ]

    def wait(self, version: int, timeout_s: float) -> int:
        """Block until the cache moved past ``version`` (or the timeout);
        returns the current version either way. The event-driven
        replacement for a poll sleep: wake on change, re-check, repeat."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            while self._version <= version and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            return self._version

    def wait_for(self, predicate, timeout_s: float,
                 recheck_interval_s: float = 1.0) -> bool:
        """Deadline-bounded wait for ``predicate(self)``: evaluated now,
        then after every cache change (and at least every
        ``recheck_interval_s``, so a predicate depending on wall time
        still fires on a quiet pool)."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        version = -1
        while True:
            if predicate(self):
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._stop.is_set():
                return False
            version = self.wait(
                version if version >= 0 else self.version,
                min(remaining, recheck_interval_s),
            )

    # ------------------------------------------------------------------
    # the list+watch loop

    def _run(self) -> None:
        consecutive_errors = 0
        while not self._stop.is_set():
            try:
                with self._cond:
                    rv = self._rv
                if not self._synced.is_set() or not rv:
                    self._relist()
                    with self._cond:
                        rv = self._rv
                for event in self.api.watch_nodes_pool(
                    self.selector, rv or None, self.watch_timeout_s
                ):
                    if self._stop.is_set():
                        return
                    if event.type == "ERROR":
                        code = (event.object or {}).get("code")
                        if code == 410:
                            raise KubeApiError(410, "watch ERROR event: Gone")
                        raise KubeApiError(
                            None, f"watch ERROR event: {event.object}"
                        )
                    consecutive_errors = 0
                    self.events_seen += 1
                    erv = resource_version(event.object)
                    if event.type == "BOOKMARK":
                        # Bookmarks carry only metadata.resourceVersion:
                        # track it (that is their whole point) and move on
                        # — upserting would wipe the node's labels.
                        if erv:
                            with self._cond:
                                self._rv = erv
                        continue
                    self._apply(event.type, event.object, erv)
                # Stream ended normally (server-side timeout): reconnect
                # from the tracked rv.
            except Exception as e:
                if self._stop.is_set():
                    return
                consecutive_errors += 1
                if isinstance(e, KubeApiError) and e.status == 410:
                    log.info(
                        "%s: resourceVersion expired; relisting", self.name
                    )
                    # Force a relist on the next loop pass; the relist
                    # itself may fail transiently and rides the ladder.
                    with self._cond:
                        self._rv = ""
                    if consecutive_errors > 1:
                        # A LONE 410 relists immediately (the normal
                        # compaction resync). Back-to-back 410s mean the
                        # relist→watch cycle itself keeps expiring (e.g.
                        # a chunked listing slower than the watch-cache
                        # window): without a throttle that loop is an
                        # unsleeping full-relist hammer — the exact
                        # O(pool) load the cache exists to remove.
                        if self._stop.wait(self._reconnect_policy.delay_for(
                            min(consecutive_errors - 2, 16)
                        )):
                            return
                    continue
                if not isinstance(e, KubeApiError):
                    # A shape bug in an event, a non-numeric per-object rv
                    # in _relist's fallback — anything unexpected. Letting
                    # it kill the thread would freeze the cache with
                    # ``synced`` still true (the exact silent death the
                    # module docstring forbids), so: log loudly, distrust
                    # any half-applied state, and relist from scratch on
                    # the next pass.
                    log.exception(
                        "%s: unexpected error in informer loop (%d "
                        "consecutive); forcing relist", self.name,
                        consecutive_errors,
                    )
                    with self._cond:
                        self._rv = ""
                delay = self._reconnect_policy.delay_for(
                    min(max(0, consecutive_errors - 1), 16)
                )
                log.warning(
                    "%s: watch error (%d consecutive): %s — reconnecting "
                    "in %.2fs", self.name, consecutive_errors, e, delay,
                )
                if self._stop.wait(delay):
                    return

    def _relist(self) -> None:
        items, rv = list_nodes_chunked(
            self.api, self.selector, limit=self.page_limit
        )
        self.relists += 1
        with self._cond:
            self._nodes = {n["metadata"]["name"]: n for n in items}
            self._rebuild_slice_index()
            # A fake/minimal client's listing may carry no rv; fall back
            # to the highest per-object rv so the follow-up watch resumes
            # from the listed state instead of replaying history.
            if not rv:
                rv = str(
                    max(
                        (
                            int(resource_version(n) or 0)
                            for n in items
                        ),
                        default=0,
                    )
                    or ""
                )
            self._rv = rv
            self._version += 1
            self._cond.notify_all()
        self._synced.set()
        log.info(
            "%s: listed %d node(s) at rv=%s", self.name, len(items), rv
        )

    def _apply(self, etype: str, node: dict, rv: str) -> None:
        name = (node.get("metadata") or {}).get("name")
        if not name:
            return
        with self._cond:
            if etype == "DELETED":
                self._nodes.pop(name, None)
            else:
                self._nodes[name] = node
            self._rebuild_slice_entry(name, node, deleted=etype == "DELETED")
            if rv:
                self._rv = rv
            self._version += 1
            self._cond.notify_all()

    def _rebuild_slice_index(self) -> None:  # cclint: requires(_cond)
        self._by_slice = {}
        self._slice_of = {}
        for name, node in self._nodes.items():
            sid = node_labels(node).get(SLICE_ID_LABEL)
            if sid:
                self._slice_of[name] = sid
                self._by_slice.setdefault(sid, set()).add(name)

    def _rebuild_slice_entry(self, name: str, node: dict, deleted: bool) -> None:  # cclint: requires(_cond)
        # O(1) per event via the reverse map — a 10k-node pool must not
        # pay an O(slices) scan per watch event.
        old = self._slice_of.pop(name, None)
        if old is not None:
            members = self._by_slice.get(old)
            if members is not None:
                members.discard(name)
                if not members:
                    del self._by_slice[old]
        if not deleted:
            sid = node_labels(node).get(SLICE_ID_LABEL)
            if sid:
                self._slice_of[name] = sid
                self._by_slice.setdefault(sid, set()).add(name)
