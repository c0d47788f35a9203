"""Opt-in runtime lock-order checker (``CC_LOCKCHECK=1``).

The static side of the lock contract (cclint's ``locks`` checker) proves
annotated fields are only touched under their lock; it cannot prove the
locks themselves are acquired in a consistent ORDER. A deadlock needs
two threads taking two locks in opposite orders — rare, timing-dependent,
and invisible to tests that happen not to interleave. This module makes
the inversion itself the failure, deterministically:

- Threaded modules create locks through :func:`make_lock` /
  :func:`make_rlock` with a stable name. With ``CC_LOCKCHECK`` unset
  (production) that returns a plain ``threading.Lock`` — zero overhead.
- With ``CC_LOCKCHECK=1`` (the chaos suites set it) every acquisition
  records the per-thread held stack and adds held→acquired edges to a
  process-wide order graph. An acquisition whose edge would close a
  cycle raises :class:`LockOrderError` **immediately, on the first
  inverted pair** — no deadlock, no timing, just the two chains that
  disagree.

Re-entrant acquisition (RLock) adds no self-edge. The checker's own
internal lock is a leaf by construction (nothing is acquired inside it).
"""

from __future__ import annotations

import os
import threading

LOCKCHECK_ENV = "CC_LOCKCHECK"


class LockOrderError(BaseException):
    """Two locks were acquired in opposite orders by (possibly) different
    threads — a deadlock waiting for the right interleaving.

    Derives from ``BaseException`` (like the chaos harness's modeled
    SIGKILL) on purpose: the agent is full of broad ``except Exception``
    resilience paths ("never fails a reconcile"), and an inversion report
    swallowed-and-retried by one of them would defeat the checker. A
    BaseException escapes them all and fails the suite deterministically."""


def lockcheck_enabled() -> bool:
    return os.environ.get(LOCKCHECK_ENV, "").lower() in ("1", "true", "yes")


class _OrderGraph:
    """Process-wide directed graph of observed lock orderings.

    Edge A→B = "A was held while B was acquired". Adding an edge that
    makes B reach A (a cycle) is the inversion; the error message carries
    both chains.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # lock name -> set of names acquired while it was held.
        self._edges: dict[str, set[str]] = {}  # cclint: guarded-by(_mu)
        self._held = threading.local()

    def held_stack(self) -> "list[CheckedLock]":
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = []
            self._held.stack = stack
        return stack

    def _path_locked(self, src: str, dst: str) -> list[str] | None:  # cclint: requires(_mu)
        """A directed path src→…→dst in the edge graph, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in sorted(self._edges.get(node, ())):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_acquire(self, lock: "CheckedLock") -> None:
        """Record edges held→lock; raise on a cycle-forming inversion.

        The path check and edge insertion happen under ONE critical
        section: two threads racing the actual deadlock interleaving
        (T1 holds A acquiring B, T2 holds B acquiring A) must not both
        snapshot an edge set that contains neither edge — whichever
        thread inserts second sees the first thread's edge and raises.
        """
        name = lock.name
        stack = self.held_stack()
        with self._mu:
            for held in stack:
                if held is lock:
                    if lock.reentrant:
                        continue  # re-entrant (RLock) re-acquisition
                    raise LockOrderError(
                        f"self-deadlock: re-acquiring non-reentrant lock "
                        f"{name!r} on the same thread"
                    )
                if held.name == name:
                    # A DIFFERENT instance sharing the name (per-node
                    # backends in a fleet test): a name-keyed graph
                    # cannot represent cross-instance order without a
                    # false self-cycle, so no edge is recorded.
                    continue
                # Would held→name close a cycle? Only if name already
                # reaches held.
                path = self._path_locked(name, held.name)
                if path is not None:
                    raise LockOrderError(
                        f"lock order inversion: acquiring {name!r} while "
                        f"holding {held.name!r}, but the order "
                        f"{' -> '.join(path)} was already observed — "
                        "two threads taking these in opposite orders will "
                        "deadlock"
                    )
                self._edges.setdefault(held.name, set()).add(name)
        stack.append(lock)

    def note_release(self, lock: "CheckedLock") -> None:
        stack = self.held_stack()
        # Remove the LAST occurrence (re-entrant releases unwind inner
        # first).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    def reset(self) -> None:
        """Tests only: drop all observed orderings."""
        with self._mu:
            self._edges.clear()


#: Process-wide graph shared by every checked lock.
GRAPH = _OrderGraph()


class CheckedLock:
    """A ``threading.Lock``/``RLock`` wrapper that reports acquisitions
    to the order graph. Context-manager and acquire/release compatible."""

    def __init__(self, name: str, reentrant: bool = False) -> None:
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Order is recorded BEFORE blocking: the inversion must surface
        # even when (especially when) the acquisition would deadlock.
        GRAPH.note_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if not got:
            GRAPH.note_release(self)
        return got

    def release(self) -> None:
        self._inner.release()
        GRAPH.note_release(self)

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        return bool(inner_locked()) if inner_locked is not None else False


def make_lock(name: str) -> "threading.Lock | CheckedLock":
    """A mutex for ``name`` — plain ``threading.Lock`` normally, a
    :class:`CheckedLock` under ``CC_LOCKCHECK=1``."""
    if lockcheck_enabled():
        return CheckedLock(name)
    return threading.Lock()


def make_rlock(name: str) -> "threading.RLock | CheckedLock":
    """Re-entrant variant of :func:`make_lock`."""
    if lockcheck_enabled():
        return CheckedLock(name, reentrant=True)
    return threading.RLock()
