"""Node-local write-ahead intent log + disconnected-mode state.

Every durable record the agent relied on before this module — mode/ready
state labels, the remediation annotation, barrier markers, the rollout
record — lives in the apiserver. A node that loses the control plane mid
hardware transition (or is SIGKILLed while disconnected) restarted with no
authoritative record of what it was doing to the chips. The reference's
core discipline is "read truth back from the hardware" (main.py:524-528);
extending that to *crash* truth requires a node-local, crash-consistent
journal — the same move kubelet makes with its checkpoint store.

The journal lives in the backend's state dir (the writable host mount that
already stages ``CC_RUNTIME_ENV_FILE``), one record per line::

    TCCJ1 <crc32-hex8> {"seq": N, "t": "intent", ...}\n

- **CRC-framed**: the crc32 covers the JSON payload bytes; a record whose
  frame doesn't verify ends the readable prefix.
- **fsync'd, append-only**: every append is written and fsync'd before the
  hardware-effecting operation it describes runs, so the journal can claim
  *intent happened-before effect*.
- **Torn-tail truncation on replay**: a crash mid-append leaves a partial
  (or CRC-failing) final record; replay truncates the file back to the
  last verifiable record and carries on. Corruption strictly *mid*-file
  (verifiable records FOLLOW the bad bytes — bit rot, not a torn write)
  is not silently skipped: replay fails closed (:class:`JournalCorrupt`),
  the caller feeds the remediation ladder, and the corrupt file is moved
  aside so the node re-derives state from hardware truth alone.

Record grammar (the ``t`` field):

==================  ======================================================
``intent``          a hardware-effecting operation is about to start
                    (``kind=transition``: the stage/reset/verify pipeline;
                    ``kind=drain``: the pause/readmit bracket — the paused
                    set itself lives in the node's pause-encoded labels,
                    so recovery restores it with one readmit once the
                    apiserver answers; ``kind=handoff``: a preemption
                    notice interrupted an in-flight transition — the same
                    record is also published to the node's handoff
                    annotation, because a preempted VM's DISK dies with
                    it and the replacement node can only read the
                    apiserver copy)
``mark``            phase progress inside an open intent (``staged`` →
                    ``reset``), so replay knows whether the disruptive
                    reset had begun
``commit``/``abort``  the intent finished / was rolled back
``desired``         the last desired mode this agent acted on — boot-time
                    local truth when the apiserver is unreachable
``patch``           a node-label write deferred while disconnected
                    (flushed idempotently on reconnect — RMW, not blind
                    replay)
``flushed``         every ``patch`` at or below this seq has been flushed
==================  ======================================================

:class:`OfflineTracker` is the disconnected-mode ladder's clock: after
``CC_OFFLINE_GRACE_S`` of *total* apiserver outage (transport-level
failures only — a 403 is not an outage) the agent keeps serving its
last-known desired mode and defers label writes into the journal.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib

from tpu_cc_manager_torch.utils import locks as locks_mod

log = logging.getLogger(__name__)

MAGIC = "TCCJ1"
JOURNAL_FILE = "intent.journal"
# Compact (rewrite with only live state) when the file outgrows this.
DEFAULT_MAX_BYTES = 1 << 20

OFFLINE_GRACE_ENV = "CC_OFFLINE_GRACE_S"
DEFAULT_OFFLINE_GRACE_S = 60.0

# Transition phases, in pipeline order. Replay's decision table:
#   phase < reset  -> nothing disruptive ran; roll BACK (abort, clear staged)
#   phase >= reset -> the reset may have committed; ask the hardware —
#                     complete if every chip reports the intended mode,
#                     otherwise the reset provably didn't land (tpuvm's
#                     pending markers report 'resetting') and the normal
#                     reconcile re-applies: never a duplicate device reset.
PHASE_BEGUN = "begun"
PHASE_STAGED = "staged"
PHASE_RESET = "reset"
#: Mark on a DRAIN intent: the pipelined readmit was kicked off while
#: the smoke workload runs (readmit ∥ smoke). Purely diagnostic — drain
#: recovery keys on the intent being open, not its phase — but a
#: crash-dump reader can tell "died before any readmit started" from
#: "died with the readmit in flight".
PHASE_READMIT = "readmit"

# Intent kinds (the ``kind`` field of t=intent records).
KIND_TRANSITION = "transition"
KIND_DRAIN = "drain"
#: A preemption notice interrupted an in-flight transition: the agent
#: journals it locally (crash truth if the preemption is cancelled) AND
#: mirrors it to the node's handoff annotation (ccmanager/manager.py
#: HANDOFF_ANNOTATION) — the replacement VM has a fresh disk, so the
#: apiserver copy is the only record that survives the reclaim.
KIND_HANDOFF = "handoff"
#: A remediation-ladder hardware rung (device re-reset / runtime restart,
#: ccmanager/remediation.py) — journaled like any hardware-effecting
#: operation (the cclint journal-before-reset contract). Replay found one
#: open = the agent died mid-rung: the backend's own pending markers and
#: the persisted ladder annotation already carry the recovery state, so
#: the intent is simply closed and the normal reconcile re-drives.
KIND_REMEDIATION = "remediation"


class JournalCorrupt(Exception):
    """Replay found verifiable records AFTER unverifiable bytes — not a
    torn tail but real corruption. The journal cannot be trusted as a
    prefix; callers fail closed into the remediation ladder."""


class JournalError(Exception):
    """The journal file could not be written (disk fault, read-only
    mount). Hardware-effecting callers must treat this like any other
    failed precondition: no intent record, no transition."""


def _frame(payload: dict) -> bytes:
    data = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    raw = data.encode("utf-8")
    return f"{MAGIC} {zlib.crc32(raw) & 0xFFFFFFFF:08x} ".encode() + raw + b"\n"


def _parse_line(line: bytes) -> dict | None:
    """Decode one framed record; None when the frame doesn't verify."""
    try:
        head, crc_hex, raw = line.split(b" ", 2)
    except ValueError:
        return None
    if head != MAGIC.encode() or len(crc_hex) != 8:
        return None
    try:
        crc = int(crc_hex, 16)
    except ValueError:
        return None
    if zlib.crc32(raw) & 0xFFFFFFFF != crc:
        return None
    try:
        rec = json.loads(raw)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(rec, dict) or not isinstance(rec.get("seq"), int):
        return None
    return rec


class ReplayResult:
    """What a replay recovered: the verifiable record prefix and how many
    bytes of torn tail were truncated."""

    def __init__(self, records: list[dict], truncated_bytes: int):
        self.records = records
        self.truncated_bytes = truncated_bytes


class IntentJournal:
    """Crash-consistent intent log. Thread-safe (the watch loop journals
    transitions while the watchdog defers patches)."""

    def __init__(
        self,
        path: str,
        max_bytes: int = DEFAULT_MAX_BYTES,
        fsync: bool = True,
    ) -> None:
        self.path = path
        self.max_bytes = max_bytes
        self._fsync = fsync
        self._lock = locks_mod.make_rlock("intent-journal")
        self._fd: int | None = None  # cclint: guarded-by(_lock)
        self._seq = 0  # cclint: guarded-by(_lock)
        self._txn_counter = 0  # cclint: guarded-by(_lock)
        # Live state, maintained on every append so readers (the /journalz
        # endpoint, recovery) never re-parse the file.
        self._open_intents: dict[str, dict] = {}  # cclint: guarded-by(_lock)
        self._pending_patches: list[dict] = []  # t=patch records  # cclint: guarded-by(_lock)
        self._flushed_upto = 0  # cclint: guarded-by(_lock)
        self._last_desired: str | None = None  # cclint: guarded-by(_lock)
        self._tail: list[dict] = []  # bounded recent-record window  # cclint: guarded-by(_lock)
        self.last_replay: dict | None = None
        # Chaos hook (faults/plan.py disk-fault mode): the next N appends
        # raise JournalError as if the state-dir disk faulted mid-write.
        self.fail_appends = 0

    @classmethod
    def from_state_dir(cls, state_dir: str, **kwargs) -> "IntentJournal":
        return cls(os.path.join(state_dir, JOURNAL_FILE), **kwargs)

    # ---- low-level append -------------------------------------------------

    def _ensure_open(self) -> int:  # cclint: requires(_lock)
        if self._fd is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fd = os.open(
                self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o600
            )
        return self._fd

    def _append(self, record: dict) -> dict:
        with self._lock:
            if self.fail_appends:
                self.fail_appends -= 1
                raise JournalError(
                    f"injected disk fault writing {self.path}"
                )
            self._seq += 1
            record = {"seq": self._seq, "ts": round(time.time(), 3), **record}
            frame = _frame(record)
            try:
                fd = self._ensure_open()
                os.write(fd, frame)
                if self._fsync:
                    os.fsync(fd)
            except OSError as e:
                # A journal that cannot persist must not pretend it did:
                # the in-memory seq rolls back and the caller decides
                # whether the operation may proceed unjournaled.
                self._seq -= 1
                self._close_fd()
                raise JournalError(f"could not append to {self.path}: {e}") from e
            self._apply(record)
            return record

    def _close_fd(self) -> None:  # cclint: requires(_lock)
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    def _apply(self, rec: dict) -> None:  # cclint: requires(_lock)
        """Fold one record into the live state (append and replay share
        this, so recovery sees exactly what a running agent would)."""
        t = rec.get("t")
        if t == "intent":
            self._open_intents[rec["txn"]] = dict(rec)
        elif t == "mark":
            intent = self._open_intents.get(rec.get("txn", ""))
            if intent is not None:
                intent["phase"] = rec.get("phase")
        elif t in ("commit", "abort"):
            self._open_intents.pop(rec.get("txn", ""), None)
        elif t == "desired":
            self._last_desired = rec.get("mode")
        elif t == "patch":
            self._pending_patches.append(rec)
        elif t == "flushed":
            upto = rec.get("upto", 0)
            self._flushed_upto = max(self._flushed_upto, upto)
            self._pending_patches = [
                p for p in self._pending_patches if p["seq"] > upto
            ]
        self._tail.append(rec)
        if len(self._tail) > 64:
            del self._tail[: len(self._tail) - 64]

    # ---- replay -----------------------------------------------------------

    def replay(self) -> ReplayResult:
        """Read the journal back, truncate a torn tail, fail closed on
        mid-file corruption, and rebuild the live state. Call once at
        startup, before the first apiserver read."""
        with self._lock:
            self._close_fd()
            try:
                with open(self.path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                self.last_replay = {"records": 0, "truncated_bytes": 0}
                return ReplayResult([], 0)
            records: list[dict] = []
            good_end = 0  # byte offset one past the last verifiable record
            offset = 0
            corrupt_at: int | None = None
            last_seq = 0
            # Only COMPLETE (newline-terminated) lines are parseable: a
            # final fragment with no newline is always a torn tail, even
            # when its CRC happens to verify — accepting it would leave
            # the file ending mid-line, and the next append would glue a
            # fresh record onto it, turning a benign torn write into
            # mid-file corruption at the replay after that.
            lines = data.split(b"\n")
            lines.pop()  # bytes after the last newline ('' when none)
            for line in lines:
                line_end = offset + len(line) + 1  # +1 for the newline
                if line:
                    rec = _parse_line(line)
                    if rec is not None and rec["seq"] <= last_seq:
                        # A CRC-VALID record whose seq does not strictly
                        # increase can only be a duplicated or reordered
                        # record — a torn write cannot produce one (the
                        # CRC frame would not verify). Truncating here
                        # would silently discard real later records, so
                        # this always fails closed.
                        self._quarantine_file()
                        raise JournalCorrupt(
                            f"{self.path}: record at byte {offset} has "
                            f"seq {rec['seq']} <= {last_seq} — duplicated "
                            "or reordered records, not a torn tail"
                        )
                    if rec is None:
                        if corrupt_at is None:
                            corrupt_at = offset
                    elif corrupt_at is not None:
                        # Verifiable records after unverifiable bytes:
                        # this is not a torn tail. Move the file aside so
                        # the next boot starts clean, then fail closed.
                        self._quarantine_file()
                        raise JournalCorrupt(
                            f"{self.path}: unverifiable record at byte "
                            f"{corrupt_at} followed by verifiable data at "
                            f"byte {offset} — not a torn tail"
                        )
                    else:
                        records.append(rec)
                        last_seq = rec["seq"]
                        good_end = line_end
                offset = line_end
            truncated = len(data) - good_end
            if truncated:
                log.warning(
                    "intent journal %s: truncating %d byte(s) of torn tail "
                    "after %d verifiable record(s)",
                    self.path, truncated, len(records),
                )
                with open(self.path, "r+b") as f:
                    f.truncate(good_end)
                    if self._fsync:
                        os.fsync(f.fileno())
            # Rebuild live state from the verified prefix.
            self._open_intents = {}
            self._pending_patches = []
            self._flushed_upto = 0
            self._last_desired = None
            self._tail = []
            self._seq = last_seq
            for rec in records:
                self._apply(rec)
            self.last_replay = {
                "records": len(records),
                "truncated_bytes": truncated,
            }
            return ReplayResult(records, truncated)

    def _quarantine_file(self) -> None:
        try:
            os.replace(self.path, self.path + ".corrupt")
            log.error(
                "intent journal failed closed; corrupt file moved to %s",
                self.path + ".corrupt",
            )
        except OSError as e:
            log.error("could not move corrupt journal aside: %s", e)

    # ---- transaction API --------------------------------------------------

    def begin(self, kind: str, **fields) -> str:
        """Journal an intent BEFORE its first hardware-effecting step;
        returns the transaction id."""
        with self._lock:
            self._txn_counter += 1
            txn = f"{kind}-{self._seq + 1}-{self._txn_counter}"
        self._append(
            {"t": "intent", "txn": txn, "kind": kind,
             "phase": PHASE_BEGUN, **fields}
        )
        return txn

    def mark(self, txn: str, phase: str) -> None:
        self._append({"t": "mark", "txn": txn, "phase": phase})

    def commit(self, txn: str, **fields) -> None:
        self._append({"t": "commit", "txn": txn, **fields})
        self._maybe_compact()

    def abort(self, txn: str, **fields) -> None:
        self._append({"t": "abort", "txn": txn, **fields})
        self._maybe_compact()

    def open_intents(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            intents = sorted(
                self._open_intents.values(), key=lambda r: r["seq"]
            )
            if kind is not None:
                intents = [i for i in intents if i.get("kind") == kind]
            return [dict(i) for i in intents]

    def close_open(self, kind: str, **fields) -> int:
        """Commit every open intent of ``kind`` (e.g. a drain bracket the
        idempotent readmit path just restored). Returns how many closed."""
        closed = 0
        for intent in self.open_intents(kind):
            self.commit(intent["txn"], **fields)
            closed += 1
        return closed

    # ---- desired-mode + deferred patches ---------------------------------

    @property
    def last_desired_mode(self) -> str | None:
        with self._lock:
            return self._last_desired

    def note_desired(self, mode: str) -> None:
        """Remember the desired mode the agent is acting on — boot-time
        local truth while the apiserver is dark. Deduplicated."""
        with self._lock:
            if mode == self._last_desired:
                return
        self._append({"t": "desired", "mode": mode})

    def defer_patch(self, labels: dict) -> None:
        """Journal a node-label write the apiserver refused while
        disconnected; flushed by :meth:`pending_patches` consumers on
        reconnect."""
        self._append({"t": "patch", "labels": dict(labels)})

    def has_pending_patches(self) -> bool:
        with self._lock:
            return bool(self._pending_patches)

    def pending_patches(self) -> dict:
        """The deferred label writes, merged in journal order (last write
        to a key wins — exactly the state the labels would hold had every
        patch landed)."""
        return self.pending_snapshot()[0]

    def pending_snapshot(self) -> tuple[dict, int]:
        """(merged pending patches, max seq included). Flush consumers
        pass that seq to :meth:`patches_flushed` so a patch deferred
        concurrently — AFTER the snapshot — is not marked flushed without
        ever being written."""
        with self._lock:
            merged: dict = {}
            upto = 0
            for rec in self._pending_patches:
                merged.update(rec.get("labels") or {})
                upto = max(upto, rec["seq"])
            return merged, upto

    def patches_flushed(self, upto: int | None = None) -> None:
        if upto is None:
            with self._lock:
                upto = self._seq
        self._append({"t": "flushed", "upto": upto})
        self._maybe_compact()

    # ---- compaction -------------------------------------------------------

    def _maybe_compact(self) -> None:
        with self._lock:
            try:
                if os.path.getsize(self.path) <= self.max_bytes:
                    return
            except OSError:
                return
            try:
                self.compact()
            except JournalError as e:
                # Compaction is an optimization: the triggering append
                # already landed, so its caller must not see a failure.
                # The next intent close retries.
                log.warning("journal compaction failed; will retry: %s", e)

    def compact(self) -> None:
        """Rewrite the journal with only live state (open intents,
        unflushed patches, last desired mode), atomically."""
        with self._lock:
            records: list[dict] = []
            for intent in sorted(
                self._open_intents.values(), key=lambda r: r["seq"]
            ):
                records.append({k: v for k, v in intent.items() if k != "seq"})
            if self._last_desired is not None:
                records.append({"t": "desired", "mode": self._last_desired})
            records.extend(
                {"t": "patch", "labels": rec.get("labels") or {}}
                for rec in self._pending_patches
            )
            tmp = self.path + ".tmp"
            seq = 0
            renumbered: list[dict] = []
            for rec in records:
                seq += 1
                renumbered.append({"seq": seq, **rec})
            try:
                with open(tmp, "wb") as f:
                    f.write(b"".join(_frame(r) for r in renumbered))
                    f.flush()  # drain the BufferedWriter BEFORE the fsync
                    if self._fsync:
                        os.fsync(f.fileno())
                os.replace(tmp, self.path)
                if self._fsync:
                    dir_fd = os.open(
                        os.path.dirname(self.path) or ".", os.O_RDONLY
                    )
                    try:
                        os.fsync(dir_fd)
                    finally:
                        os.close(dir_fd)
            except OSError as e:
                raise JournalError(
                    f"could not compact {self.path}: {e}"
                ) from e
            self._close_fd()
            # Rebuild live state from the renumbered records (semantically
            # unchanged — txn ids are preserved; only seqs moved).
            self._seq = seq
            self._flushed_upto = 0
            self._open_intents = {}
            self._pending_patches = []
            self._tail = []
            for rec in renumbered:
                self._apply(rec)

    # ---- introspection ----------------------------------------------------

    def snapshot(self) -> dict:
        """The live journal as JSON for the /journalz debug endpoint and
        ``tpu-cc-ctl journal``."""
        with self._lock:
            return {
                "path": self.path,
                "seq": self._seq,
                "last_desired_mode": self._last_desired,
                "open_intents": self.open_intents(),
                "pending_patches": self.pending_patches(),
                "pending_patch_records": len(self._pending_patches),
                "last_replay": self.last_replay,
                "recent": [dict(r) for r in self._tail],
            }


class OfflineTracker:
    """Connectivity clock for the disconnected-mode ladder.

    Transport-level apiserver failures (connection resets — a total
    outage's signature) start the clock; any success resets it. Once the
    outage has lasted ``grace_s`` the tracker is *engaged*: the agent
    keeps serving its last-known desired mode and defers label writes
    into the journal instead of failing reconciles against a dead
    control plane. ``grace_s <= 0`` disables engagement entirely.
    """

    def __init__(self, grace_s: float | None = None, clock=time.monotonic):
        if grace_s is None:
            grace_s = float(
                os.environ.get(OFFLINE_GRACE_ENV, str(DEFAULT_OFFLINE_GRACE_S))
            )
        self.grace_s = grace_s
        self._clock = clock
        self._down_since: float | None = None

    def note_failure(self) -> None:
        if self._down_since is None:
            self._down_since = self._clock()

    def note_success(self) -> bool:
        """Returns True when this success ENDED an engaged outage (the
        caller flushes deferred patches on that edge)."""
        was_engaged = self.engaged
        self._down_since = None
        return was_engaged

    @property
    def connected(self) -> bool:
        return self._down_since is None

    @property
    def offline_seconds(self) -> float:
        if self._down_since is None:
            return 0.0
        return max(0.0, self._clock() - self._down_since)

    @property
    def engaged(self) -> bool:
        return self.grace_s > 0 and self.offline_seconds >= self.grace_s


def is_outage_error(e: BaseException) -> bool:
    """Whether an apiserver failure looks like a total outage (transport-
    level: connection refused/reset, no HTTP status). A 403 or 404 is a
    server that answered — not an outage, and never grounds to engage
    disconnected mode."""
    from tpu_cc_manager_torch.kubeclient.api import KubeApiError

    return isinstance(e, KubeApiError) and e.status is None
