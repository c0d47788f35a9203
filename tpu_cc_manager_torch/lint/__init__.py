"""cclint: contract-aware static analysis for this repo's safety invariants.

Robustness work accumulated safety contracts that lived only as prose in
CHANGES.md and reviewer memory. Each checker here machine-checks one of
them over the package's own source (stdlib ``ast`` only). v2 upgraded
the engine from per-file lexical checks to flow-aware analysis:
:mod:`tpu_cc_manager_torch.lint.flow` builds a per-function CFG and resolves
the intra-class/intra-module call graph, so the checkers prove the
invariants where they actually live — across call chains and threads.

``locks``
    Shared fields annotated ``# cclint: guarded-by(<lock>)`` at their
    ``__init__`` assignment may only be touched inside a
    ``with self.<lock>:`` block elsewhere in the class, or in a method
    annotated ``# cclint: requires(<lock>)`` — and ``requires`` is now
    VERIFIED at every same-class call site, bare references of
    ``requires`` methods (thread targets) are findings, and an
    unannotated private helper is judged by its callers' lock context.
``waits``
    ``time.sleep`` outside ``utils/retry.py`` / ``faults/`` is an error —
    every wait rides the shared retry/backoff layer (the retry
    invariant). Now covers ``tests/`` too (the ad-hoc test sleep is the
    flake factory), with ``# cclint: test-sleep-ok(<reason>)`` waivers.
``crash``
    A handler that can catch ``BaseException`` (bare ``except:`` or
    explicit) must re-raise it; the kill-at-every-crash-point suites
    depend on modeled SIGKILL escaping every cleanup path. A handler that
    intentionally captures (worker threads re-raising at join) carries
    ``# cclint: crash-ok(<reason>)``.
``journal``
    Journal typestate, proven on the CFG: every ``backend.reset`` /
    ``backend.restart_runtime`` must be dominated by an intent-begin
    write on every path (interprocedurally — tokens carry their callers'
    proof), and a begun intent must be closed on every non-crash exit.
    The old reviewed allowlist survives only as a waiver of last resort
    (currently empty).
``fenced``
    Fenced-write taint: once a ``RolloutLease`` is acquired, every
    apiserver write must flow through ``FencedKube`` — a raw-client
    write reachable inside the lease bracket (including through a
    callee) is the CAS-bypass bug class, and a finding.
``crashpoints``
    Crash-point coverage: every named orchestrator crash point and
    journal phase mark must be named by at least one kill-at test under
    ``tests/``, and point names only tests still reference are stale.
``surface``
    Contract-surface drift: every ``CC_*`` env read must appear in the
    docs/operations.md env table, every ``CC_*`` env the daemonset sets
    must be read somewhere in code, every emitted metric family must be
    seeded through the exposition lint's live-registry render and
    documented, and every ``cloud.google.com/tpu-cc.*`` /
    ``tpu-cc.gke.io`` label/annotation key must come from ``labels.py``,
    never an inline literal.

The driver (``python -m tpu_cc_manager_torch.lint``) runs every checker plus
the Prometheus exposition lint (:mod:`tpu_cc_manager_torch.lint.expo`, the
former ``hack/check_metrics_lint.py`` — the old entrypoint remains as a
shim), emits human or ``--json`` output (plus a ``--changed-only
<git-ref>`` fast review mode), and compares findings against the
committed baseline (``lint/cclint-baseline.json``): grandfathered
violations are explicit, each with a reason; any NEW finding — or any
STALE baseline entry — fails the build. The static passes pair with an
opt-in runtime lock-order checker (``CC_LOCKCHECK=1``,
:mod:`tpu_cc_manager_torch.utils.locks`).
"""

from tpu_cc_manager_torch.lint.base import Finding, LintContext  # noqa: F401
