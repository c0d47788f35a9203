"""Checker 7: crash-point coverage — kill-at suites provably keep pace.

The kill-at-every-crash-point suites are this repo's strongest safety
evidence: the orchestrator names its crash points
(``self._crash_point("window-boundary")`` →
``FaultPlan.decide_orchestrator_kill``), the node pipeline marks journal
phases (``intents.mark(txn, PHASE_RESET)``), and the suites kill at each
one and prove the successor converges. That evidence rots silently: a
new crash point or phase mark added without a test is exactly the
crash ordering nobody ever exercised.

This checker closes the loop in both directions:

- **orphaned point** — a crash-point string passed to
  ``_crash_point(...)`` / ``decide_orchestrator_kill(...)`` in the
  package, or a journal phase passed to ``mark(...)``, that no test
  under ``tests/`` references (as the string literal, or as the
  ``PHASE_*`` constant name) fails the build. Waive a deliberately
  untested point with ``# cclint: crash-point-ok(<reason>)`` on the
  package line.
- **stale point** — a point name that only tests reference: a string in
  a test module's ``*CRASH_POINTS*`` declaration list, or a literal
  passed to ``decide_orchestrator_kill``/``_crash_point`` from a test,
  that no longer exists in the package. Dead coverage reads as
  coverage; it's a finding at the test line.

Tests claim coverage by *naming the literal* (a module-level
``ROLLING_CRASH_POINTS = [...]`` list that a runtime assertion ties to
the package's canonical tuple is the idiom — see
``tests/test_rollout_resume.py``). Dynamic constructions (f-strings,
index loops without names) are invisible to the static half on purpose:
the coverage contract is that the names are spelled out somewhere a
reviewer and this checker can both read.
"""

from __future__ import annotations

import ast
import re

from tpu_cc_manager_torch.lint.base import Finding, LintContext, SourceFile

CHECKER = "crashpoints"

#: Package functions whose first string argument names a crash point.
POINT_SINKS = ("_crash_point", "decide_orchestrator_kill")

#: Journal phase-mark sinks: second argument is the phase.
MARK_SINKS = ("mark", "_journal_mark")

#: Test-side declaration lists the stale check reads.
_DECL_RE = re.compile(r"CRASH_POINTS?")


def _call_sink_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _phase_constants(files: list[SourceFile]) -> dict[str, str]:
    """PHASE_* constant name -> string value, from module-level
    assignments anywhere in the package (intent_journal.py today)."""
    out: dict[str, str] = {}
    for src in files:
        for node in src.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("PHASE_")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                out[node.targets[0].id] = node.value.value
    return out


def _package_points(
    files: list[SourceFile], phase_consts: dict[str, str]
) -> dict[str, tuple[SourceFile, int, frozenset[str]]]:
    """point-key -> (src, line, accepted test tokens). Crash points are
    keyed by their literal; phase marks accept either the constant name
    or its value."""
    out: dict[str, tuple[SourceFile, int, frozenset[str]]] = {}
    value_to_const = {v: k for k, v in phase_consts.items()}
    for src in files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            sink = _call_sink_name(node)
            if sink in POINT_SINKS:
                args = node.args
                if args and isinstance(args[0], ast.Constant) and isinstance(
                    args[0].value, str
                ):
                    point = args[0].value
                    out.setdefault(
                        point, (src, node.lineno, frozenset((point,)))
                    )
            elif sink in MARK_SINKS and len(node.args) >= 2:
                phase = node.args[1]
                name = value = None
                if isinstance(phase, ast.Attribute) and phase.attr.startswith(
                    "PHASE_"
                ):
                    name = phase.attr
                    value = phase_consts.get(name)
                elif isinstance(phase, ast.Name) and phase.id.startswith(
                    "PHASE_"
                ):
                    name = phase.id
                    value = phase_consts.get(name)
                elif isinstance(phase, ast.Constant) and isinstance(
                    phase.value, str
                ):
                    value = phase.value
                    name = value_to_const.get(value)
                tokens = frozenset(t for t in (name, value) if t)
                if tokens:
                    key = value or name
                    out.setdefault(key, (src, node.lineno, tokens))
    return out


def _test_tokens(test_files: list[SourceFile]) -> set[str]:
    """Everything a test can reference a point by: every string literal
    plus every PHASE_*-shaped identifier."""
    out: set[str] = set()
    for src in test_files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                out.add(node.value)
            elif isinstance(node, ast.Attribute) and node.attr.startswith(
                "PHASE_"
            ):
                out.add(node.attr)
            elif isinstance(node, ast.Name) and node.id.startswith("PHASE_"):
                out.add(node.id)
    return out


def _test_claims(
    test_files: list[SourceFile],
) -> list[tuple[SourceFile, int, str]]:
    """(src, line, point) for every test-side point *claim*: entries of
    ``*CRASH_POINTS*`` declaration lists and literals passed to the
    point sinks from tests."""
    out: list[tuple[SourceFile, int, str]] = []
    for src in test_files:
        for node in src.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and _DECL_RE.search(node.targets[0].id)
                and isinstance(node.value, (ast.List, ast.Tuple, ast.Set))
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str
                    ):
                        out.append((src, elt.lineno, elt.value))
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) and _call_sink_name(
                node
            ) in POINT_SINKS:
                if node.args and isinstance(
                    node.args[0], ast.Constant
                ) and isinstance(node.args[0].value, str):
                    out.append((src, node.lineno, node.args[0].value))
    return out


def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    phase_consts = _phase_constants(ctx.files)
    points = _package_points(ctx.files, phase_consts)
    tokens = _test_tokens(ctx.test_files)

    # -- orphaned: package point no test names ----------------------------
    for key, (src, line, accepted) in sorted(points.items()):
        if accepted & tokens:
            continue
        if src.annotation(line, "crash-point-ok") is not None:
            continue
        findings.append(
            Finding(
                checker=CHECKER,
                path=src.relpath,
                line=line,
                message=(
                    f"crash point {key!r} has no kill-at test under "
                    "tests/ naming it — add it to the suite's "
                    "*_CRASH_POINTS list (and exercise it), or waive "
                    "with `# cclint: crash-point-ok(reason)`"
                ),
                symbol="orphaned-point",
                detail=key,
            )
        )

    # -- stale: test claim the package no longer makes --------------------
    known: set[str] = set()
    for _, (_, _, accepted) in points.items():
        known |= accepted
    # Phase constants remain claimable even where a mark site also
    # accepts them by value.
    known |= set(phase_consts) | set(phase_consts.values())
    for src, line, point in _test_claims(ctx.test_files):
        if point in known:
            continue
        findings.append(
            Finding(
                checker=CHECKER,
                path=src.relpath,
                line=line,
                message=(
                    f"test references crash point {point!r} which no "
                    "package code declares — dead coverage reads as "
                    "coverage; drop it or fix the name"
                ),
                symbol="stale-point",
                detail=point,
            )
        )
    return findings
