"""Checker 2: no ad-hoc waits.

The retry invariant: every wait in the agent rides ``utils/retry.py``
(jittered backoff ladders, ``poll_until`` deadlines, stop-aware waits) so
nothing sleeps unjittered, uninterruptible, or unaccounted. A direct
``time.sleep`` call anywhere outside ``utils/retry.py`` itself (and the
fault-injection layer, whose job is to simulate slowness) is an error.

The suite is covered too: an ad-hoc ``time.sleep`` in a test is the
flake factory — a fixed delay that races the scheduler on a loaded box.
Tests should ride ``retry.poll_until`` (wait for the condition, bounded)
or an event; a sleep that genuinely IS the test (simulated latency, a
real-clock lease TTL that must lapse) carries
``# cclint: test-sleep-ok(<reason>)`` on its line. The waiver is only
honored under ``tests/`` — package code has no such escape.

References that merely *name* the function (``sleep=time.sleep`` default
arguments) are not calls and are fine.
"""

from __future__ import annotations

import ast

from tpu_cc_manager_torch.lint.base import Finding, LintContext, SourceFile, qualname_of

CHECKER = "waits"

ALLOWED_FILES = ("tpu_cc_manager_torch/utils/retry.py",)
ALLOWED_DIRS = ("tpu_cc_manager_torch/faults/",)


def _is_time_sleep(call: ast.Call, from_time_names: set[str]) -> bool:
    fn = call.func
    if (
        isinstance(fn, ast.Attribute)
        and fn.attr == "sleep"
        and isinstance(fn.value, ast.Name)
        and fn.value.id in ("time", "_time")
    ):
        return True
    return isinstance(fn, ast.Name) and fn.id in from_time_names


def _check_file(src: SourceFile, in_tests: bool) -> list[Finding]:
    findings: list[Finding] = []
    # Names bound by `from time import sleep [as x]`.
    from_time: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "sleep":
                    from_time.add(alias.asname or alias.name)

    stack: list[ast.AST] = []

    def visit(node: ast.AST) -> None:
        is_scope = isinstance(
            node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
        )
        if is_scope:
            stack.append(node)
        if isinstance(node, ast.Call) and _is_time_sleep(node, from_time):
            # The waiver may sit on the call line, or on the line above
            # it when that line is a pure comment (an honest reason
            # rarely fits beside an indented call) — a waiver trailing
            # another statement never bleeds onto the next sleep.
            end = getattr(node, "end_lineno", node.lineno)
            waived = in_tests and src.annotation(
                node.lineno, "test-sleep-ok", span_end=end
            ) is not None
            if in_tests and not waived and node.lineno >= 2:
                above = src.lines[node.lineno - 2].strip()
                if above.startswith("#"):
                    waived = src.annotation(
                        node.lineno - 1, "test-sleep-ok"
                    ) is not None
            if not waived:
                symbol = qualname_of(stack)
                hint = (
                    "waits must ride utils/retry.py (poll_until / "
                    "RetryPolicy / stop-aware wait)"
                    if not in_tests else
                    "a fixed test sleep is the flake factory — "
                    "poll_until the condition, or waive with "
                    "`# cclint: test-sleep-ok(reason)` when the delay "
                    "IS the test"
                )
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=src.relpath,
                        line=node.lineno,
                        message=f"time.sleep in {symbol} — {hint}",
                        symbol=symbol,
                    )
                )
        for child in ast.iter_child_nodes(node):
            visit(child)
        if is_scope:
            stack.pop()

    visit(src.tree)
    return findings


def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for src in ctx.files:
        if src.relpath in ALLOWED_FILES or src.relpath.startswith(ALLOWED_DIRS):
            continue
        findings.extend(_check_file(src, in_tests=False))
    for src in ctx.test_files:
        findings.extend(_check_file(src, in_tests=True))
    return findings
