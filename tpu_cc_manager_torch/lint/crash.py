"""Checker 3: a crash stays a crash.

Every kill-at-every-crash-point suite (rollout resume, pipeline,
intent-journal replay) models SIGKILL as a ``BaseException`` that is NOT
an ``Exception`` — the whole methodology collapses if any cleanup path
quietly swallows it. So: a handler that can catch ``BaseException``
(bare ``except:``, ``except BaseException``, or a tuple containing it)
must contain a ``raise`` on its own level (nested function bodies don't
count — they run later, if at all).

Worker-thread trampolines that capture the exception to re-raise at
``join()`` are the legitimate exception; they declare themselves with
``# cclint: crash-ok(<reason>)`` on the ``except`` line.
"""

from __future__ import annotations

import ast

from tpu_cc_manager_torch.lint.base import Finding, LintContext, qualname_of

CHECKER = "crash"


def _catches_base(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name) and t.id == "BaseException":
        return True
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id == "BaseException" for e in t.elts
        )
    return False


def _contains_raise(body: list[ast.stmt]) -> bool:
    """A ``raise`` reachable at the handler's own level (not inside a
    nested def/lambda, which executes later if ever)."""
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Raise):
                # ast.walk descends into nested defs too; re-verify by
                # checking the raise isn't under one.
                if not _under_nested_def(stmt, node):
                    return True
    return False


def _under_nested_def(root: ast.stmt, target: ast.AST) -> bool:
    """Whether ``target`` sits inside a function/lambda nested in
    ``root``."""

    def search(node: ast.AST, in_def: bool) -> bool | None:
        if node is target:
            return in_def
        nested = in_def or isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        )
        for child in ast.iter_child_nodes(node):
            got = search(child, nested)
            if got is not None:
                return got
        return None

    return bool(search(root, False))


def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for src in ctx.files:
        stack: list[ast.AST] = []

        def visit(node: ast.AST) -> None:
            is_scope = isinstance(
                node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
            )
            if is_scope:
                stack.append(node)
            if isinstance(node, ast.ExceptHandler) and _catches_base(node):
                if not _contains_raise(node.body) and src.annotation(
                    node.lineno, "crash-ok"
                ) is None:
                    symbol = qualname_of(stack)
                    caught = "bare except" if node.type is None else "BaseException"
                    findings.append(
                        Finding(
                            checker=CHECKER,
                            path=src.relpath,
                            line=node.lineno,
                            message=(
                                f"{caught} handler in {symbol} never "
                                "re-raises — modeled SIGKILL must escape "
                                "every cleanup path (annotate "
                                "`# cclint: crash-ok(reason)` for a "
                                "re-raise-at-join trampoline)"
                            ),
                            symbol=symbol,
                        )
                    )
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_scope:
                stack.pop()

        visit(src.tree)
    return findings
