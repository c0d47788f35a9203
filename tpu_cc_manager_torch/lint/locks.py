"""Checker 1: annotated lock discipline — now interprocedural.

The agent is a thread soup — watch loop, watchdog, preemption monitor,
informer, renewer, wave drivers, pipeline workers — and every shared
field they touch is supposed to be lock-guarded. The convention:

- A shared field declares its lock at its ``__init__`` assignment::

      self._nodes = {}  # cclint: guarded-by(_cond)

- Everywhere else in the class, the field may only be touched inside a
  lexical ``with self._cond:`` block, or in a method whose callers hold
  the lock::

      def _rebuild(self):  # cclint: requires(_cond)

- ``__init__`` itself is exempt (no concurrency before construction
  finishes), and a deliberate lock-free access can carry
  ``# cclint: unlocked-ok(<reason>)`` on its line.

v1 trusted two things it could not see; v2 checks them through the
class call graph:

- **``requires`` is verified, not trusted**: every same-class call site
  of a ``requires(L)`` method must hold L (lexically, or via its own
  ``requires``). A bare ``self.method`` reference to a ``requires``
  method (a thread target, a callback) is a finding — the thread that
  eventually calls it holds nothing.
- **unannotated private helpers are checked against their callers'
  lock context**: a ``_helper`` touching a guarded field outside a
  ``with`` is clean when every same-class call site provably holds the
  lock (one level of context — a chain of helpers needs ``requires``
  on the middle links), and a finding that names the lock-free caller
  otherwise. Public methods keep the strict lexical rule: external
  callers are invisible to the engine.

Lexical scoping stays deliberately conservative: a closure defined
inside a ``with`` block may run after the lock is released, so nested
``def`` / ``lambda`` bodies start with no held locks (they may
re-acquire, or declare ``requires`` on the nested def). Calls made
inside such closures count as lock-free call sites for the same reason.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from tpu_cc_manager_torch.lint.base import Finding, LintContext, SourceFile

CHECKER = "locks"


def _self_attr(node: ast.AST) -> str | None:
    """``self.<attr>`` -> attr name, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _with_locks(node: ast.With) -> set[str]:
    """Lock names acquired by ``with self.<lock>[, ...]:`` items."""
    locks: set[str] = set()
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr is not None:
            locks.add(attr)
    return locks


def _requires_of(fn: ast.FunctionDef, src: SourceFile) -> set[str]:
    """Locks a ``# cclint: requires(<lock>)`` annotation on the def's
    signature lines declares held by every caller."""
    sig_end = fn.body[0].lineno if fn.body else fn.lineno
    out: set[str] = set()
    for ln in range(fn.lineno, sig_end + 1):
        for d, arg in src.annotations.get(ln, ()):
            if d == "requires":
                out.update(a.strip() for a in arg.split(",") if a.strip())
    return out


def _guarded_fields(cls: ast.ClassDef, src: SourceFile) -> dict[str, str]:
    """field -> lock, from ``guarded-by`` annotations on ``__init__``
    assignments (or class-body assignments)."""
    guarded: dict[str, str] = {}

    def scan_stmt(stmt: ast.stmt) -> None:
        targets: list[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        else:
            return
        arg = src.annotation(
            stmt.lineno, "guarded-by", span_end=stmt.end_lineno
        )
        if arg is None:
            return
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                guarded[attr] = arg.strip()

    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.stmt):
                    scan_stmt(stmt)
    return guarded


@dataclass
class _Access:
    """One guarded-field touch: where, and what was lexically held."""

    attr: str
    line: int
    held: frozenset


@dataclass
class _CallSite:
    """One ``self.m(...)`` call (or bare ``self.m`` reference) with the
    lexically-held lock set at that point."""

    method: str
    line: int
    held: frozenset
    caller: str
    is_call: bool  # False: bare reference (thread target / callback)


@dataclass
class _MethodFacts:
    accesses: list[_Access] = field(default_factory=list)
    calls: list[_CallSite] = field(default_factory=list)


class _MethodWalker:
    """Walks one method body tracking the lexically-held lock set,
    collecting guarded-field accesses and same-class call sites."""

    def __init__(
        self,
        src: SourceFile,
        cls_name: str,
        method: str,
        guarded: dict[str, str],
        method_names: set[str],
        facts: _MethodFacts,
    ) -> None:
        self.src = src
        self.cls_name = cls_name
        self.method = method
        self.guarded = guarded
        self.method_names = method_names
        self.facts = facts

    def walk(self, node: ast.AST, held: frozenset) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def runs later, possibly lock-free: reset to its
            # own declared requirements.
            inner = frozenset(_requires_of(node, self.src))
            for child in node.body:
                self.walk(child, inner)
            return
        if isinstance(node, ast.Lambda):
            self.walk(node.body, frozenset())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = _with_locks(node)
            for item in node.items:
                self.walk(item.context_expr, held)
            for child in node.body:
                self.walk(child, held | acquired)
            return
        attr = _self_attr(node)
        if attr is not None:
            if attr in self.guarded:
                self.facts.accesses.append(
                    _Access(attr, node.lineno, held)
                )
            elif attr in self.method_names:
                # A bare self.m reference; ast.Call sites are recorded
                # below (the Call's func is this same Attribute — mark
                # it a call there and skip the double record here).
                self.facts.calls.append(
                    _CallSite(
                        attr, node.lineno, held, self.method, is_call=False
                    )
                )
            # Still walk the value chain (e.g. self._nodes[k].foo).
        if isinstance(node, ast.Call):
            callee = _self_attr(node.func)
            if callee is not None and callee in self.method_names:
                self.facts.calls.append(
                    _CallSite(
                        callee, node.lineno, held, self.method, is_call=True
                    )
                )
                # Walk args with the current held set; skip re-recording
                # the func attribute as a bare reference.
                for child in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    self.walk(child, held)
                return
        for child in ast.iter_child_nodes(node):
            self.walk(child, held)


def _is_private(name: str) -> bool:
    return name.startswith("_") and not (
        name.startswith("__") and name.endswith("__")
    )


def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for src in ctx.files:
        for cls in [
            n for n in ast.walk(src.tree) if isinstance(n, ast.ClassDef)
        ]:
            guarded = _guarded_fields(cls, src)
            methods = {
                n.name: n
                for n in cls.body
                if isinstance(n, ast.FunctionDef)
            }
            if not guarded and not any(
                _requires_of(m, src) for m in methods.values()
            ):
                continue
            requires = {
                name: frozenset(_requires_of(m, src))
                for name, m in methods.items()
            }
            facts: dict[str, _MethodFacts] = {}
            for name, m in methods.items():
                # __init__ is walked too: its field accesses are exempt
                # (no concurrency before construction finishes) and are
                # filtered in _judge_class, but the call sites and bare
                # references it records are NOT — a thread target built
                # in __init__ (`Thread(target=self._run)`) outlives
                # construction and runs holding nothing.
                mf = _MethodFacts()
                walker = _MethodWalker(
                    src, cls.name, name, guarded, set(methods), mf
                )
                for stmt in m.body:
                    walker.walk(stmt, requires[name])
                facts[name] = mf
            findings.extend(
                _judge_class(src, cls.name, guarded, requires, facts)
            )
    return findings


def _judge_class(
    src: SourceFile,
    cls_name: str,
    guarded: dict[str, str],
    requires: dict[str, frozenset],
    facts: dict[str, _MethodFacts],
) -> list[Finding]:
    findings: list[Finding] = []

    # Call sites of each method, across the class.
    sites: dict[str, list[_CallSite]] = {}
    for mf in facts.values():
        for cs in mf.calls:
            sites.setdefault(cs.method, []).append(cs)

    def waived(line: int) -> bool:
        return src.annotation(line, "unlocked-ok") is not None

    # -- requires() is verified against every visible call site ----------
    for name, req in requires.items():
        if not req:
            continue
        for cs in sites.get(name, ()):  # same-class call sites only
            if waived(cs.line):
                continue
            if cs.caller == "__init__" and cs.is_call:
                # A direct call during construction runs single-threaded;
                # the lock protects nothing yet. (A bare reference from
                # __init__ — a thread target — is still checked below.)
                continue
            if not cs.is_call:
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=src.relpath,
                        line=cs.line,
                        message=(
                            f"self.{name} (requires("
                            f"{', '.join(sorted(req))})) escapes as a bare "
                            f"reference in {cls_name}.{cs.caller} — a "
                            "thread target or callback runs it holding "
                            "nothing; acquire inside, or waive with "
                            "`# cclint: unlocked-ok(reason)`"
                        ),
                        symbol=f"{cls_name}.{cs.caller}",
                        detail=f"ref-{name}",
                    )
                )
                continue
            missing = req - cs.held
            if missing:
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=src.relpath,
                        line=cs.line,
                        message=(
                            f"{cls_name}.{cs.caller} calls self.{name}() "
                            f"without holding {', '.join(sorted(missing))} "
                            f"which it declares requires() — take the "
                            "lock at the call site (or annotate the "
                            "caller's own requires)"
                        ),
                        symbol=f"{cls_name}.{cs.caller}",
                        detail=f"call-{name}",
                    )
                )

    # -- guarded-field accesses, with caller-context inference ------------
    for name, mf in facts.items():
        if name == "__init__":
            continue  # no concurrency before construction finishes
        for acc in mf.accesses:
            lock = guarded[acc.attr]
            if lock in acc.held or waived(acc.line):
                continue
            # Lock-free lexically. A private helper is saved by its
            # callers when every same-class call site holds the lock
            # and the method never escapes as a bare reference. A direct
            # call from __init__ counts as held (single-threaded).
            caller_sites = sites.get(name, [])
            lockfree_caller = next(
                (
                    cs for cs in caller_sites
                    if not cs.is_call
                    or (lock not in cs.held and cs.caller != "__init__")
                ),
                None,
            )
            if (
                _is_private(name)
                and caller_sites
                and lockfree_caller is None
            ):
                continue  # proven through every caller
            via = ""
            if lockfree_caller is not None and lockfree_caller.is_call:
                via = (
                    f" (called lock-free from {cls_name}."
                    f"{lockfree_caller.caller} line {lockfree_caller.line})"
                )
            elif lockfree_caller is not None:
                via = (
                    f" (escapes as a bare reference in {cls_name}."
                    f"{lockfree_caller.caller} line {lockfree_caller.line})"
                )
            findings.append(
                Finding(
                    checker=CHECKER,
                    path=src.relpath,
                    line=acc.line,
                    message=(
                        f"self.{acc.attr} is guarded-by({lock}) but "
                        f"accessed outside `with self.{lock}:` in "
                        f"{cls_name}.{name}{via}"
                    ),
                    symbol=f"{cls_name}.{name}",
                    detail=acc.attr,
                )
            )
    return findings
