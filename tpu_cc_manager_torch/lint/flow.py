"""Flow machinery for the v2 checkers: per-function CFGs and a
package-wide call graph (stdlib ``ast`` only).

The v1 checkers were lexical — an allowlist of call sites, a ``with``
block visible inside one function. The invariants they guard span call
chains (the transition intent begins in ``_apply_with_eviction`` and the
reset it journals runs two frames deeper) and threads (a helper touched
lock-free from one of its three callers). This module gives checkers the
two structures those proofs need:

- :func:`build_cfg` — a statement-granularity control-flow graph per
  function, with branch-polarity labels on ``if`` edges (so analyses can
  refine ``x is None`` tests), exception edges from ``try`` bodies to
  their handlers, and return-through-``finally`` threading.
- :class:`CallIndex` — resolution of ``self.method(...)`` calls to
  methods of the same class and bare-name calls to functions of the same
  module, in both directions (callees of f / call sites of f).

Documented limitations (see docs/cclint.md):

- **Dynamic dispatch is unresolved.** ``self.m()`` resolves only within
  the lexical class; inherited/overridden methods, ``getattr``, bound
  references passed around, and cross-module calls are not followed.
  Analyses must degrade to "unknown" (and findings) there, never to
  silent cleanliness.
- **Exception edges are approximate.** Any statement in a ``try`` body
  may jump to any of its handlers; exceptions raised inside handlers,
  ``else`` or ``finally`` blocks propagate straight to the exceptional
  exit. A ``return`` inside ``try/finally`` runs the innermost
  ``finally`` body before exiting (outer finallies are not chained).
- **Paths are merged, not enumerated.** The CFG supports dataflow over
  paths (dominance-style must/may facts), not path-sensitive predicates
  beyond single ``if <name> [is [not] None]`` refinements.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field


@dataclass(eq=False)
class Node:
    """One CFG node: a statement (or ExceptHandler), or a synthetic
    entry/exit. ``branch`` labels this node's outgoing edges with a
    polarity ("true"/"false") when the node is a conditional test.
    Identity semantics (``eq=False``): hashable, one object per node."""

    idx: int
    stmt: ast.AST | None
    kind: str = "stmt"  # entry | exit | raise-exit | stmt | handler
    succs: set[int] = field(default_factory=set)
    preds: set[int] = field(default_factory=set)
    branch: dict[int, str] = field(default_factory=dict)


class CFG:
    """Statement-level control-flow graph of one function body.

    ``exit`` joins every normal completion (explicit returns, implicit
    end-of-body) — after any ``finally`` bodies on the way out.
    ``raise_exit`` joins escaping exceptions and is where crash-exempt
    paths end (a modeled SIGKILL is a BaseException; the journal
    contract's "non-crash exits" are exactly the edges into ``exit``).
    """

    def __init__(self, fn: ast.AST) -> None:
        self.fn = fn
        self.nodes: list[Node] = []
        self.entry = self._new(None, "entry")
        self.exit = self._new(None, "exit")
        self.raise_exit = self._new(None, "raise-exit")

    def _new(self, stmt: ast.AST | None, kind: str = "stmt") -> Node:
        n = Node(len(self.nodes), stmt, kind)
        self.nodes.append(n)
        return n


class _Builder:
    def __init__(self, fn: ast.AST) -> None:
        self.cfg = CFG(fn)
        # (break-target collector, continue-target node) per active loop.
        self.loop_stack: list[tuple[set[Node], Node]] = []
        # Innermost-first: each entry collects the Return nodes that must
        # run this finally body before reaching exit.
        self.finally_stack: list[dict] = []
        # Nodes with a pending polarity for their NEXT outgoing edge
        # (the implicit false-edge of an if without an else).
        self._pending_label: dict[int, str] = {}

    def _link(self, a: Node, b: Node) -> None:
        a.succs.add(b.idx)
        b.preds.add(a.idx)
        lbl = self._pending_label.get(a.idx)
        if lbl is not None and b.idx not in a.branch:
            a.branch[b.idx] = lbl

    def _link_all(self, preds: set[Node], b: Node) -> None:
        for a in preds:
            self._link(a, b)

    def build(self) -> CFG:
        frontier = self._body(self.cfg.fn.body, {self.cfg.entry})
        self._link_all(frontier, self.cfg.exit)
        return self.cfg

    def _body(self, stmts: list[ast.stmt], preds: set[Node]) -> set[Node]:
        frontier = set(preds)
        for stmt in stmts:
            if not frontier:
                # Unreachable code after return/raise/break: still build
                # nodes (a checker may want to look at them) but leave
                # them disconnected.
                frontier = set()
            frontier = self._stmt(stmt, frontier)
        return frontier

    def _stmt(self, stmt: ast.stmt, preds: set[Node]) -> set[Node]:
        cfg = self.cfg
        if isinstance(stmt, ast.If):
            node = cfg._new(stmt)
            self._link_all(preds, node)
            before = set(node.succs)
            body_frontier = self._body(stmt.body, {node})
            for s in node.succs - before:
                node.branch[s] = "true"
            if stmt.orelse:
                before2 = set(node.succs)
                else_frontier = self._body(stmt.orelse, {node})
                for s in node.succs - before2:
                    node.branch.setdefault(s, "false")
                return body_frontier | else_frontier
            # No else: the fall-through edge (created by our caller when
            # it links the next statement) carries the false polarity.
            self._pending_label[node.idx] = "false"
            return body_frontier | {node}
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            node = cfg._new(stmt)
            self._link_all(preds, node)
            breaks: set[Node] = set()
            self.loop_stack.append((breaks, node))
            body_frontier = self._body(stmt.body, {node})
            self.loop_stack.pop()
            self._link_all(body_frontier, node)  # back edge
            else_frontier = (
                self._body(stmt.orelse, {node}) if stmt.orelse else {node}
            )
            return else_frontier | breaks
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            node = cfg._new(stmt)
            self._link_all(preds, node)
            return self._body(stmt.body, {node})
        if isinstance(stmt, ast.Try):
            return self._try(stmt, preds)
        if isinstance(stmt, ast.Return):
            node = cfg._new(stmt)
            self._link_all(preds, node)
            if self.finally_stack:
                self.finally_stack[-1]["returns"].add(node)
            else:
                self._link(node, cfg.exit)
            return set()
        if isinstance(stmt, ast.Raise):
            node = cfg._new(stmt)
            self._link_all(preds, node)
            # Raise reaches the enclosing handlers via the body-node ->
            # handler edges added by _try; if none catch, it escapes.
            self._link(node, cfg.raise_exit)
            return set()
        if isinstance(stmt, ast.Break):
            node = cfg._new(stmt)
            self._link_all(preds, node)
            if self.loop_stack:
                self.loop_stack[-1][0].add(node)
            return set()
        if isinstance(stmt, ast.Continue):
            node = cfg._new(stmt)
            self._link_all(preds, node)
            if self.loop_stack:
                self._link(node, self.loop_stack[-1][1])
            return set()
        # Plain statement (assign, expr, assert, nested def, ...).
        node = cfg._new(stmt)
        self._link_all(preds, node)
        return {node}

    def _try(self, stmt: ast.Try, preds: set[Node]) -> set[Node]:
        cfg = self.cfg
        if stmt.finalbody:
            self.finally_stack.append({"returns": set()})
        start = len(cfg.nodes)
        body_frontier = self._body(stmt.body, preds)
        body_nodes = [
            n for n in cfg.nodes[start:] if n.kind in ("stmt", "handler")
        ]
        handler_frontiers: list[set[Node]] = []
        handler_entries: list[Node] = []
        for h in stmt.handlers:
            hn = cfg._new(h, "handler")
            handler_entries.append(hn)
            handler_frontiers.append(self._body(h.body, {hn}))
        # An exception may arise at any statement of the body (including
        # ones inside nested structures — over-approximation) and jump to
        # any handler; which handler matches is type-dependent and
        # unresolved here.
        for bn in body_nodes:
            for hn in handler_entries:
                self._link(bn, hn)
        else_frontier = (
            self._body(stmt.orelse, body_frontier)
            if stmt.orelse else body_frontier
        )
        merged = set(else_frontier)
        for f in handler_frontiers:
            merged |= f
        if stmt.finalbody:
            info = self.finally_stack.pop()
            fin_preds = merged | info["returns"]
            fin_frontier = self._body(stmt.finalbody, fin_preds)
            if info["returns"]:
                # Paths that entered the finally via a return leave the
                # function after it. (They also share the fall-through
                # edge to the next statement — a path over-approximation;
                # must-analyses stay sound, may-analyses stay complete.)
                for n in fin_frontier:
                    self._link(n, cfg.exit)
            return fin_frontier
        return merged


def build_cfg(fn: ast.AST) -> CFG:
    """CFG of a FunctionDef/AsyncFunctionDef body."""
    return _Builder(fn).build()


# ---------------------------------------------------------------------------
# Call resolution
# ---------------------------------------------------------------------------


def call_name(call: ast.Call) -> tuple[str, str] | None:
    """(kind, name) of a call: ("self", m) for ``self.m(...)``,
    ("bare", f) for ``f(...)``, ("attr", a) for ``<expr>.a(...)``;
    None for anything else (subscripts, lambdas, ...)."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return ("bare", fn.id)
    if isinstance(fn, ast.Attribute):
        if isinstance(fn.value, ast.Name) and fn.value.id == "self":
            return ("self", fn.attr)
        return ("attr", fn.attr)
    return None


@dataclass(eq=False)
class FunctionInfo:
    """One function/method in the package, with enough context to
    resolve its intra-class and intra-module calls. Identity semantics
    (``eq=False``): one object per definition, hashable, comparable
    with ``is``."""

    src: object  # lint.base.SourceFile
    node: ast.FunctionDef | ast.AsyncFunctionDef
    cls: ast.ClassDef | None  # enclosing class (methods) or None
    qualname: str  # Class.method or function

    @property
    def params(self) -> list[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args]
        if self.cls is not None and names and names[0] in ("self", "cls"):
            names = names[1:]
        names += [p.arg for p in a.kwonlyargs]
        return names

    def param_default(self, name: str) -> ast.expr | None:
        """The default expression of parameter ``name`` (None if it has
        no default)."""
        a = self.node.args
        pos = a.posonlyargs + a.args
        # defaults align with the tail of pos
        for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
            if p.arg == name:
                return d
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if p.arg == name and d is not None:
                return d
        return None

    def bind_args(self, call: ast.Call) -> dict[str, ast.expr]:
        """Map parameter name -> argument expression for ``call``
        (best-effort positional/keyword binding; *args/**kwargs are
        ignored — a checker sees those params as unresolved)."""
        params = self.params
        bound: dict[str, ast.expr] = {}
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(params):
                bound[params[i]] = arg
        for kw in call.keywords:
            if kw.arg is not None:
                bound[kw.arg] = kw.value
        return bound


class CallIndex:
    """Both directions of the package call graph, at the resolution the
    engine supports: ``self.m(...)`` within the lexical class and bare
    ``f(...)`` within the module."""

    def __init__(self, files: list) -> None:
        self.functions: dict[tuple[str, str], FunctionInfo] = {}
        # (relpath, qualname) of caller -> list of (callee FunctionInfo, Call)
        self._files = files
        for src in files:
            self._index_file(src)

    def _index_file(self, src) -> None:
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FunctionInfo(src, node, None, node.name)
                self.functions[(src.relpath, node.name)] = fi
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        q = f"{node.name}.{item.name}"
                        self.functions[(src.relpath, q)] = FunctionInfo(
                            src, item, node, q
                        )

    def resolve(self, caller: FunctionInfo, call: ast.Call) -> FunctionInfo | None:
        """The FunctionInfo a call resolves to, or None (dynamic
        dispatch, cross-module, builtin — the documented blind spots)."""
        kn = call_name(call)
        if kn is None:
            return None
        kind, name = kn
        if kind == "self" and caller.cls is not None:
            return self.functions.get(
                (caller.src.relpath, f"{caller.cls.name}.{name}")
            )
        if kind == "bare":
            return self.functions.get((caller.src.relpath, name))
        return None

    def call_sites(self, target: FunctionInfo) -> list[tuple[FunctionInfo, ast.Call]]:
        """Every resolvable call site of ``target`` in the package:
        (caller, call) pairs. Same resolution limits as :meth:`resolve`."""
        out: list[tuple[FunctionInfo, ast.Call]] = []
        for fi in self.functions.values():
            if fi.src.relpath != target.src.relpath:
                continue
            for call in iter_calls(fi.node):
                if self.resolve(fi, call) is target:
                    out.append((fi, call))
        return out


def iter_calls(fn: ast.AST):
    """Every ast.Call in a function body, including ones inside nested
    defs/lambdas/comprehensions (a call site in a closure is still a
    call site)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            yield node


def stmt_calls(stmt: ast.AST):
    """Calls belonging to exactly one CFG node: for a compound statement
    (if/while/for/with/try) only the header expressions — its body
    statements are their own CFG nodes — and never inside nested
    function bodies (those run later, under their own analysis)."""

    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.stmt),
            ):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from walk(child)

    roots: list[ast.AST] = []
    if isinstance(stmt, (ast.If, ast.While)):
        roots = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.target, stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [item.context_expr for item in stmt.items]
    elif isinstance(stmt, ast.Try):
        roots = []
    elif isinstance(
        stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    ):
        roots = []
    else:
        roots = [stmt]
    for root in roots:
        if isinstance(root, ast.Call):
            yield root
        yield from walk(root)
