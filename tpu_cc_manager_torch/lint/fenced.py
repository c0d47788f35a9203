"""Checker 6: fenced-write taint — no raw apiserver writes inside a
rollout lease bracket.

The lease contract: the rollout lease is a single-writer fence. Once
``RolloutLease.acquire()`` succeeds, every apiserver WRITE the
orchestrator performs must flow through ``FencedKube``, whose per-write
validity check turns a lost lease into ``RolloutFenced`` instead of a
silent write into a pool a successor now owns. A raw-client write
reachable inside the bracket bypasses the CAS fencing — the exact bug
class that lets two orchestrators flip the same pool.

Two rules:

- **self-fencing classes** (``RollingReconfigurator``: ``__init__``
  wraps its client in ``FencedKube`` when a lease is present): every
  write-method call anywhere in the class must go through ``self.api``
  — the one attribute the wrap covers. A write through any other
  receiver (a stashed raw client, a fresh constructor) is a finding.
- **lease brackets** (any function that constructs a ``RolloutLease``
  and acquires it — ``ctl.py`` today): from ``lease.acquire()`` to
  ``lease.release()`` (may-analysis over the CFG — if ANY path reaches
  the write with the bracket open, it's a finding), a write-method call
  on the raw client, or a call handing the raw client to a function or
  constructor that (transitively) writes through that parameter, is an
  error. Handing the client to a self-fencing class WITH the lease is
  the sanctioned pattern; the lease machinery itself
  (``rollout_state.py``) is the fence, not a client of it.

Resolution limits are the engine's (lint/flow.py): cross-module calls
resolve by unique name, dynamic dispatch doesn't resolve and degrades
to a finding, ``# cclint: unfenced-ok(<reason>)`` waives a line.
"""

from __future__ import annotations

import ast

from tpu_cc_manager_torch.lint import flow
from tpu_cc_manager_torch.lint.base import Finding, LintContext, SourceFile

CHECKER = "fenced"

#: KubeApi methods that mutate apiserver state. Reads may bypass the
#: fence (a stale read is safe; a stale write is the bug).
WRITE_METHODS = frozenset((
    "patch_node_labels",
    "patch_node_annotations",
    "patch_node_taints",
    "create_event",
    "create_lease",
    "update_lease",
    "delete_lease",
    "delete_node",
))

#: The lease machinery itself — its writes ARE the fence.
MECHANISM_FILES = ("tpu_cc_manager_torch/ccmanager/rollout_state.py",)


def _write_call(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in WRITE_METHODS:
        return fn.attr
    return None


def _is_fencedkube_call(call: ast.Call) -> bool:
    kn = flow.call_name(call)
    return kn is not None and kn[1] == "FencedKube"


def _is_self_attr(expr: ast.expr, attr: str) -> bool:
    return (
        isinstance(expr, ast.Attribute)
        and expr.attr == attr
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    )


class _PackageIndex:
    """Name-keyed package map for the cross-module hops this checker
    needs (constructor calls in ctl.py resolve classes in rolling.py).
    Duplicate names across modules resolve to nothing — conservative."""

    def __init__(self, files: list) -> None:
        self.functions: dict[str, tuple[SourceFile, ast.FunctionDef]] = {}
        self.classes: dict[str, tuple[SourceFile, ast.ClassDef]] = {}
        fn_dupes: set[str] = set()
        cls_dupes: set[str] = set()
        for src in files:
            for node in src.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node.name in self.functions:
                        fn_dupes.add(node.name)
                    self.functions[node.name] = (src, node)
                elif isinstance(node, ast.ClassDef):
                    if node.name in self.classes:
                        cls_dupes.add(node.name)
                    self.classes[node.name] = (src, node)
        for name in fn_dupes:
            self.functions.pop(name, None)
        for name in cls_dupes:
            self.classes.pop(name, None)
        self._writes_memo: dict[tuple[str, str], set[str]] = {}

    # -- summaries: which params does a callee write through? --------------

    def fn_writes_through(self, name: str) -> set[str]:
        """Param names of module-level function ``name`` through which a
        write-method call is reachable (transitive, name-resolved)."""
        key = ("fn", name)
        if key in self._writes_memo:
            return self._writes_memo[key]
        self._writes_memo[key] = set()  # recursion guard
        entry = self.functions.get(name)
        if entry is None:
            return set()
        src, node = entry
        params = _param_names(node)
        out = self._writes_in_body(node, set(params))
        self._writes_memo[key] = out
        return out

    def cls_writes_through(self, name: str) -> set[str]:
        """__init__ param names of class ``name`` through which a write
        is reachable: written directly in __init__, or stored on self
        and written by any method."""
        key = ("cls", name)
        if key in self._writes_memo:
            return self._writes_memo[key]
        self._writes_memo[key] = set()
        entry = self.classes.get(name)
        if entry is None:
            return set()
        src, cls = entry
        init = next(
            (
                n for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
            ),
            None,
        )
        if init is None:
            return set()
        params = set(_param_names(init)) - {"self"}
        out = self._writes_in_body(init, params)
        # Param stored to a self attribute some method writes through.
        stored: dict[str, str] = {}  # attr -> param
        for node in ast.walk(init):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "self"
                and isinstance(node.value, ast.Name)
                and node.value.id in params
            ):
                stored[node.targets[0].attr] = node.value.id
        if stored:
            for method in cls.body:
                if not isinstance(method, ast.FunctionDef):
                    continue
                for call in flow.iter_calls(method):
                    m = _write_call(call)
                    if m is None:
                        continue
                    recv = call.func.value
                    if (
                        isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"
                        and recv.attr in stored
                    ):
                        out.add(stored[recv.attr])
        self._writes_memo[key] = out
        return out

    def _writes_in_body(self, fn: ast.AST, params: set[str]) -> set[str]:
        out: set[str] = set()
        for call in flow.iter_calls(fn):
            m = _write_call(call)
            if m is not None:
                recv = call.func.value
                if isinstance(recv, ast.Name) and recv.id in params:
                    out.add(recv.id)
                continue
            kn = flow.call_name(call)
            if kn is None:
                continue
            _, name = kn
            through = self.fn_writes_through(name) | self.cls_writes_through(
                name
            )
            if not through:
                continue
            entry = self.functions.get(name) or self.classes.get(name)
            callee = _callable_def(entry)
            if callee is None:
                continue
            bound = _bind(callee, call)
            for p in through:
                arg = bound.get(p)
                if isinstance(arg, ast.Name) and arg.id in params:
                    out.add(arg.id)
        return out

    def is_self_fencing(self, name: str) -> bool:
        entry = self.classes.get(name)
        if entry is None:
            return False
        _, cls = entry
        for node in cls.body:
            if isinstance(node, ast.FunctionDef) and node.name == "__init__":
                return any(
                    _is_fencedkube_call(c) for c in flow.iter_calls(node)
                )
        return False


def _callable_def(entry):
    """The FunctionDef bound by a call to this name: the function
    itself, or a class's __init__."""
    if entry is None:
        return None
    _, node = entry
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return node
    for item in node.body:
        if isinstance(item, ast.FunctionDef) and item.name == "__init__":
            return item
    return None


def _param_names(fn) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args] + [
        p.arg for p in a.kwonlyargs
    ]


def _bind(fn, call: ast.Call) -> dict[str, ast.expr]:
    params = _param_names(fn)
    if params and params[0] in ("self", "cls"):
        params = params[1:]
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


def check(ctx: LintContext) -> list[Finding]:
    files = [f for f in ctx.files if f.relpath not in MECHANISM_FILES]
    index = _PackageIndex(files)
    findings: list[Finding] = []
    for src in files:
        for cls in [
            n for n in ast.walk(src.tree) if isinstance(n, ast.ClassDef)
        ]:
            if index.is_self_fencing(cls.name):
                findings.extend(_check_self_fencing_class(src, cls))
        findings.extend(_check_brackets(src, index))
    return findings


def _check_self_fencing_class(src: SourceFile, cls: ast.ClassDef) -> list[Finding]:
    findings: list[Finding] = []
    for method in cls.body:
        if not isinstance(method, ast.FunctionDef):
            continue
        for call in flow.iter_calls(method):
            m = _write_call(call)
            if m is None:
                continue
            recv = call.func.value
            if _is_self_attr(recv, "api"):
                continue
            line = call.lineno
            if src.annotation(
                line, "unfenced-ok",
                span_end=getattr(call, "end_lineno", line),
            ) is not None:
                continue
            findings.append(
                Finding(
                    checker=CHECKER,
                    path=src.relpath,
                    line=line,
                    message=(
                        f"{cls.name}.{method.name} calls .{m}() on "
                        f"{ast.unparse(recv)!r} — {cls.name} fences its "
                        "writes through self.api (FencedKube); a write "
                        "through any other client bypasses the lease CAS"
                    ),
                    symbol=f"{cls.name}.{method.name}",
                    detail=m,
                )
            )
    return findings


def _check_brackets(src: SourceFile, index: _PackageIndex) -> list[Finding]:
    findings: list[Finding] = []
    for fi_node, qualname in _functions_with_qualnames(src.tree):
        lease_vars = _lease_vars(fi_node)
        if not lease_vars:
            continue
        raw_names = _raw_client_names(fi_node, lease_vars)
        if not raw_names:
            continue
        findings.extend(
            _check_one_bracket(
                src, fi_node, qualname, lease_vars, raw_names, index
            )
        )
    return findings


def _functions_with_qualnames(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.name
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield item, f"{node.name}.{item.name}"


def _lease_vars(fn) -> set[str]:
    """Names assigned from ``RolloutLease(...)`` in this function."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
        ):
            kn = flow.call_name(node.value)
            if kn is not None and kn[1] == "RolloutLease":
                out.add(node.targets[0].id)
    return out


def _raw_client_names(fn, lease_vars: set[str]) -> set[str]:
    """The raw-client names of this function: whatever was handed to the
    RolloutLease constructor, plus an ``api`` parameter by convention."""
    raw: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            kn = flow.call_name(node)
            if kn is not None and kn[1] == "RolloutLease" and node.args:
                first = node.args[0]
                if isinstance(first, ast.Name):
                    raw.add(first.id)
    for p in _param_names(fn):
        if p == "api":
            raw.add(p)
    return raw


def _check_one_bracket(
    src: SourceFile,
    fn,
    qualname: str,
    lease_vars: set[str],
    raw_names: set[str],
    index: _PackageIndex,
) -> list[Finding]:
    cfg = flow.build_cfg(fn)

    def lease_method_call(stmt, method_names) -> bool:
        for call in flow.stmt_calls(stmt):
            f = call.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in method_names
                and isinstance(f.value, ast.Name)
                and f.value.id in lease_vars
            ):
                return True
        return False

    # May-analysis: in-bracket if any path from an acquire reaches here
    # without passing a release.
    in_bracket: dict[int, bool] = {cfg.entry.idx: False}
    work = [cfg.entry.idx]
    while work:
        idx = work.pop()
        node = cfg.nodes[idx]
        state = in_bracket.get(idx, False)
        if node.stmt is not None:
            if lease_method_call(node.stmt, ("acquire",)):
                state = True
            if lease_method_call(node.stmt, ("release",)):
                state = False
        for s in node.succs:
            new = in_bracket.get(s, False) or state
            if new != in_bracket.get(s, False) or s not in in_bracket:
                in_bracket[s] = new
                work.append(s)

    findings: list[Finding] = []
    for node in cfg.nodes:
        if node.stmt is None or not in_bracket.get(node.idx, False):
            continue
        calls = list(flow.stmt_calls(node.stmt))
        # A closure/lambda DEFINED inside the bracket most plausibly
        # runs inside it (callbacks, hooks): scan its whole body too —
        # conservative, and the hole a callback-shaped bypass would
        # otherwise walk through.
        for sub in ast.walk(node.stmt):
            if isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                calls.extend(flow.iter_calls(sub))
        unique: dict[int, ast.Call] = {}
        for c in calls:
            unique.setdefault(id(c), c)
        for call in unique.values():
            finding = _classify_bracket_call(
                src, qualname, call, raw_names, lease_vars, index
            )
            if finding is not None:
                findings.append(finding)
    return findings


def _classify_bracket_call(
    src: SourceFile,
    qualname: str,
    call: ast.Call,
    raw_names: set[str],
    lease_vars: set[str],
    index: _PackageIndex,
) -> Finding | None:
    line = call.lineno

    def waived() -> bool:
        return src.annotation(
            line, "unfenced-ok", span_end=getattr(call, "end_lineno", line)
        ) is not None

    m = _write_call(call)
    if m is not None:
        recv = call.func.value
        if isinstance(recv, ast.Name) and recv.id in raw_names:
            if waived():
                return None
            return Finding(
                checker=CHECKER,
                path=src.relpath,
                line=line,
                message=(
                    f"raw-client write .{m}() on {recv.id!r} inside the "
                    f"rollout lease bracket in {qualname} — route it "
                    "through FencedKube (or hand the client+lease to the "
                    "self-fencing orchestrator)"
                ),
                symbol=qualname,
                detail=m,
            )
        return None
    kn = flow.call_name(call)
    if kn is None:
        return None
    _, name = kn
    if name == "FencedKube":
        return None
    passes_raw = [
        a for a in list(call.args)
        + [kw.value for kw in call.keywords]
        if isinstance(a, ast.Name) and a.id in raw_names
    ]
    if not passes_raw:
        return None
    passes_lease = any(
        isinstance(a, ast.Name) and a.id in lease_vars
        for a in list(call.args) + [kw.value for kw in call.keywords]
    )
    if passes_lease and index.is_self_fencing(name):
        return None  # the sanctioned handoff: client + lease to a wrapper
    through = index.fn_writes_through(name) | index.cls_writes_through(name)
    if not through:
        return None
    entry = index.functions.get(name) or index.classes.get(name)
    callee = _callable_def(entry)
    if callee is None:
        return None
    bound = _bind(callee, call)
    for p in through:
        arg = bound.get(p)
        if isinstance(arg, ast.Name) and arg.id in raw_names:
            if waived():
                return None
            return Finding(
                checker=CHECKER,
                path=src.relpath,
                line=line,
                message=(
                    f"{qualname} hands the raw client to {name}() inside "
                    f"the lease bracket, and {name} writes through that "
                    "parameter — fence it (FencedKube) or pass the lease "
                    "so the callee self-fences"
                ),
                symbol=qualname,
                detail=name,
            )
    return None
