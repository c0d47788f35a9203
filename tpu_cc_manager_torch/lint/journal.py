"""Checker 4: journal-before-reset — a dominance proof, not an allowlist.

The journal contract: every hardware-effecting operation journals an intent
(``intent_journal.begin``, fsync'd to disk) BEFORE the first disruptive
step, so a SIGKILL at any point replays to exactly-one-reset-per-chip —
and the intent is closed (commit/abort) on every non-crash exit, so
replay never resolves an intent the code already resolved.

v1 enforced the lexical shadow of this: a reviewed allowlist of call
sites. v2 proves the bracket on the control-flow graph (lint/flow.py):

- **begin-dominates-reset**: every ``backend.reset`` /
  ``backend.restart_runtime`` call must have an intent-begin on every
  CFG path from the function entry to the call. The proof is
  interprocedural: a journal token received as a parameter carries its
  callers' proof (``_apply_direct(txn=...)`` is proven through
  ``_apply_with_eviction``'s write-ahead begin plus the
  ``if txn is None: txn = begin()`` merge), and begin/close wrappers
  (``_journal_begin``, ``_journal_hardware_intent``) are discovered from
  the call graph, not hardcoded.
- **close-postdominates-exit**: a token begun in a function must be
  closed — or returned to the caller, who is then checked — on every
  path into the normal exit. Crash exits (escaping BaseException, bare
  ``raise``) are exempt: an OPEN intent at a crash is exactly the record
  replay recovers from.

Degradation is loud: a token that reaches a hardware call as "maybe
journaled" (one caller proven, one not; dynamic dispatch; a *args call
the binder can't see) is a finding. Waivers, in escalating order of
reviewer attention: ``# cclint: journal-ok(<reason>)`` on the hardware
call line, ``# cclint: intent-open-ok(<reason>)`` on a begin whose
token deliberately stays open (none needed today), and the ALLOWLIST
below — the waiver of last resort, now empty; adding an entry means the
engine cannot see a bracket a human has re-verified.

The device layer (``gpudev/``) is out of scope — a backend composing
its own primitives runs inside its caller's bracket — and the journal
implementation itself (``intent_journal.py``) is the mechanism, not a
client.
"""

from __future__ import annotations

import ast

from tpu_cc_manager_torch.lint import flow
from tpu_cc_manager_torch.lint.base import (
    Finding,
    LintContext,
    SourceFile,
    qualname_of,
)

CHECKER = "journal"

EXCLUDED_DIRS = ("tpu_cc_manager_torch/gpudev/",)
EXCLUDED_FILES = ("tpu_cc_manager_torch/ccmanager/intent_journal.py",)

#: fingerprint -> reason. The waiver of LAST resort: an entry asserts a
#: human re-verified a bracket the flow engine cannot prove. Prefer
#: making the bracket provable (thread the token, begin unconditionally)
#: or a `# cclint: journal-ok(reason)` line waiver.
ALLOWLIST: dict[str, str] = {}

# Token states (powerset lattice; merge = union). Open tokens carry the
# statically-visible intent KIND ("open:<kind>", "open:?" when the kind
# is not a literal at the begin site): a drain-bracket token must not
# prove a hardware call — replay of a drain intent readmits components,
# it does not resolve a reset.
OPEN_PREFIX = "open:"
NONE = "none"      # literal None
CLOSED = "closed"  # committed/aborted, or ownership handed off
OTHER = "other"    # anything the engine can't classify

#: Intent kinds whose replay does NOT cover hardware effects.
NON_HW_KINDS = ("drain",)


def _is_open(value: str) -> bool:
    return value.startswith(OPEN_PREFIX)


def _open_state_of(call: ast.Call) -> frozenset:
    """The token state a begin call produces: open, tagged with the
    first literal string argument when there is one (the kind for the
    primitive and for the pass-through wrappers; an unrelated literal
    only matters if it collides with a non-hardware kind name, which is
    the conservative direction)."""
    kind = "?"
    if call.args:
        first = call.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            kind = first.value
    return frozenset((f"{OPEN_PREFIX}{kind}",))


def _proves_hw(state: frozenset) -> bool:
    """A token state proves a hardware bracket when it is definitely
    open (no path where it is None/closed/unknown) and its kind is not
    a known non-hardware bracket."""
    if len(state) != 1:
        return False
    (value,) = state
    return _is_open(value) and value[len(OPEN_PREFIX):] not in NON_HW_KINDS


def _is_backend_hw_call(call: ast.Call) -> str | None:
    """``<expr>.backend.reset(...)`` / ``.restart_runtime(...)`` (or a
    bare ``backend.<op>(...)``) -> the op name, else None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute) or fn.attr not in (
        "reset", "restart_runtime"
    ):
        return None
    base = fn.value
    if isinstance(base, ast.Name) and base.id == "backend":
        return fn.attr
    if isinstance(base, ast.Attribute) and base.attr == "backend":
        return fn.attr
    return None


def _chain_names(expr: ast.expr) -> set[str]:
    """Attribute/Name identifiers along a dotted chain."""
    out: set[str] = set()
    while isinstance(expr, ast.Attribute):
        out.add(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        out.add(expr.id)
    return out


def _is_begin_primitive(call: ast.Call) -> bool:
    """``<...intents...>.begin(...)`` — the IntentJournal write-ahead."""
    fn = call.func
    return (
        isinstance(fn, ast.Attribute)
        and fn.attr == "begin"
        and "intents" in _chain_names(fn.value)
    )


def _close_primitive_arg(call: ast.Call) -> str | None:
    """The token variable a ``<...intents...>.commit/.abort(tok, ...)``
    call closes (None when not a close primitive or the arg isn't a
    plain name)."""
    fn = call.func
    if (
        isinstance(fn, ast.Attribute)
        and fn.attr in ("commit", "abort")
        and "intents" in _chain_names(fn.value)
        and call.args
        and isinstance(call.args[0], ast.Name)
    ):
        return call.args[0].id
    return None


class _Engine:
    """Per-context analysis state: summaries (beginners/closers), memoized
    per-function dataflow, and demand-driven parameter token states."""

    def __init__(self, ctx: LintContext) -> None:
        self.files = [
            f for f in ctx.files
            if not f.relpath.startswith(EXCLUDED_DIRS)
            and f.relpath not in EXCLUDED_FILES
        ]
        self.index = flow.CallIndex(self.files)
        self.beginners: set[flow.FunctionInfo] = set()
        self.closers: dict[flow.FunctionInfo, set[str]] = {}
        self._compute_summaries()
        self._analysis: dict[flow.FunctionInfo, dict[int, dict]] = {}
        self._param_memo: dict[tuple[flow.FunctionInfo, str], frozenset] = {}
        self._param_inflight: set[tuple[flow.FunctionInfo, str]] = set()
        self._token_param_memo: dict[flow.FunctionInfo, set[str]] = {}
        self._cfgs: dict[flow.FunctionInfo, flow.CFG] = {}

    # -- summaries ---------------------------------------------------------

    def _compute_summaries(self) -> None:
        """Fixpoint over the call graph: a *beginner* returns an intent
        token it began (``return self.intents.begin(...)`` directly, or
        a variable assigned from a begin); a *closer* closes one of its
        parameters on some path (close calls are unconditional in spirit
        — runtime journal-unavailable guards don't demote a closer)."""
        changed = True
        while changed:
            changed = False
            for fi in self.index.functions.values():
                if fi not in self.beginners and self._scan_beginner(fi):
                    self.beginners.add(fi)
                    changed = True
                closed = self._scan_closer(fi)
                if closed - self.closers.get(fi, set()):
                    self.closers[fi] = self.closers.get(fi, set()) | closed
                    changed = True

    def _is_begin_call(self, caller: flow.FunctionInfo, call: ast.Call) -> bool:
        if _is_begin_primitive(call):
            return True
        target = self.index.resolve(caller, call)
        return target is not None and target in self.beginners

    def _closed_params_of_call(
        self, caller: flow.FunctionInfo, call: ast.Call
    ) -> list[str]:
        """Token VARIABLE names in ``caller`` that this call closes."""
        out: list[str] = []
        prim = _close_primitive_arg(call)
        if prim is not None:
            out.append(prim)
        target = self.index.resolve(caller, call)
        if target is not None and target in self.closers:
            bound = target.bind_args(call)
            for param in self.closers[target]:
                arg = bound.get(param)
                if isinstance(arg, ast.Name):
                    out.append(arg.id)
        return out

    def _scan_beginner(self, fi: flow.FunctionInfo) -> bool:
        begun_vars: set[str] = set()
        for node in ast.walk(fi.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and self._is_begin_call(fi, node.value)
            ):
                begun_vars.add(node.targets[0].id)
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Return) and node.value is not None:
                if isinstance(node.value, ast.Call) and self._is_begin_call(
                    fi, node.value
                ):
                    return True
                if (
                    isinstance(node.value, ast.Name)
                    and node.value.id in begun_vars
                ):
                    return True
        return False

    def _scan_closer(self, fi: flow.FunctionInfo) -> set[str]:
        params = set(fi.params)
        closed: set[str] = set()
        for call in flow.iter_calls(fi.node):
            for name in self._closed_params_of_call(fi, call):
                if name in params:
                    closed.add(name)
        return closed

    # -- token-relevant parameters ----------------------------------------

    def _token_params(self, fi: flow.FunctionInfo) -> set[str]:
        """Parameters that can carry a journal token: passed onward into
        a close/mark primitive or a callee's token parameter (one level
        of the call graph per fixpoint round is enough in practice)."""
        if fi in self._token_param_memo:
            return self._token_param_memo[fi]
        self._token_param_memo[fi] = set()  # recursion guard
        out = self._token_params_uncached(fi)
        self._token_param_memo[fi] = out
        return out

    def _token_params_uncached(self, fi: flow.FunctionInfo) -> set[str]:
        params = set(fi.params)
        out: set[str] = set()
        for call in flow.iter_calls(fi.node):
            names: list[str] = []
            prim = _close_primitive_arg(call)
            if prim is not None:
                names.append(prim)
            fn = call.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "mark"
                and "intents" in _chain_names(fn.value)
                and call.args
                and isinstance(call.args[0], ast.Name)
            ):
                names.append(call.args[0].id)
            target = self.index.resolve(fi, call)
            if target is not None:
                bound = target.bind_args(call)
                for p in self.closers.get(target, set()) | (
                    self._token_params(target) if target is not fi else set()
                ):
                    arg = bound.get(p)
                    if isinstance(arg, ast.Name):
                        names.append(arg.id)
            out.update(n for n in names if n in params)
        return out

    # -- parameter token state (interprocedural) ---------------------------

    def param_state(self, fi: flow.FunctionInfo, param: str) -> frozenset:
        key = (fi, param)
        if key in self._param_memo:
            return self._param_memo[key]
        if key in self._param_inflight:
            # Recursion along the call graph: conservative, never proven.
            return frozenset((OTHER,))
        self._param_inflight.add(key)
        try:
            sites = self.index.call_sites(fi)
            if not sites:
                state: frozenset = frozenset((OTHER,))
            else:
                state = frozenset()
                for caller, call in sites:
                    bound = fi.bind_args(call)
                    arg = bound.get(param)
                    if arg is None:
                        default = fi.param_default(param)
                        state |= self._expr_state_static(default)
                    else:
                        state |= self._arg_state_at(caller, call, arg)
                if not state:
                    state = frozenset((OTHER,))
            self._param_memo[key] = state
            return state
        finally:
            self._param_inflight.discard(key)

    def _expr_state_static(self, expr: ast.expr | None) -> frozenset:
        if expr is None:
            return frozenset((OTHER,))
        if isinstance(expr, ast.Constant) and expr.value is None:
            return frozenset((NONE,))
        return frozenset((OTHER,))

    def _arg_state_at(
        self, caller: flow.FunctionInfo, call: ast.Call, arg: ast.expr
    ) -> frozenset:
        """The token state of ``arg`` at ``call``'s statement in the
        caller, from the caller's own dataflow."""
        if isinstance(arg, ast.Call) and self._is_begin_call(caller, arg):
            return _open_state_of(arg)
        if isinstance(arg, ast.Constant) and arg.value is None:
            return frozenset((NONE,))
        if not isinstance(arg, ast.Name):
            return frozenset((OTHER,))
        analysis = self.analyze(caller)
        cfg = self._cfg(caller)
        for node in cfg.nodes:
            if node.stmt is None:
                continue
            found = any(c is call for c in flow.stmt_calls(node.stmt))
            if found:
                env = analysis.get(node.idx)
                if env is None:
                    return frozenset((OTHER,))
                return env.get(arg.id, frozenset((OTHER,)))
        return frozenset((OTHER,))

    # -- per-function dataflow --------------------------------------------

    def _cfg(self, fi: flow.FunctionInfo) -> flow.CFG:
        if fi not in self._cfgs:
            self._cfgs[fi] = flow.build_cfg(fi.node)
        return self._cfgs[fi]

    def analyze(self, fi: flow.FunctionInfo) -> dict[int, dict]:
        """IN-state (var -> frozenset) per CFG node index, to fixpoint."""
        if fi in self._analysis:
            return self._analysis[fi]
        # Publish the (empty) in-progress result so self-recursive
        # shapes terminate with conservative answers.
        self._analysis[fi] = {}
        cfg = self._cfg(fi)
        entry_env: dict[str, frozenset] = {}
        for p in self._token_params(fi):
            entry_env[p] = self.param_state(fi, p)
        in_states: dict[int, dict] = {cfg.entry.idx: entry_env}
        out_states: dict[int, dict] = {}
        work = [cfg.entry.idx]
        iters = 0
        limit = 50 * max(1, len(cfg.nodes))
        while work and iters < limit:
            iters += 1
            idx = work.pop()
            node = cfg.nodes[idx]
            env_in = in_states.get(idx, {})
            env_out = self._transfer(fi, node, dict(env_in))
            out_states[idx] = env_out
            for s in node.succs:
                succ_env = self._refine(node, s, env_out)
                merged = self._merge(in_states.get(s), succ_env)
                if merged != in_states.get(s):
                    in_states[s] = merged
                    work.append(s)
        self._analysis[fi] = in_states
        return in_states

    @staticmethod
    def _merge(a: dict | None, b: dict) -> dict:
        if a is None:
            return dict(b)
        out = dict(a)
        for k, v in b.items():
            if k in out:
                out[k] = out[k] | v
            else:
                # Unbound on the already-merged paths: could be anything
                # there. Same for the symmetric case below.
                out[k] = v | frozenset((OTHER,))
        for k in out:
            if k not in b:
                out[k] = out[k] | frozenset((OTHER,))
        return out

    def _transfer(
        self, fi: flow.FunctionInfo, node: flow.Node, env: dict
    ) -> dict:
        stmt = node.stmt
        if stmt is None or node.kind == "handler":
            return env
        # Close calls anywhere in the statement resolve their token.
        for call in flow.stmt_calls(stmt):
            for name in self._closed_params_of_call(fi, call):
                env[name] = frozenset((CLOSED,))
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is not None:
            state = self._value_state(fi, value, env)
            for t in targets:
                if isinstance(t, ast.Name):
                    env[t.id] = state
                else:
                    # Tuple/attribute/subscript targets: any plain name
                    # inside is rebound to something we can't classify.
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            env[sub.id] = frozenset((OTHER,))
        # Other rebinding forms (loop targets, `with ... as x`): the
        # bound names stop being classifiable tokens.
        rebinders: list[ast.expr] = []
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            rebinders.append(stmt.target)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            rebinders.extend(
                item.optional_vars for item in stmt.items
                if item.optional_vars is not None
            )
        for target in rebinders:
            for sub in ast.walk(target):
                if isinstance(sub, ast.Name):
                    env[sub.id] = frozenset((OTHER,))
        if isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Name):
            # Returning the token hands ownership to the caller, whose
            # own analysis takes over (beginner summaries).
            env[stmt.value.id] = frozenset((CLOSED,))
        return env

    def _value_state(
        self, fi: flow.FunctionInfo, value: ast.expr, env: dict
    ) -> frozenset:
        if isinstance(value, ast.Constant) and value.value is None:
            return frozenset((NONE,))
        if isinstance(value, ast.Name):
            return env.get(value.id, frozenset((OTHER,)))
        if isinstance(value, ast.Call) and self._is_begin_call(fi, value):
            return _open_state_of(value)
        return frozenset((OTHER,))

    @staticmethod
    def _refine(node: flow.Node, succ: int, env: dict) -> dict:
        """Apply single-variable None-ness refinement along a labeled
        ``if`` edge."""
        polarity = node.branch.get(succ)
        if polarity is None or not isinstance(node.stmt, ast.If):
            return env
        test = node.stmt.test
        var, none_if_true = None, None
        if (
            isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and len(test.ops) == 1
            and len(test.comparators) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            if isinstance(test.ops[0], ast.Is):
                var, none_if_true = test.left.id, True
            elif isinstance(test.ops[0], ast.IsNot):
                var, none_if_true = test.left.id, False
        elif isinstance(test, ast.Name):
            var, none_if_true = test.id, False  # truthy -> not None
        elif (
            isinstance(test, ast.UnaryOp)
            and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Name)
        ):
            var, none_if_true = test.operand.id, True
        if var is None or var not in env:
            return env
        keep_none = none_if_true == (polarity == "true")
        out = dict(env)
        if keep_none:
            out[var] = env[var] & frozenset((NONE,)) or frozenset((NONE,))
        else:
            out[var] = env[var] - frozenset((NONE,)) or env[var]
        return out


def _functions_of(src: SourceFile, index: flow.CallIndex):
    return [
        fi for fi in index.functions.values() if fi.src is src
    ]


def check(ctx: LintContext) -> list[Finding]:
    engine = _Engine(ctx)
    findings: list[Finding] = []
    for src in engine.files:
        proven_ids: set[int] = set()
        for fi in _functions_of(src, engine.index):
            findings.extend(_check_function(engine, src, fi, proven_ids))
        # Coverage backstop: hardware calls the flow engine could not
        # even SEE — module level, nested defs/lambdas (closures run
        # later, possibly outside any bracket), class bodies. These
        # degrade to findings, never to silent cleanliness.
        findings.extend(_check_unanalyzed(src, proven_ids))
    return findings


def _check_unanalyzed(src: SourceFile, proven_ids: set[int]) -> list[Finding]:
    findings: list[Finding] = []
    stack: list[ast.AST] = []

    def visit(node: ast.AST) -> None:
        is_scope = isinstance(
            node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
        )
        if is_scope:
            stack.append(node)
        if isinstance(node, ast.Call) and id(node) not in proven_ids:
            op = _is_backend_hw_call(node)
            if op is not None and src.annotation(
                node.lineno, "journal-ok",
                span_end=getattr(node, "end_lineno", node.lineno),
            ) is None:
                symbol = qualname_of(stack)
                f = Finding(
                    checker=CHECKER,
                    path=src.relpath,
                    line=node.lineno,
                    message=(
                        f"backend.{op} in {symbol} sits where the flow "
                        "engine cannot prove a journal bracket (module "
                        "level, or a closure that runs later) — move it "
                        "into a journaled method, or waive with "
                        "`# cclint: journal-ok(reason)`"
                    ),
                    symbol=symbol,
                    detail=op,
                )
                if f.fingerprint not in ALLOWLIST:
                    findings.append(f)
        for child in ast.iter_child_nodes(node):
            visit(child)
        if is_scope:
            stack.pop()

    visit(src.tree)
    return findings


def _check_function(
    engine: _Engine, src: SourceFile, fi: flow.FunctionInfo,
    proven_ids: set[int],
) -> list[Finding]:
    hw_stmts: list[tuple[flow.Node, str]] = []
    begun_stmts: list[tuple[ast.stmt, str]] = []
    cfg = engine._cfg(fi)
    for node in cfg.nodes:
        if node.stmt is None or node.kind == "handler":
            continue
        for call in flow.stmt_calls(node.stmt):
            op = _is_backend_hw_call(call)
            if op is not None:
                hw_stmts.append((node, op))
                # Seen by the flow analysis: the backstop pass must not
                # double-report it (whatever the verdict here).
                proven_ids.add(id(call))
        if isinstance(node.stmt, ast.Assign) and isinstance(
            node.stmt.value, ast.Call
        ) and engine._is_begin_call(fi, node.stmt.value):
            for t in node.stmt.targets:
                if isinstance(t, ast.Name):
                    begun_stmts.append((node.stmt, t.id))
    if not hw_stmts and not begun_stmts:
        return []
    analysis = engine.analyze(fi)
    findings: list[Finding] = []

    # -- begin-dominates-reset --------------------------------------------
    for node, op in hw_stmts:
        env = analysis.get(node.idx)
        proven = env is not None and any(
            _proves_hw(state) for state in env.values()
        )
        if proven:
            continue
        stmt = node.stmt
        if src.annotation(
            stmt.lineno, "journal-ok", span_end=stmt.end_lineno
        ) is not None:
            continue
        f = Finding(
            checker=CHECKER,
            path=src.relpath,
            line=stmt.lineno,
            message=(
                f"backend.{op} in {fi.qualname} is not dominated by an "
                "intent-begin journal write on every path — journal the "
                "intent first (intent_journal.begin / a begin wrapper), "
                "or thread the caller's token so the engine can prove "
                "the bracket"
            ),
            symbol=fi.qualname,
            detail=op,
        )
        if f.fingerprint not in ALLOWLIST:
            findings.append(f)

    # -- close-postdominates-exit -----------------------------------------
    exit_env = analysis.get(cfg.exit.idx)
    for stmt, var in begun_stmts:
        if exit_env is None:
            continue  # no normal exit reaches — raise-only function
        state = exit_env.get(var, frozenset())
        if not any(_is_open(v) for v in state):
            continue
        if src.annotation(
            stmt.lineno, "intent-open-ok", span_end=stmt.end_lineno
        ) is not None:
            continue
        f = Finding(
            checker=CHECKER,
            path=src.relpath,
            line=stmt.lineno,
            message=(
                f"intent begun here ({var}) may still be open on a "
                f"non-crash exit of {fi.qualname} — close it "
                "(commit/abort) on every return path, or annotate "
                "`# cclint: intent-open-ok(reason)` if replay is the "
                "designed owner"
            ),
            symbol=fi.qualname,
            detail=f"open-{var}",
        )
        if f.fingerprint not in ALLOWLIST:
            findings.append(f)
    return findings
