"""Shared plumbing for the cclint checkers.

Each source file is parsed once into a :class:`SourceFile` (AST +
per-line ``# cclint:`` annotation map, extracted with :mod:`tokenize` so
annotations inside strings don't count), and every checker receives the
same :class:`LintContext`. Findings carry a line number for humans and a
line-independent ``fingerprint`` for the baseline — line numbers drift
with every edit, so grandfathering keys on
``checker:relpath:symbol[:detail]`` instead.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

#: Annotation grammar: ``# cclint: <directive>(<arg>)`` with an optional
#: free-text tail. Multiple directives per line are legal (rare).
_ANNOTATION_RE = re.compile(
    r"#\s*cclint:\s*(?P<directive>[a-z-]+)\s*\(\s*(?P<arg>[^)]*?)\s*\)"
)


@dataclass
class Finding:
    """One violation: where it is, which contract, and a stable identity."""

    checker: str
    path: str  # repo-relative
    line: int
    message: str
    symbol: str  # enclosing scope or offending name — fingerprint input
    detail: str = ""  # extra fingerprint disambiguation (e.g. env name)

    @property
    def fingerprint(self) -> str:
        parts = [self.checker, self.path, self.symbol]
        if self.detail:
            parts.append(self.detail)
        return ":".join(parts)

    def to_dict(self) -> dict:
        return {
            "checker": self.checker,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


class SourceFile:
    """One parsed source file: AST, raw lines, and cclint annotations."""

    def __init__(self, root: str, relpath: str) -> None:
        self.relpath = relpath
        self.abspath = os.path.join(root, relpath)
        with open(self.abspath, "r", encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=relpath)
        # line -> [(directive, arg), ...], from real comment tokens only.
        self.annotations: dict[int, list[tuple[str, str]]] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type == tokenize.COMMENT:
                    for m in _ANNOTATION_RE.finditer(tok.string):
                        self.annotations.setdefault(tok.start[0], []).append(
                            (m.group("directive"), m.group("arg"))
                        )
        except tokenize.TokenError:
            pass  # the ast.parse above would have raised on real breakage

    def annotation(
        self, line: int, directive: str, *, span_end: int | None = None
    ) -> str | None:
        """The argument of ``directive`` on ``line`` (or any line through
        ``span_end`` — a multi-line statement's comment may sit on any of
        its physical lines); None when absent."""
        for ln in range(line, (span_end or line) + 1):
            for d, arg in self.annotations.get(ln, ()):
                if d == directive:
                    return arg
        return None


@dataclass
class LintContext:
    """Everything a checker may look at. ``root`` is the repo root;
    ``files`` covers ``tpu_cc_manager_torch/**/*.py`` and ``test_files``
    covers ``tests/**/*.py`` (the crash-point coverage and test-wait
    checkers read the suite; the package checkers never do)."""

    root: str
    files: list[SourceFile] = field(default_factory=list)
    test_files: list[SourceFile] = field(default_factory=list)

    def file(self, relpath: str) -> SourceFile | None:
        for f in self.files + self.test_files:
            if f.relpath == relpath:
                return f
        return None

    def read_text(self, relpath: str) -> str | None:
        """A non-Python contract surface (docs, manifests); None when the
        file does not exist."""
        path = os.path.join(self.root, relpath)
        try:
            with open(path, "r", encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None


def package_files(root: str, package_dir: str = "tpu_cc_manager_torch") -> list[str]:
    """Repo-relative paths of every package source file, sorted."""
    out: list[str] = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, package_dir)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(
                    os.path.relpath(os.path.join(dirpath, name), root)
                )
    return sorted(out)


def build_context(root: str) -> LintContext:
    ctx = LintContext(root=root)
    for relpath in package_files(root):
        ctx.files.append(SourceFile(root, relpath))
    for relpath in package_files(root, package_dir="tests"):
        ctx.test_files.append(SourceFile(root, relpath))
    return ctx


def qualname_of(stack: list[ast.AST]) -> str:
    """Dotted class/function path for the innermost scopes in ``stack``
    (module level -> ``<module>``)."""
    names = [
        n.name
        for n in stack
        if isinstance(n, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    return ".".join(names) if names else "<module>"
