"""Checker 5: contract-surface drift.

The agent's outward contract is spread across four surfaces that only
stay consistent by discipline: the ``CC_*`` environment variables the
code reads, the env table in ``docs/operations.md``, the env the
DaemonSet manifest sets, the metric families the registry emits (which
must be exercised by the exposition lint's seeded render and documented),
and the ``cloud.google.com/tpu-cc.*`` / ``tpu-cc.gke.io`` label and
annotation keys — which must all come from ``labels.py`` (one module
owns the wire names) rather than inline literals.

Four sub-checks:

- **env-undocumented** — a ``CC_*`` env read anywhere in the package that
  appears in neither the docs/operations.md env table nor the port's own
  (README.md, under ``PORT_ENV_HEADING``);
- **env-unread** — a ``CC_*`` env the daemonset sets that nothing reads
  (manifest drift: a typo'd or retired knob silently configuring nothing);
- **metric-drift** — a ``tpu_cc_*`` family declared in utils/metrics.py
  that the seeded exposition-lint render never emits (unseeded: a
  registry regression in that family would pass CI) or that no docs
  page mentions;
- **label-literal** — an inline ``cloud.google.com/tpu-cc*`` /
  ``tpu-cc.gke.io`` string outside labels.py (docstrings exempt).
"""

from __future__ import annotations

import ast
import re

from tpu_cc_manager_torch.lint.base import Finding, LintContext

CHECKER = "surface"

ENV_RE = re.compile(r"^CC_[A-Z0-9_]+$")
DOCS_ENV_PATH = "docs/operations.md"
PORT_ENV_PATH = "README.md"
PORT_ENV_HEADING = "### Environment of the port"
DAEMONSET_PATH = "tpu_cc_manager_torch/deploy/daemonset.yaml"
METRICS_PATH = "tpu_cc_manager_torch/utils/metrics.py"
LABELS_PATH = "tpu_cc_manager_torch/labels.py"
DOC_PATHS = ("docs/observability.md", "docs/operations.md")
LABEL_PREFIXES = ("cloud.google.com/tpu-cc", "tpu-cc.gke.io")
_FAMILY_RE = re.compile(r"#\s(?:HELP|TYPE)\s(tpu_cc_[a-z0-9_]+)")
_DAEMONSET_ENV_RE = re.compile(r"-\s*name:\s*(CC_[A-Z0-9_]+)\b")


def _env_name_of(call: ast.Call) -> str | None:
    """The literal env name of an ``os.environ.get``/``os.getenv`` call
    (or None)."""
    fn = call.func
    is_env_get = (
        isinstance(fn, ast.Attribute)
        and fn.attr == "get"
        and isinstance(fn.value, ast.Attribute)
        and fn.value.attr == "environ"
    )
    is_getenv = isinstance(fn, ast.Attribute) and fn.attr == "getenv"
    if not (is_env_get or is_getenv) or not call.args:
        return None
    first = call.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value
    return None


def _env_reads(ctx: LintContext) -> dict[str, tuple[str, int]]:
    """CC_* env name -> first (path, line) that reads it. Covers
    ``os.environ.get``, ``os.getenv``, ``os.environ[...]`` and env names
    bound to module constants ending in ``_ENV`` (the
    ``os.environ.get(OFFLINE_GRACE_ENV, ...)`` idiom)."""
    reads: dict[str, tuple[str, int]] = {}
    for src in ctx.files:
        for node in ast.walk(src.tree):
            name: str | None = None
            if isinstance(node, ast.Call):
                name = _env_name_of(node)
            elif (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "environ"
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)
            ):
                name = node.slice.value
            elif (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_ENV")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                name = node.value.value
            if name and ENV_RE.match(name):
                reads.setdefault(name, (src.relpath, node.lineno))
    return reads


def _port_env_table(text: str | None) -> str:
    """The rows of the port's env table: the ``| `CC_...` |`` lines of
    the README section under ``PORT_ENV_HEADING``."""
    if text is None or PORT_ENV_HEADING not in text:
        return ""
    section = re.split(r"\n#{1,3} ", text.split(PORT_ENV_HEADING, 1)[1])[0]
    return "\n".join(
        line for line in section.splitlines() if line.startswith("| `CC_")
    )


def _docstring_constants(tree: ast.Module) -> set[int]:
    """ids of Constant nodes that are docstrings (exempt from the
    label-literal rule — documentation may name the wire keys)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            body = getattr(node, "body", [])
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                out.add(id(body[0].value))
    return out


def check(
    ctx: LintContext, seeded_render_text: str | None = None
) -> list[Finding]:
    findings: list[Finding] = []

    # -- env reads vs the docs table ------------------------------------
    docs = ctx.read_text(DOCS_ENV_PATH)
    reads = _env_reads(ctx)
    if docs is not None:
        docs += _port_env_table(ctx.read_text(PORT_ENV_PATH))
        for name in sorted(reads):
            if name not in docs:
                path, line = reads[name]
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=path,
                        line=line,
                        message=(
                            f"env {name} is read here but missing from the "
                            f"{DOCS_ENV_PATH} env table"
                        ),
                        symbol="env-undocumented",
                        detail=name,
                    )
                )

    # -- daemonset env vs code reads ------------------------------------
    daemonset = ctx.read_text(DAEMONSET_PATH)
    if daemonset is not None:
        for i, line_text in enumerate(daemonset.splitlines(), start=1):
            m = _DAEMONSET_ENV_RE.search(line_text)
            if m and m.group(1) not in reads:
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=DAEMONSET_PATH,
                        line=i,
                        message=(
                            f"daemonset sets {m.group(1)} but nothing in "
                            "the package reads it (manifest drift)"
                        ),
                        symbol="env-unread",
                        detail=m.group(1),
                    )
                )

    # -- metric families: seeded + documented ---------------------------
    metrics_src = ctx.file(METRICS_PATH)
    if metrics_src is not None:
        families = sorted(set(_FAMILY_RE.findall(metrics_src.source)))
        seeded_text = (
            seeded_render_text if seeded_render_text is not None
            else seeded_render()
        )
        doc_text = "\n".join(ctx.read_text(p) or "" for p in DOC_PATHS)
        for family in families:
            if seeded_text is not None and family not in seeded_text:
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=METRICS_PATH,
                        line=1,
                        message=(
                            f"metric family {family} is never emitted by "
                            "the exposition lint's seeded registry render "
                            "(lint/expo.py _seeded_registry_text) — seed it"
                        ),
                        symbol="metric-unseeded",
                        detail=family,
                    )
                )
            if doc_text and family not in doc_text:
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=METRICS_PATH,
                        line=1,
                        message=(
                            f"metric family {family} is documented in "
                            f"neither of {', '.join(DOC_PATHS)}"
                        ),
                        symbol="metric-undocumented",
                        detail=family,
                    )
                )

    # -- inline label-key literals --------------------------------------
    for src in ctx.files:
        if src.relpath == LABELS_PATH or src.relpath.startswith(
            "tpu_cc_manager_torch/lint/"
        ):
            # labels.py owns the wire names; the lint package holds the
            # prefixes as checker data, not as wire usage.
            continue
        docstrings = _docstring_constants(src.tree)
        for node in ast.walk(src.tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and any(p in node.value for p in LABEL_PREFIXES)
                and id(node) not in docstrings
            ):
                findings.append(
                    Finding(
                        checker=CHECKER,
                        path=src.relpath,
                        line=node.lineno,
                        message=(
                            f"inline label-key literal {node.value!r} — "
                            "wire names come from labels.py, import the "
                            "constant instead"
                        ),
                        symbol="label-literal",
                        detail=node.value[:60],
                    )
                )
    return findings


def seeded_render() -> str | None:
    """The exposition lint's seeded live-registry render (None if the
    registry cannot be imported — fixture contexts in unit tests). The
    driver calls this once and shares the text between this checker and
    the exposition pass."""
    try:
        from tpu_cc_manager_torch.lint import expo

        return expo._seeded_registry_text()
    except Exception:  # pragma: no cover - import-environment dependent
        return None
