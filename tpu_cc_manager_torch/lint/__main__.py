"""cclint driver: ``python -m tpu_cc_manager_torch.lint``.

Runs every contract checker over the package (plus the kill-at suites
under ``tests/`` for the checkers that read them), executes the
Prometheus exposition lint's seeded live-registry render, filters
findings through the committed baseline, and exits non-zero on anything
new — or on a STALE baseline entry: an entry whose violation is gone is
debt that must be deleted in the same change that fixed it.

``--json`` emits the machine-readable report CI archives; the default
text output is shaped for the GitHub problem matcher
(``.github/cclint-problem-matcher.json``), so findings surface as PR
annotations. ``--changed-only <git-ref>`` is the fast review mode: the
ANALYSIS still runs whole-package (the interprocedural checkers need
the full call graph), but only findings in files changed since
``<git-ref>`` are reported — stale-baseline detection stays global.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

from tpu_cc_manager_torch.lint import base, baseline as baseline_mod, expo
from tpu_cc_manager_torch.lint import (
    crash,
    crashpoints,
    fenced,
    journal,
    locks,
    surface,
    waits,
)
from tpu_cc_manager_torch.lint.base import Finding

CHECKERS = (locks, waits, crash, journal, fenced, crashpoints, surface)


def _repo_root() -> str:
    """The repo root: the directory holding the tpu_cc_manager_torch package."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def run(root: str, skip_expo: bool = False) -> list[Finding]:
    ctx = base.build_context(root)
    # One seeded render serves both the surface checker's metric-unseeded
    # sub-check and the exposition pass below.
    seeded = surface.seeded_render()
    findings: list[Finding] = []
    for checker in CHECKERS:
        if checker is surface:
            findings.extend(surface.check(ctx, seeded_render_text=seeded))
        else:
            findings.extend(checker.check(ctx))
    if not skip_expo and seeded is not None:
        for problem in expo.lint(seeded):
            findings.append(
                Finding(
                    checker="expo",
                    path="tpu_cc_manager_torch/utils/metrics.py",
                    line=1,
                    message=f"exposition lint: {problem}",
                    symbol="exposition",
                    # Fingerprints are line-independent by design; the
                    # problem text leads with the exposition line number,
                    # which shifts whenever a family is added.
                    detail=re.sub(r"^line \d+:\s*", "", problem)[:80],
                )
            )
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings


def changed_files(root: str, ref: str) -> set[str] | None:
    """Repo-relative paths changed since ``ref`` (committed diff plus
    untracked files); None when git cannot answer — the caller falls
    back to full reporting rather than silently reporting nothing."""
    try:
        diff = subprocess.run(
            ["git", "-C", root, "diff", "--name-only", ref],
            capture_output=True, text=True, timeout=30, check=True,
        )
        untracked = subprocess.run(
            ["git", "-C", root, "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    out = set()
    for line in diff.stdout.splitlines() + untracked.stdout.splitlines():
        line = line.strip()
        if line:
            out.add(line)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_cc_manager_torch.lint",
        description="contract-aware static analysis (see docs/cclint.md)",
    )
    parser.add_argument("--root", default=None, help="repo root (default: auto)")
    parser.add_argument(
        "--baseline", default=None, help=f"baseline path (default: <root>/{baseline_mod.BASELINE_FILE})"
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable report on stdout"
    )
    parser.add_argument(
        "--json-file", metavar="PATH", default=None,
        help="also write the machine-readable report to PATH (one "
        "analysis run serves both the annotated text output and the "
        "archived report)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="grandfather every current finding (existing reasons are "
        "preserved; new entries get TODO stubs to hand-edit; entries "
        "whose violations are gone are pruned)",
    )
    parser.add_argument(
        "--skip-expo", action="store_true",
        help="skip the Prometheus exposition lint pass",
    )
    parser.add_argument(
        "--changed-only", metavar="GIT_REF", default=None,
        help="fast review mode: report only findings in files changed "
        "since GIT_REF (full analysis still runs; stale-baseline "
        "detection stays global)",
    )
    args = parser.parse_args(argv)

    root = args.root or _repo_root()
    started = time.monotonic()
    findings = run(root, skip_expo=args.skip_expo)
    if args.write_baseline:
        path = baseline_mod.save(root, findings, args.baseline)
        print(f"wrote {len(set(f.fingerprint for f in findings))} entries to {path}")
        return 0
    known = baseline_mod.load(root, args.baseline)
    new, grandfathered, stale = baseline_mod.split(findings, known)
    scoped = None
    if args.changed_only is not None:
        scoped = changed_files(root, args.changed_only)
        if scoped is None:
            print(
                f"--changed-only: git diff against {args.changed_only!r} "
                "failed; reporting everything", file=sys.stderr,
            )
        else:
            new = [f for f in new if f.path in scoped]
    elapsed = time.monotonic() - started

    ok = not new and not stale
    report = json.dumps(
        {
            "ok": ok,
            "elapsed_s": round(elapsed, 3),
            "changed_only": args.changed_only,
            "new": [f.to_dict() for f in new],
            "grandfathered": [f.to_dict() for f in grandfathered],
            "stale_baseline_entries": stale,
        },
        indent=2,
    )
    if args.json_file:
        with open(args.json_file, "w", encoding="utf-8") as fh:
            fh.write(report + "\n")
    if args.json:
        print(report)
    else:
        for f in new:
            print(f"{f.path}:{f.line}: [{f.checker}] {f.message}")
            print(f"    fingerprint: {f.fingerprint}")
        for fp in stale:
            # Same shape the problem matcher parses; the baseline file
            # is where the fix goes.
            print(
                f"{baseline_mod.BASELINE_FILE}:1: [baseline] stale entry "
                f"{fp} — its violation is fixed; delete the entry"
            )
        print(
            f"cclint: {len(new)} new, {len(grandfathered)} grandfathered, "
            f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'} "
            f"({elapsed:.2f}s)"
            + (f" [changed-only vs {args.changed_only}]" if scoped is not None else "")
        )
        if new:
            print(
                "fix the findings, or (deliberate keeps only) add baseline "
                f"entries with reasons to {baseline_mod.BASELINE_FILE}"
            )
        if stale:
            print(
                "stale baseline entries are a HARD error: delete them from "
                f"{baseline_mod.BASELINE_FILE} (the violations they "
                "grandfathered are gone)"
            )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
