"""Baseline: explicit, reasoned grandfathering of known violations.

``lint/cclint-baseline.json`` (in the package, committed) maps finding
fingerprints to one-line reasons. Fingerprints are line-independent
(``checker:path:symbol[:detail]``) so ordinary edits don't churn the
file; one entry covers every finding sharing its fingerprint (e.g. three
simulated-latency sleeps in one method).

A finding without an entry fails the build. An entry without a finding
is *stale* — and since v2 that is a HARD error too: the fix and the
entry deletion belong to the same change (`--write-baseline` regenerates
the file, preserving hand-written reasons and pruning fixed entries, so
shedding the grandfathering is one command, not an edit race).
"""

from __future__ import annotations

import json
import os

from tpu_cc_manager_torch.lint.base import Finding

BASELINE_FILE = "tpu_cc_manager_torch/lint/cclint-baseline.json"


def load(root: str, path: str | None = None) -> dict[str, str]:
    """fingerprint -> reason; empty when the file doesn't exist."""
    full = path or os.path.join(root, BASELINE_FILE)
    try:
        with open(full, "r", encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    entries = data.get("entries", [])
    return {e["fingerprint"]: e.get("reason", "") for e in entries}


def save(root: str, findings: list[Finding], path: str | None = None) -> str:
    """Write a baseline grandfathering every current finding (reasons
    stubbed TODO — each must be hand-edited to a real justification)."""
    full = path or os.path.join(root, BASELINE_FILE)
    existing = load(root, path)
    seen: dict[str, str] = {}
    for f in findings:
        seen.setdefault(
            f.fingerprint, existing.get(f.fingerprint, "TODO: justify")
        )
    payload = {
        "comment": (
            "cclint grandfathered violations. Every entry needs a one-line "
            "reason; remove entries as the violations are fixed. "
            "Regenerate skeleton: python -m tpu_cc_manager_torch.lint "
            "--write-baseline"
        ),
        "entries": [
            {"fingerprint": fp, "reason": reason}
            for fp, reason in sorted(seen.items())
        ],
    }
    with open(full, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return full


def split(
    findings: list[Finding], baseline: dict[str, str]
) -> tuple[list[Finding], list[Finding], list[str]]:
    """(new, grandfathered, stale-fingerprints)."""
    new: list[Finding] = []
    old: list[Finding] = []
    hit: set[str] = set()
    for f in findings:
        if f.fingerprint in baseline:
            old.append(f)
            hit.add(f.fingerprint)
        else:
            new.append(f)
    stale = sorted(set(baseline) - hit)
    return new, old, stale
