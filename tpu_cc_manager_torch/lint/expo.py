"""Prometheus exposition-format lint for the agent's /metrics output.

A scraper that rejects one malformed line drops the WHOLE scrape, so a
regression in MetricsRegistry.render_prometheus (an unescaped label value,
a histogram bucket out of order, a sample with no TYPE) silently blinds
the fleet. This lint validates the invariants a real Prometheus parser
enforces, plus the histogram contract promtool checks:

- sample lines parse: ``name{label="value",...} value`` with valid metric
  and label names, and label values using only the three legal escapes
  (``\\``, ``\"``, ``\n``);
- every sampled metric family has exactly one # HELP and one # TYPE,
  declared before its first sample;
- histogram families: ``le`` parses as a float or ``+Inf``, bucket counts
  are non-decreasing as ``le`` increases (cumulative), the ``+Inf`` bucket
  exists, and ``_count`` equals the ``+Inf`` bucket per label set.

Run modes (the cclint driver runs the seeded mode as part of
``python -m tpu_cc_manager_torch.lint``; ``hack/check_metrics_lint.py`` remains
as a standalone shim over this module):

  python3 hack/check_metrics_lint.py                # lint a seeded live registry
  python3 hack/check_metrics_lint.py --url URL      # lint a live /metrics scrape
  python3 hack/check_metrics_lint.py --file PATH    # lint a saved exposition

Also imported by tests/test_metrics_lint.py as a fast tier-1 check.
"""

from __future__ import annotations

import argparse
import re
import sys

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
# A sample line: name, optional {labels}, value, optional timestamp.
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+(?P<ts>-?\d+))?$"
)
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_labels(raw: str, line_no: int, problems: list[str]) -> dict | None:
    """Parse a {..} label body with exposition-format escaping rules."""
    labels: dict[str, str] = {}
    i = 0
    n = len(raw)
    while i < n:
        m = _LABEL_NAME_RE.match(raw[i:])
        eq = raw.find("=", i)
        if eq < 0 or m is None or i + m.end() != eq:
            problems.append(f"line {line_no}: bad label name at offset {i}: {raw[i:]!r}")
            return None
        name = raw[i:eq]
        if eq + 1 >= n or raw[eq + 1] != '"':
            problems.append(f"line {line_no}: label {name} value not quoted")
            return None
        j = eq + 2
        value_chars: list[str] = []
        while j < n:
            c = raw[j]
            if c == "\\":
                if j + 1 >= n or raw[j + 1] not in ('\\', '"', 'n'):
                    problems.append(
                        f"line {line_no}: label {name}: illegal escape "
                        f"{raw[j:j+2]!r} (only \\\\, \\\" and \\n are legal)"
                    )
                    return None
                value_chars.append({"\\": "\\", '"': '"', "n": "\n"}[raw[j + 1]])
                j += 2
            elif c == '"':
                break
            elif c == "\n":
                problems.append(f"line {line_no}: label {name}: raw newline in value")
                return None
            else:
                value_chars.append(c)
                j += 1
        else:
            problems.append(f"line {line_no}: label {name}: unterminated value")
            return None
        labels[name] = "".join(value_chars)
        i = j + 1  # past closing quote
        if i < n:
            if raw[i] != ",":
                problems.append(
                    f"line {line_no}: expected ',' between labels, got {raw[i]!r}"
                )
                return None
            i += 1
    return labels


def _family(name: str, types: dict[str, str]) -> str:
    """The declared family a sample belongs to (histogram/summary samples
    use suffixed series names)."""
    for suffix in _HIST_SUFFIXES + ("_total",):
        base = name[: -len(suffix)] if name.endswith(suffix) else None
        if base and types.get(base) in ("histogram", "summary"):
            return base
    return name


def lint(text: str) -> list[str]:
    """All exposition-format problems found in ``text`` (empty = clean)."""
    problems: list[str] = []
    helps: dict[str, int] = {}
    types: dict[str, str] = {}
    # family -> label-set-minus-le (as sorted tuple) -> [(le, count)]
    buckets: dict[str, dict[tuple, list[tuple[float, float]]]] = {}
    counts: dict[str, dict[tuple, float]] = {}
    sampled_families: dict[str, int] = {}

    for line_no, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                if not _METRIC_NAME_RE.match(name):
                    problems.append(f"line {line_no}: bad metric name {name!r}")
                    continue
                if parts[1] == "HELP":
                    if name in helps:
                        problems.append(
                            f"line {line_no}: duplicate HELP for {name} "
                            f"(first at line {helps[name]})"
                        )
                    helps[name] = line_no
                else:
                    if name in types:
                        problems.append(f"line {line_no}: duplicate TYPE for {name}")
                    if name in sampled_families:
                        problems.append(
                            f"line {line_no}: TYPE for {name} after its first "
                            f"sample (line {sampled_families[name]})"
                        )
                    types[name] = (parts[3].strip() if len(parts) > 3 else "")
            # other comments are legal and ignored
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {line_no}: unparseable sample: {line!r}")
            continue
        name = m.group("name")
        raw_labels = m.group("labels")
        labels = (
            _parse_labels(raw_labels, line_no, problems)
            if raw_labels is not None and raw_labels != ""
            else {}
        )
        if labels is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            if m.group("value") not in ("+Inf", "-Inf", "NaN"):
                problems.append(
                    f"line {line_no}: unparseable value {m.group('value')!r}"
                )
                continue
            value = float(m.group("value").replace("Inf", "inf"))
        family = _family(name, types)
        sampled_families.setdefault(family, line_no)
        if types.get(family) == "histogram":
            key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            if name.endswith("_bucket"):
                le_raw = labels.get("le")
                if le_raw is None:
                    problems.append(f"line {line_no}: histogram bucket without le label")
                    continue
                try:
                    le = float("inf") if le_raw == "+Inf" else float(le_raw)
                except ValueError:
                    problems.append(f"line {line_no}: unparseable le {le_raw!r}")
                    continue
                buckets.setdefault(family, {}).setdefault(key, []).append((le, value))
            elif name.endswith("_count"):
                counts.setdefault(family, {})[key] = value

    for family in sorted(sampled_families):
        if family not in helps:
            problems.append(f"metric family {family} has samples but no # HELP")
        if family not in types:
            problems.append(f"metric family {family} has samples but no # TYPE")

    for family, by_labels in sorted(buckets.items()):
        for key, series in sorted(by_labels.items()):
            ordered = sorted(series)
            if [b for b, _ in ordered] != [b for b, _ in series]:
                problems.append(
                    f"{family}{dict(key)}: buckets not emitted in increasing le order"
                )
            les = [le for le, _ in ordered]
            if len(les) != len(set(les)):
                problems.append(f"{family}{dict(key)}: duplicate le bounds")
            vals = [v for _, v in ordered]
            if any(later < earlier for earlier, later in zip(vals, vals[1:])):
                problems.append(
                    f"{family}{dict(key)}: bucket counts are not cumulative "
                    f"(non-monotonic): {vals}"
                )
            if not les or les[-1] != float("inf"):
                problems.append(f"{family}{dict(key)}: missing +Inf bucket")
            else:
                count = counts.get(family, {}).get(key)
                if count is not None and count != vals[-1]:
                    problems.append(
                        f"{family}{dict(key)}: _count {count} != +Inf bucket {vals[-1]}"
                    )
    return problems


def _seeded_registry_text() -> str:
    """Render a live registry exercised through the real phase/finish path
    — including awkward label values — so the lint checks what the agent
    actually serves, not a synthetic fixture. The cclint surface checker
    (lint/surface.py) additionally requires every family declared in
    utils/metrics.py to appear in this render, so a new family cannot
    ship unseeded."""
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

    registry = MetricsRegistry()
    for mode in ("on", 'odd"mode\nwith\\escapes'):
        m = registry.start(mode)
        for phase in ("drain", "reset", "wait_ready"):
            with m.phase(phase):
                pass
        m.finish("ok")
    m = registry.start("off")
    m.result = "failed"
    m.finish("failed")
    registry.record_failure("attestation-failed")
    registry.record_failure('weird"reason')
    registry.record_retry("kube.get", "throttled")
    registry.record_retry("tpuvm.reset", 'odd"reason\nhere')
    registry.set_breaker_state("apiserver", "half_open")
    registry.set_breaker_state("device-cmd", "closed")
    registry.set_health_tier("device-node", 1, healthy=False)
    # Failure-containment families (ccmanager/remediation.py + slice
    # fencing), awkward outcome value included.
    registry.set_quarantined(True)
    registry.record_remediation_step("device-reset", "ok")
    registry.record_remediation_step("quarantine", 'odd"outcome')
    registry.record_barrier_fenced()
    # Crash-safe rollout families (ccmanager/rollout_state.py).
    registry.record_rollout_resume()
    registry.record_lease_transition()
    registry.record_lease_transition()
    registry.record_fenced_write()
    # Federated rollout families (ccmanager/federation.py).
    registry.record_federation_sync("ok")
    registry.record_federation_sync('odd"outcome\nhere')
    registry.record_federation_fence("parent-generation")
    registry.record_federation_fence('odd"reason\nhere')
    registry.set_federation_budget_spent(7)
    # Parent-plane partition tolerance (escrowed degraded mode).
    registry.set_federation_offline_seconds(12.5)
    registry.set_federation_escrow(3, 1)
    # Apiserver-outage autonomy families (ccmanager/intent_journal.py).
    registry.set_apiserver_connected(False)
    registry.set_offline_seconds(93.5)
    registry.record_journal_replay("completed")
    registry.record_journal_replay("rolled-back")
    registry.record_journal_replay('odd"outcome\nhere')
    registry.record_deferred_patch()
    # Fleet-scale orchestration family (kubeclient per-verb accounting).
    registry.record_apiserver_request("list")
    registry.record_apiserver_request("watch")
    registry.record_apiserver_request('odd"verb')
    # Fleet-churn families (preemption fast-drain + autoscaler interplay).
    registry.record_preemption("handoff")
    registry.record_preemption("clean")
    registry.record_preemption('odd"outcome')
    registry.record_node_adoption(3)
    registry.set_fast_drain_seconds(1.234)
    # Pipelined-transition families (overlap gauge + smoke fast path).
    registry.set_phase_overlap_seconds(22.5)
    registry.record_smoke_fastpath("hit")
    registry.record_smoke_fastpath("miss")
    registry.record_smoke_fastpath('odd"outcome\nhere')
    # Live serving telemetry (serve/ + obs/slo.py), awkward node name
    # included.
    registry.observe_serve_request("serve-node-0", 0.042)
    registry.observe_serve_request("serve-node-0", 0.180)
    registry.observe_serve_request('odd"node\nname', 1.5)
    registry.set_serve_queue_depth("serve-node-0", 7)
    registry.set_serve_inflight("serve-node-0", 4)
    registry.record_serve_outcome("serve-node-0", "completed", 2)
    registry.record_serve_outcome("serve-node-0", "bounced")
    registry.record_serve_outcome("serve-node-0", "requeued")
    registry.record_serve_outcome("serve-node-0", "shed", 2)
    registry.record_serve_outcome('odd"node', 'odd"outcome')
    registry.record_serve_lost(1)
    registry.record_serve_deadline_miss("serve-node-0", 3)
    registry.record_serve_deadline_miss('odd"node\nname')
    registry.set_serve_offered_rps(997.25)
    registry.record_slo_pause()
    registry.set_serve_goodput(812.5)
    registry.set_serve_slo(30.0, 0.059, 0.2)
    registry.set_serve_slo(300.0, None, 0.0)  # empty window: no p99
    # Zero-bounce flip families (serve/ handoff + ccmanager prestage).
    registry.record_serve_handoff("accepted", 3)
    registry.record_serve_handoff("fallback")
    registry.record_serve_handoff('odd"outcome')
    registry.set_spare_prestage_seconds(31.3)
    # Capacity-ledger inputs (obs/fleet.py headroom judgment).
    registry.set_serve_hbm_bw_util("serve-node-0", 0.73)
    registry.set_serve_hbm_bw_util('odd"node\nname', 0.99)
    registry.set_prestage_in_progress(True)
    # Continuous-prestage ledger families (ccmanager/rolling.py
    # continuous_prestage, record v7), awkward outcome value included.
    registry.set_prestage_reserved(2)
    registry.set_prestage_headroom_nodes(1)
    registry.record_prestage("reserved")
    registry.record_prestage("armed")
    registry.record_prestage("held")
    registry.record_prestage("converged")
    registry.record_prestage("invalidated")
    registry.record_prestage("degraded")
    registry.record_prestage("paused")
    registry.record_prestage('odd"outcome\nhere')
    # Fail-slow vetting families (obs/failslow.py peer-relative
    # gray-failure detection), hostile node/verdict labels included.
    registry.set_failslow_suspect("serve-node-0", True)
    registry.set_failslow_suspect('odd"node\nname', False)
    registry.set_failslow_deviation("serve-node-0", 3.4142)
    registry.set_failslow_deviation('odd"node\nname', 0.98)
    registry.record_failslow_verdict("serve-node-0", "confirmed")
    registry.record_failslow_verdict("serve-node-0", "cleared")
    registry.record_failslow_verdict('odd"node\nname', 'odd"verdict')
    return registry.render_prometheus()


def _seeded_fleet_text() -> str:
    """The fleet gateway's MERGED exposition over seeded per-node
    registries — what ``obs/fleet.py`` actually serves at fleet
    ``/metrics``. Two full seeded agents plus one partial-overlap agent
    (different node names, a subset of families) exercise the merge's
    HELP/TYPE dedup, label-preserving summation and histogram
    conservation, then the fleet's own ``tpu_cc_fleet_*`` families are
    appended by the gateway's rebuild — so federation regressions fail
    the same lint the per-agent render does."""
    from tpu_cc_manager_torch.obs import fleet as fleet_mod
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

    partial = MetricsRegistry()
    partial.observe_serve_request("fleet-node-2", 0.021)
    partial.observe_serve_request("fleet-node-2", 2.75)
    partial.set_serve_queue_depth("fleet-node-2", 1)
    partial.set_serve_hbm_bw_util("fleet-node-2", 0.42)
    partial.record_serve_outcome("fleet-node-2", "completed", 5)
    gateway = fleet_mod.FleetGateway(targets={
        "agent-a": fleet_mod.local_target(_SeededRegistry()),
        "agent-b": fleet_mod.local_target(_SeededRegistry()),
        "agent-c": fleet_mod.local_target(partial),
    })
    gateway.scrape_once()
    return gateway.metrics_text()


class _SeededRegistry:
    """Duck-typed registry whose render IS the seeded exposition — so
    the fleet seed reuses _seeded_registry_text verbatim (hostile label
    values included) without re-driving the setters."""

    def render_prometheus(self) -> str:
        return _seeded_registry_text()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--url", help="scrape this /metrics URL and lint it")
    source.add_argument("--file", help="lint a saved exposition file")
    source.add_argument(
        "--fleet", action="store_true",
        help="lint the fleet gateway's MERGED exposition over seeded "
        "per-node registries (obs/fleet.py federation)",
    )
    args = parser.parse_args(argv)

    if args.url:
        import urllib.request

        with urllib.request.urlopen(args.url, timeout=10) as resp:
            text = resp.read().decode()
    elif args.file:
        with open(args.file, encoding="utf-8") as f:
            text = f.read()
    elif args.fleet:
        text = _seeded_fleet_text()
    else:
        text = _seeded_registry_text()

    problems = lint(text)
    for p in problems:
        print(f"LINT: {p}", file=sys.stderr)
    print(
        f"checked {len(text.splitlines())} lines: "
        + ("OK" if not problems else f"{len(problems)} problem(s)")
    )
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
