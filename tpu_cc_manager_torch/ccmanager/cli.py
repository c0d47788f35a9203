"""CLI entry / bootstrap of the port's node agent.

Port of ``tpu_cc_manager/ccmanager/cli.py`` (reference analogue: main(),
main.py:698-763; SURVEY.md §2 #1). The same flags and env-var defaults
(--kubeconfig/KUBECONFIG, --default-cc-mode/DEFAULT_CC_MODE default "on",
--node-name/NODE_NAME required, --debug, smoke workload, metrics port, JSON
logging), with the device layer chosen by --gpu-backend/GPU_CC_BACKEND
(``h100`` or ``fake``) and shown to the manager through
:class:`~tpu_cc_manager_torch.ccmanager.node.NodeBackend`. The node's
devices are discovered once before the agent starts: a backend that finds
none exits 1, never carrying on with another backend. The verify smoke
runs on the card; --smoke-device/CC_SMOKE_DEVICE ``cpu`` asks for the CPU
(the JAX agent's ``JAX_PLATFORMS=cpu``).
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import signal
import sys
import threading
import time

from tpu_cc_manager_torch.ccmanager.manager import CCManager
from tpu_cc_manager_torch.ccmanager.metrics_server import start_metrics_server
from tpu_cc_manager_torch.ccmanager.node import GpuError, NodeBackend
from tpu_cc_manager_torch.ccmanager.watchdog import start_from_env as start_watchdog
from tpu_cc_manager_torch.gpudev import load_backend
from tpu_cc_manager_torch.gpudev.hostcaps import is_host_cc_enabled
from tpu_cc_manager_torch.kubeclient.rest import ClusterConfig, RestKube
from tpu_cc_manager_torch.labels import MODE_OFF, VALID_MODES
from tpu_cc_manager_torch.utils.logging import setup_logging
from tpu_cc_manager_torch.version import __version__

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-cc-manager",
        description="confidential-computing node agent for NVIDIA H100 nodes",
    )
    p.add_argument(
        "--kubeconfig",
        default=os.environ.get("KUBECONFIG"),
        help="kubeconfig path (default: in-cluster config, then $KUBECONFIG)",
    )
    p.add_argument(
        "-m", "--default-cc-mode",
        default=os.environ.get("DEFAULT_CC_MODE", "on"),
        help="mode applied when the desired-mode label is absent (default: on; "
        "forced to 'off' when the host lacks CC capability)",
    )
    p.add_argument(
        "--node-name",
        default=os.environ.get("NODE_NAME"),
        help="this node's name (default: $NODE_NAME; required)",
    )
    p.add_argument(
        "--gpu-backend",
        default=os.environ.get("GPU_CC_BACKEND", "h100"),
        choices=("h100", "fake"),
        help="device layer: 'h100' on real H100 nodes, 'fake' for dry-runs",
    )
    p.add_argument(
        "--smoke-workload",
        default=os.environ.get("CC_SMOKE_WORKLOAD", "none"),
        help="workload run as the final verify phase after each "
        "reconfigure (default: none; see tpu_cc_manager_torch.smoke.runner.WORKLOADS)",
    )
    p.add_argument(
        "--smoke-device",
        default=os.environ.get("CC_SMOKE_DEVICE", "cuda"),
        choices=("cuda", "cpu"),
        help="where the verify smoke runs: 'cuda' (the node's cards; fails "
        "without one) or 'cpu' (an explicit request, for dry-runs)",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=int(os.environ.get("CC_METRICS_PORT", "0")),
        help="serve Prometheus metrics on this port (0 = disabled)",
    )
    p.add_argument("--json-logs", action="store_true",
                   default=os.environ.get("CC_JSON_LOGS", "").lower() in ("1", "true"))
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("--version", action="version", version=__version__)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(debug=args.debug, json_lines=args.json_logs)

    if not args.node_name:
        # Fatal misconfiguration (reference main.py:731-734).
        log.error("--node-name / NODE_NAME is required")
        return 1
    default_mode = args.default_cc_mode
    if default_mode not in VALID_MODES and default_mode not in ("ppcie",):
        log.error("invalid --default-cc-mode %r (valid: %s)", default_mode, VALID_MODES)
        return 1

    host_cc = is_host_cc_enabled()
    if not host_cc and default_mode != MODE_OFF:
        # Secure-by-default without bricking non-CC hosts
        # (reference main.py:736-742).
        log.warning(
            "host lacks CC capability; overriding default mode %r -> 'off'",
            default_mode,
        )
        default_mode = MODE_OFF

    try:
        api = RestKube(ClusterConfig.load(args.kubeconfig))
    except Exception as e:  # noqa: BLE001 - any config failure is fatal here
        log.error("could not configure kubernetes client: %s", e)
        return 1

    backend = NodeBackend(load_backend(args.gpu_backend))
    try:
        backend.discover()
    except GpuError as e:
        log.error("%s backend found no usable device: %s", args.gpu_backend, e)
        return 1
    # Node-local intent WAL (ccmanager/intent_journal.py) in the same
    # writable state dir the tpuvm backend persists its mode files to:
    # crash-restarts replay it BEFORE the first apiserver read, and a
    # total apiserver outage longer than CC_OFFLINE_GRACE_S flips the
    # agent into disconnected mode (serve last-known desired mode, defer
    # label writes as pending patches). CC_INTENT_JOURNAL=0 disables.
    intent_journal = None
    if os.environ.get("CC_INTENT_JOURNAL", "1").lower() not in (
        "0", "false", "no",
    ):
        from tpu_cc_manager_torch.ccmanager.intent_journal import IntentJournal
        from tpu_cc_manager_torch.gpudev.h100 import DEFAULT_STATE_DIR

        state_dir = (
            os.environ.get("CC_STATE_DIR")
            or getattr(backend, "state_dir", None)
            or DEFAULT_STATE_DIR
        )
        intent_journal = IntentJournal.from_state_dir(state_dir)
    smoke_runner = smoke_warmup_factory = None
    if args.smoke_device == "cpu":
        from tpu_cc_manager_torch.smoke.runner import SmokeWarmup, run_workload_subprocess

        smoke_runner = functools.partial(run_workload_subprocess, force_cpu=True)
        smoke_warmup_factory = functools.partial(SmokeWarmup, force_cpu=True)
    manager = CCManager(
        api=api,
        backend=backend,
        node_name=args.node_name,
        default_mode=default_mode,
        host_cc_capable=host_cc,
        smoke_workload=args.smoke_workload,
        smoke_runner=smoke_runner,
        smoke_warmup_factory=smoke_warmup_factory,
        intent_journal=intent_journal,
    )
    # Failure containment (ccmanager/remediation.py): escalating ladder
    # from backoff retries through device re-reset and runtime restart to
    # quarantine (taint + label + fenced slice barrier), persisted in a
    # node annotation so it survives agent crash-restarts.
    from tpu_cc_manager_torch.ccmanager import remediation as remediation_mod

    manager.remediation = remediation_mod.from_env(
        api,
        args.node_name,
        backend=backend,
        emit_event=manager._emit_node_event,
        metrics=manager.metrics,
        intents=intent_journal,
    )
    if args.metrics_port:
        # Same journal the manager records to, so /tracez and /statusz
        # serve the live reconcile traces; the intent journal backs the
        # /journalz endpoint `tpu-cc-ctl journal` reads.
        start_metrics_server(
            args.metrics_port, manager.metrics, journal=manager.journal,
            intent_journal=intent_journal,
        )
    # Graceful shutdown: SIGTERM (kubelet pod stop) sets the stop event so
    # the watch loop exits at the next event/timeout boundary and the
    # readiness file is withdrawn. A blocked watch read auto-retries after
    # the handler (PEP 475), so a hard-exit fallback thread guarantees the
    # process still dies promptly — but only while NO reconcile is in
    # flight: a half-applied hardware transition is never interrupted while
    # grace time (CC_SHUTDOWN_GRACE_S, default 20 s — size it below the
    # pod's terminationGracePeriod) remains. The preStop /bin/rm hook
    # covers the readiness file on the hard-exit path as well.
    stop = threading.Event()
    run_returned = threading.Event()
    grace_s = float(os.environ.get("CC_SHUTDOWN_GRACE_S", "20"))
    # Runtime-health watchdog (ccmanager/watchdog.py): probes the runtime
    # BETWEEN reconciles and demotes/restores cc.ready.state on sustained
    # degradation. Stands down while a reconcile is in flight.
    remediation = manager.remediation
    start_watchdog(
        api,
        backend,
        args.node_name,
        stop,
        is_busy=lambda: manager.reconciling,
        emit_event=manager._emit_node_event,
        metrics=manager.metrics,
        # Probe verdicts drive the quarantine probation window; the demote
        # edge fences this host's slice barrier so peers fail fast.
        on_probe=(remediation.note_probe if remediation is not None else None),
        on_condemn=(remediation.condemn if remediation is not None else None),
        # A demote (condemn) while the apiserver is dark is journaled as a
        # pending patch and flushed on reconnect; a write that LANDS while
        # stale deferred patches are queued supersedes them.
        defer_patch=manager.defer_patch_if_offline,
        note_patched=manager.note_direct_patch,
    )

    def _force_exit_when_idle():
        deadline = time.monotonic() + grace_s
        # Give a non-blocked loop the chance to exit cleanly; if run() has
        # already returned, the main thread owns shutdown — hard-exiting
        # here would race it and turn a clean stop into exit code 143.
        if run_returned.wait(2.0):
            return
        while manager.reconciling and time.monotonic() < deadline:
            if run_returned.wait(1.0):
                return
        # One final grace wait (not a bare is_set): if the reconcile just
        # finished, the main thread is milliseconds from returning — give
        # it that window so a clean stop doesn't report 143.
        if run_returned.wait(1.0):
            return
        manager.remove_readiness_file()
        os._exit(143)

    def _on_stop(*_):
        if stop.is_set():
            os._exit(143)  # second signal: immediate
        stop.set()
        t = threading.Thread(target=_force_exit_when_idle, daemon=True)
        t.start()

    try:
        signal.signal(signal.SIGTERM, _on_stop)
        signal.signal(signal.SIGINT, _on_stop)
    except ValueError:
        pass  # not the main thread (tests) — stop stays externally unset
    try:
        manager.run(stop)
    except Exception as e:  # noqa: BLE001 - crash-as-retry (reference main.py:757-759)
        log.error("manager terminated: %s", e, exc_info=True)
        return 1
    finally:
        run_returned.set()
    return 0


if __name__ == "__main__":
    sys.exit(main())
