"""Runtime-health watchdog: the monitor between reconciles.

The reconcile loop only probes runtime health during ``wait_ready`` — i.e.
while a mode change is in flight. A runtime that wedges BETWEEN reconciles
(crashed tpu-runtime unit, vanished device nodes, dead health port) kept
its last reported ``cc.ready.state`` indefinitely, and the probe layer
silently degraded to the weakest signal available (bare device-node
existence — VERDICT r5 weak #6) with nothing exporting which tier was
actually in use.

This watchdog closes both gaps:

- every ``interval_s`` (while no reconcile is in flight) it runs the
  backend's tiered probe (:meth:`NodeBackend.probe_runtime_health`) and
  exports the ACTIVE TIER and verdict as metrics
  (``tpu_cc_health_probe_tier{tier}``, ``tpu_cc_runtime_healthy``) — a
  fleet running on device-node-existence probes is now a dashboard fact;
- ``demote_after`` consecutive unhealthy probes flip
  ``cloud.google.com/tpu-cc.ready.state`` to ``"false"`` (the mode.state
  label is untouched — the mode is still committed; the node is just not
  currently serving it) with a ``CCRuntimeUnhealthy`` node event;
- ``restore_after`` consecutive healthy probes restore the ready value
  derived from the CURRENT mode.state label with a ``CCRuntimeRecovered``
  event — recovery is automatic, no label edit needed.

Hysteresis on both edges keeps a flapping probe from thrashing the label.
All clocks/sleeps are injectable; :meth:`tick` is the unit tests' and the
chaos soak's entry point, :meth:`run` the CLI's.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from tpu_cc_manager_torch.kubeclient.api import (
    KubeApi,
    KubeApiError,
    caller_retry_attempts,
    classify_kube_error,
    node_labels,
)
from tpu_cc_manager_torch.labels import (
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    ready_state_for,
)
from tpu_cc_manager_torch.ccmanager.node import HealthProbe, NodeBackend, GpuError
from tpu_cc_manager_torch.utils import metrics as metrics_mod
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

DEFAULT_INTERVAL_S = 30.0
DEFAULT_DEMOTE_AFTER = 3
DEFAULT_RESTORE_AFTER = 2


class RuntimeHealthWatchdog:
    def __init__(
        self,
        api: KubeApi,
        backend: NodeBackend,
        node_name: str,
        interval_s: float = DEFAULT_INTERVAL_S,
        demote_after: int = DEFAULT_DEMOTE_AFTER,
        restore_after: int = DEFAULT_RESTORE_AFTER,
        is_busy: Callable[[], bool] | None = None,
        emit_event: Callable[[str, str, str], None] | None = None,
        metrics: metrics_mod.MetricsRegistry | None = None,
        on_probe: Callable[[bool], None] | None = None,
        on_condemn: Callable[[], None] | None = None,
        defer_patch: Callable[[dict, BaseException], bool] | None = None,
        note_patched: Callable[[dict], None] | None = None,
    ) -> None:
        self.api = api
        self.backend = backend
        self.node_name = node_name
        self.interval_s = interval_s
        self.demote_after = max(1, demote_after)
        self.restore_after = max(1, restore_after)
        # "Busy" = a reconcile is in flight: the reconcile owns the ready
        # label then (wait_ready/verify run their own probes), so the
        # watchdog stands down instead of racing it.
        self.is_busy = is_busy or (lambda: False)
        self.emit_event = emit_event or (lambda *_: None)
        # Failure-containment hooks (ccmanager/remediation.py): every probe
        # verdict feeds the quarantine probation window, and the demote
        # edge condemns the host — aborting any in-flight slice barrier
        # with a fencing generation so ICI peers fail fast instead of
        # waiting out the barrier deadline on a host that just went
        # unhealthy.
        self.on_probe = on_probe or (lambda healthy: None)
        self.on_condemn = on_condemn or (lambda: None)
        # Disconnected-mode hook (manager.defer_patch_if_offline): a ready-
        # state write refused by a TOTAL apiserver outage is journaled as a
        # pending patch instead of silently dropped — a condemn that
        # happens while offline still reaches the labels, in journal
        # order, when connectivity returns.
        self.defer_patch = defer_patch
        # Superseding hook (manager.note_direct_patch): a ready-state
        # write that LANDS while stale deferred patches are still queued
        # must outrank them in journal order, or the eventual flush would
        # clobber it back.
        self.note_patched = note_patched
        self.metrics = metrics if metrics is not None else metrics_mod.REGISTRY
        self.degraded = False
        self._consecutive_unhealthy = 0
        self._consecutive_healthy = 0
        self._warned_weak_tier = False
        # Label writes ride the shared policy; one attempt when the client
        # retries internally (RestKube) so exactly one ladder runs per
        # logical call — fakes and chaos wrappers get the caller-side
        # ladder instead.
        self.retry_policy = retry_mod.RetryPolicy(
            max_attempts=caller_retry_attempts(api),
            base_delay_s=0.5,
            max_delay_s=5.0,
        )

    # ------------------------------------------------------------------

    def tick(self) -> HealthProbe | None:
        """One probe cycle; returns the probe (None when skipped busy)."""
        if self.is_busy():
            return None
        try:
            probe = self.backend.probe_runtime_health()
        except GpuError as e:
            # A probe that cannot even run is an unhealthy verdict from no
            # tier at all — the weakest possible state.
            probe = HealthProbe("none", False, f"probe raised: {e}")
        self.metrics.set_health_tier(probe.tier, probe.strength, probe.healthy)
        try:
            self.on_probe(probe.healthy)
        except Exception as e:  # noqa: BLE001 - probation must not stop probing
            log.warning("watchdog on_probe hook failed: %s", e)
        if probe.tier == "device-node" and not self._warned_weak_tier:
            # The silent-weakest-probe fallback, made loud exactly once.
            log.warning(
                "runtime health is probed by device-node existence only — "
                "the weakest tier (nodes persist across a wedged runtime); "
                "configure CC_RUNTIME_HEALTH_PORT or a probe command"
            )
            self._warned_weak_tier = True
        if probe.healthy:
            self._consecutive_unhealthy = 0
            self._consecutive_healthy += 1
            if self.degraded and self._consecutive_healthy >= self.restore_after:
                self._restore(probe)
        else:
            self._consecutive_healthy = 0
            self._consecutive_unhealthy += 1
            log.warning(
                "runtime health probe unhealthy (%d/%d, tier=%s): %s",
                self._consecutive_unhealthy, self.demote_after,
                probe.tier, probe.detail,
            )
            if self._consecutive_unhealthy >= self.demote_after:
                # Runs on EVERY sustained-unhealthy tick, not only the
                # closed->degraded transition: a reconcile may have
                # rewritten ready=true while the runtime is still wedged,
                # and an in-memory latch must not stop the re-demote. The
                # patch is idempotent; the event/metric fire only on the
                # transition.
                self._demote(probe, first=not self.degraded)
        return probe

    def _patch_ready(self, value: str) -> None:
        try:
            self.retry_policy.call(
                lambda: self.api.patch_node_labels(
                    self.node_name, {CC_READY_STATE_LABEL: value}
                ),
                op="watchdog.patch_ready",
                classify=classify_kube_error,
            )
            if self.note_patched is not None:
                self.note_patched({CC_READY_STATE_LABEL: value})
        except KubeApiError as e:
            patch = {CC_READY_STATE_LABEL: value}
            if self.defer_patch is not None and self.defer_patch(patch, e):
                log.warning(
                    "watchdog: apiserver offline; %s=%s deferred to the "
                    "intent journal", CC_READY_STATE_LABEL, value,
                )
                return
            raise

    def _demote(self, probe: HealthProbe, first: bool = True) -> None:
        if self.is_busy():
            # A reconcile started while this tick's (slow) probe ran; it
            # owns the ready label now and may just have restored the
            # runtime — a demote computed from pre-reconcile probes must
            # not overwrite it. The next tick re-evaluates fresh.
            log.info("watchdog: reconcile started mid-probe; demote skipped")
            return
        try:
            self._patch_ready("false")
        except KubeApiError as e:
            log.error("watchdog could not demote ready state: %s", e)
            return  # stay un-degraded; next tick retries the whole demote
        self.degraded = True
        if not first:
            log.debug("watchdog: not-ready state re-asserted")
            return
        try:
            # Condemn on the demote EDGE only: peers mid-barrier stop
            # waiting on this host now, not once per re-asserting tick.
            self.on_condemn()
        except Exception as e:  # noqa: BLE001 - fencing peers is best-effort
            log.warning("watchdog on_condemn hook failed: %s", e)
        self.metrics.record_failure("runtime-unhealthy")
        log.error(
            "sustained runtime degradation (%d consecutive unhealthy "
            "probes, tier=%s): %s — %s flipped to 'false'",
            self._consecutive_unhealthy, probe.tier, probe.detail,
            CC_READY_STATE_LABEL,
        )
        self.emit_event(
            "Warning", "CCRuntimeUnhealthy",
            f"TPU runtime unhealthy for {self._consecutive_unhealthy} "
            f"consecutive probes (tier={probe.tier}): {probe.detail}",
        )

    def _restore(self, probe: HealthProbe) -> None:
        if self.is_busy():  # same mid-probe race as _demote
            log.info("watchdog: reconcile started mid-probe; restore deferred")
            return
        try:
            state = node_labels(
                self.retry_policy.call(
                    lambda: self.api.get_node(self.node_name),
                    op="watchdog.get_node",
                    classify=classify_kube_error,
                )
            ).get(CC_MODE_STATE_LABEL, "")
            self._patch_ready(ready_state_for(state))
        except KubeApiError as e:
            log.error("watchdog could not restore ready state: %s", e)
            return  # still degraded; next healthy tick retries
        self.degraded = False
        log.info(
            "runtime recovered (%d consecutive healthy probes, tier=%s); "
            "%s restored for state=%s",
            self._consecutive_healthy, probe.tier,
            CC_READY_STATE_LABEL, state or "<unset>",
        )
        self.emit_event(
            "Normal", "CCRuntimeRecovered",
            f"TPU runtime healthy again (tier={probe.tier}); "
            "ready state restored",
        )

    # ------------------------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        """Probe every ``interval_s`` until ``stop`` is set."""
        log.info(
            "runtime-health watchdog started (interval=%.0fs, demote_after=%d, "
            "restore_after=%d)",
            self.interval_s, self.demote_after, self.restore_after,
        )
        while not stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - the watchdog must survive
                # anything (it is the component that reports wedges, so it
                # must not wedge): log and keep ticking.
                log.error("watchdog tick failed: %s", e, exc_info=True)
            stop.wait(self.interval_s)

    def start(self, stop: threading.Event) -> threading.Thread:
        t = threading.Thread(
            target=self.run, args=(stop,), name="runtime-health-watchdog",
            daemon=True,
        )
        t.start()
        return t


def start_from_env(
    api: KubeApi,
    backend: NodeBackend,
    node_name: str,
    stop: threading.Event,
    is_busy: Callable[[], bool] | None = None,
    emit_event: Callable[[str, str, str], None] | None = None,
    metrics: metrics_mod.MetricsRegistry | None = None,
    on_probe: Callable[[bool], None] | None = None,
    on_condemn: Callable[[], None] | None = None,
    defer_patch: Callable[[dict, BaseException], bool] | None = None,
    note_patched: Callable[[dict], None] | None = None,
) -> RuntimeHealthWatchdog | None:
    """CLI wiring: CC_WATCHDOG_INTERVAL_S (0 disables),
    CC_WATCHDOG_DEMOTE_AFTER, CC_WATCHDOG_RESTORE_AFTER."""
    import os

    interval = float(
        os.environ.get("CC_WATCHDOG_INTERVAL_S", str(DEFAULT_INTERVAL_S))
    )
    if interval <= 0:
        log.info("runtime-health watchdog disabled (CC_WATCHDOG_INTERVAL_S<=0)")
        return None
    watchdog = RuntimeHealthWatchdog(
        api,
        backend,
        node_name,
        interval_s=interval,
        demote_after=int(
            os.environ.get("CC_WATCHDOG_DEMOTE_AFTER", str(DEFAULT_DEMOTE_AFTER))
        ),
        restore_after=int(
            os.environ.get(
                "CC_WATCHDOG_RESTORE_AFTER", str(DEFAULT_RESTORE_AFTER)
            )
        ),
        is_busy=is_busy,
        emit_event=emit_event,
        metrics=metrics,
        on_probe=on_probe,
        on_condemn=on_condemn,
        defer_patch=defer_patch,
        note_patched=note_patched,
    )
    watchdog.start(stop)
    return watchdog
