"""Emulated operator controller for fake pools.

One drainable node = component labels + one pod per drain component +
a patch reactor that deletes a component's pods (after an optional
grace delay — pods have termination grace periods on a real cluster)
once its pause label lands. This is the external behavior the drain
protocol relies on (SURVEY.md §5), shared by every fake-pool scenario —
bench.py's measurement kube and the serving harness
(serve/harness.py) — so the emulation cannot diverge between the
artifacts they produce.
"""

from __future__ import annotations

import threading

from tpu_cc_manager_torch.drain.pause import is_paused
from tpu_cc_manager_torch.kubeclient.api import node_labels
from tpu_cc_manager_torch.labels import DRAIN_COMPONENT_LABELS


def add_drainable_node(
    kube,
    node_name: str,
    namespace: str,
    pod_delete_delay_s: float = 0.0,
    extra_labels: dict[str, str] | None = None,
) -> None:
    labels = dict(extra_labels or {})
    labels.update({key: "true" for key in DRAIN_COMPONENT_LABELS})
    kube.add_node(node_name, labels)
    for key, app in DRAIN_COMPONENT_LABELS.items():
        kube.add_pod(namespace, f"{app}-{node_name}", node_name,
                     labels={"app": app})

    def reactor(patched_name, patched):
        if patched_name != node_name:
            return
        for key, app in DRAIN_COMPONENT_LABELS.items():
            if is_paused(node_labels(patched).get(key)):
                if pod_delete_delay_s > 0:
                    timer = threading.Timer(
                        pod_delete_delay_s,
                        kube.delete_pod, (namespace, f"{app}-{node_name}"),
                    )
                    # Daemonize so a pending timer can't outlive its
                    # scenario (delaying exit or firing into the fake
                    # after the measurement window).
                    timer.daemon = True
                    timer.start()
                else:
                    kube.delete_pod(namespace, f"{app}-{node_name}")

    kube.add_patch_reactor(reactor)
