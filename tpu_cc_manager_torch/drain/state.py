"""Actual-state reporting through node labels.

Reference: set_cc_state_label (gpu_operator_eviction.py:262-295) — writes
``cc.mode.state`` and the derived ``cc.ready.state`` in one call. Here both
labels land in a single merge-patch (the reference does a full-object RMW
patch per label write; SURVEY.md §8.3).
"""

from __future__ import annotations

import logging

from tpu_cc_manager_torch.kubeclient.api import KubeApi
from tpu_cc_manager_torch.labels import (
    CC_FAILED_REASON_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    STATE_FAILED,
    label_safe,
    ready_state_for,
)

log = logging.getLogger(__name__)


def state_label_patch(state: str, reason: str | None = None) -> dict:
    """The merge-patch reporting an actual state (mode.state, the derived
    ready.state, and the failed reason — cleared by any non-failed state).
    Exposed separately from :func:`set_cc_state_label` so the manager's
    disconnected mode can journal exactly this patch for a deferred flush
    when the apiserver is unreachable (ccmanager/intent_journal.py)."""
    return {
        CC_MODE_STATE_LABEL: state,
        CC_READY_STATE_LABEL: ready_state_for(state),
        CC_FAILED_REASON_LABEL: (
            label_safe(reason) if state == STATE_FAILED and reason else None
        ),
    }


def set_cc_state_label(
    api: KubeApi, node_name: str, state: str, reason: str | None = None
) -> None:
    """Report actual state; on ``failed`` also publish a machine-readable
    reason label, cleared again by any non-failed state. One merge-patch."""
    patch = state_label_patch(state, reason)
    log.info(
        "reporting state on %s: %s=%s %s=%s%s",
        node_name, CC_MODE_STATE_LABEL, state,
        CC_READY_STATE_LABEL, patch[CC_READY_STATE_LABEL],
        f" reason={reason}" if reason else "",
    )
    api.patch_node_labels(node_name, patch)
