"""Pause/unpause label algebra — pure functions, no I/O.

Ported exactly from the reference's protocol (gpu_operator_eviction.py:43-95,
SURVEY.md §5 "label state machine"), because the external controller that
reacts to these labels (the TPU operator, analogue of the GPU operator)
defines them as its API:

    'true'      -> PAUSED_VALUE                  (pause)
    custom 'v'  -> 'v' + PAUSED_SUFFIX           (pause, preserving the value)
    'false'/''  -> unchanged                     (component user-disabled)
    paused      -> unchanged                     (idempotent)

and unpausing inverts exactly.
"""

from __future__ import annotations

from tpu_cc_manager_torch.labels import PAUSED_SUFFIX, PAUSED_VALUE

# k8s label values are capped at 63 characters; appending the 30-char
# suffix to a custom value longer than this would make the whole drain
# merge-patch 422 on a real apiserver — blocking the CC transition over
# one label.
MAX_LABEL_LEN = 63
_MAX_CUSTOM = MAX_LABEL_LEN - len(PAUSED_SUFFIX)


def is_paused(value: str | None) -> bool:
    return value is not None and (
        value == PAUSED_VALUE or value.endswith(PAUSED_SUFFIX)
    )


def pause_value(value: str | None) -> str | None:
    """New label value when pausing, or None if the label must not change.

    Custom values too long to carry the suffix within the 63-char label
    limit are truncated to fit: the suffix (the external operator's API —
    it is what triggers the pod deletion) is never compromised, the drain
    proceeds, and the untruncated original is restored on re-admit from
    the remembered pre-drain labels (drain/evict.py). Only a crash
    between pause and re-admit restores the truncated form. If the cut
    point exposes an embedded copy of the suffix, it is stripped too —
    the paused value must carry EXACTLY one suffix, or unpausing would
    peel a single layer and leave a value that still reads as paused."""
    if value is None or value in ("", "false"):
        return None
    if is_paused(value):
        return None
    if value == "true":
        return PAUSED_VALUE
    prefix = value[:_MAX_CUSTOM]
    while prefix.endswith(PAUSED_SUFFIX):
        prefix = prefix[: -len(PAUSED_SUFFIX)]
    return prefix + PAUSED_SUFFIX


def unpause_value(value: str | None) -> str | None:
    """New label value when unpausing, or None if the label must not change."""
    if value is None or not is_paused(value):
        return None
    if value == PAUSED_VALUE:
        return "true"
    return value[: -len(PAUSED_SUFFIX)]
