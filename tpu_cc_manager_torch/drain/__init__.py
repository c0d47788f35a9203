"""Drain / re-admit orchestration over the label pause protocol.

Reference analogue: gpu_operator_eviction.py (SURVEY.md §2 #8, #9). Split in
three: :mod:`pause` is the pure label algebra (unit-testable with no cluster),
:mod:`evict` performs the drain/re-admit against a KubeApi, :mod:`state`
reports actual state back through node labels.
"""

from tpu_cc_manager_torch.drain.evict import (
    evict_components,
    fetch_component_labels,
    readmit_components,
)
from tpu_cc_manager_torch.drain.pause import pause_value, unpause_value
from tpu_cc_manager_torch.drain.state import set_cc_state_label

__all__ = [
    "evict_components",
    "fetch_component_labels",
    "readmit_components",
    "pause_value",
    "unpause_value",
    "set_cc_state_label",
]
