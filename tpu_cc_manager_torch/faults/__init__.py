"""Deterministic chaos fault injection for the control plane.

The north star demands a control plane that "handles as many scenarios as
you can imagine" — which only counts if the scenarios are *injectable* and
recovery is *provable*. This package supplies the apiserver half of that
(the device half already exists: ``tpudev/fake.py``'s ``fail_next`` hooks,
which :class:`~tpu_cc_manager_torch.faults.plan.FaultPlan` can drive from the
same seed):

- :class:`~tpu_cc_manager_torch.faults.plan.FaultPlan` — a seeded, reproducible
  schedule of faults (``CC_CHAOS_SEED``): same seed + same call sequence
  → byte-identical fault schedule, so a chaos failure is replayable;
- :class:`~tpu_cc_manager_torch.faults.kube.FaultyKubeClient` — a KubeApi
  wrapper injecting 429+Retry-After, 5xx, connection resets, slow
  responses, watch hangups, and stale-rv 410s in front of any real or
  fake client.

Consumed by tests/test_chaos.py (fast deterministic subset, ``chaos``
pytest marker) and hack/chaos_soak.sh (the longer seeded soak).
"""

from tpu_cc_manager_torch.faults.kube import FaultyKubeClient
from tpu_cc_manager_torch.faults.plan import (
    CHAOS_SEED_ENV,
    Fault,
    FaultPlan,
    OrchestratorKilled,
)

__all__ = [
    "CHAOS_SEED_ENV",
    "Fault",
    "FaultPlan",
    "FaultyKubeClient",
    "OrchestratorKilled",
]
