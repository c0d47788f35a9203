"""Full-stack integration on the port: the rolling orchestrator driving REAL
per-node agents (``CCManager.watch_and_apply`` in threads), the case of
``tests/test_integration_rollout.py`` run through
``test_torch_fleet_sides.port_suite``.

The JAX pool is two 2-host TPU slices, whose hosts cross the slice commit
barrier (``ccmanager/slicecoord.py``). An H100 node is a one-host slice of
its GPUs (``ccmanager/node.py``), so the port's ``POOL`` is one HGX node per
slice, named for it. The JAX case's invariants hold per slice as they are:
every host staged before any reset, and with ``max_unavailable=1``
``slice-a`` finished all its hardware ops before ``slice-b`` started any.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_integration_rollout")

POOL = {"slice-a": ("node-a0",), "slice-b": ("node-b0",)}
