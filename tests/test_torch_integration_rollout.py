"""Full-stack integration on the port: the rolling orchestrator driving REAL
per-node agents (``CCManager.watch_and_apply`` in threads), the case of
``tests/test_integration_rollout.py`` run through
``test_torch_fleet_sides.port_suite``.

The pool is the JAX case's: two 2-host slices, each host a fake HGX node
of its slice, whose hosts cross the slice commit barrier
(``ccmanager/slicecoord.py``). The JAX case's invariants hold as they are:
every host of a slice staged before any of its resets, and with
``max_unavailable=1`` ``slice-a`` finished all its hardware ops before
``slice-b`` started any.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_integration_rollout")
