"""The remediation ladder and its ``ctl`` surfaces on the port: the cases
of ``tests/test_remediation.py`` run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``.

Left out: the three cases that build a host of a two-host slice
(``FakeTpuBackend(num_hosts=2, ...)``) to fence the slice barrier's other
hosts. An H100 node is a one-host slice of its GPUs
(``ccmanager/node.py``), so the port's fake node has no second host to
fence; the fencing itself (``slicecoord.fence_slice``) runs in the suite's
other cases.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_remediation", drop=(
    "test_quarantine_fences_a_multi_host_slice",
    "test_watchdog_condemn_fences_without_quarantining",
    "test_containment_metrics_render",
))
