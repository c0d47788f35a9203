"""The remediation ladder and its ``ctl`` surfaces on the port: every case
of ``tests/test_remediation.py`` run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``. The three
cases that fence the slice barrier's other hosts
(``test_quarantine_fences_a_multi_host_slice``,
``test_watchdog_condemn_fences_without_quarantining``,
``test_containment_metrics_render``) build a host of a two-host slice as a
fake node of that slice.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_remediation")
