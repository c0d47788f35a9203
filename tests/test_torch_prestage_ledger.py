"""Continuous pre-staging under the capacity ledger on the port: the cases
of ``tests/test_prestage_ledger.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube``. Every
case runs.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_prestage_ledger")
