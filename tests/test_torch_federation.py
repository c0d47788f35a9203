"""Federated region-sharded rollouts (``ccmanager/federation.py``) on the
port: the cases of ``tests/test_federation.py`` run through
``test_torch_fleet_sides.port_suite``."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_federation")
