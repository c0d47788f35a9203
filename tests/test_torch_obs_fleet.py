"""The fleet gateway and capacity ledger (``obs/fleet.py``) on the port: the
cases of ``tests/test_obs_fleet.py`` run through
``test_torch_fleet_sides.port_suite``, the merged exposition held to the
port's ``lint/expo.py``."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_obs_fleet")
