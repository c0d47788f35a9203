"""Peer-relative fail-slow vetting (``obs/failslow.py``) and its containment
surfaces on the port: the cases of ``tests/test_failslow.py`` run through
``test_torch_fleet_sides.port_suite``; the brownout under live traffic is
armed on the port harness's fake H100 nodes, and the fleet gateway tells a
slow node from a dead one."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_failslow")
