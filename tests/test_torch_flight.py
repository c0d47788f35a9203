"""Rollout flight recorder (``obs/flight.py``) and cross-process trace
stitching on the port: the cases of ``tests/test_flight.py`` run through
``test_torch_fleet_sides.port_suite``, ``ctl rollout-timeline`` and the
``ctl status`` TRACE column included.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_flight")
