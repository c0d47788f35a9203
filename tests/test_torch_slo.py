"""SLO window math (``obs/slo.py``) on the port: the cases of
``tests/test_slo.py`` run through ``test_torch_fleet_sides.port_suite``, with
the JAX suite's seeds and bounds."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_slo", drop=())
