"""The operator CLI (``ctl.py``) on the port: the cases of
``tests/test_ctl.py`` run through ``test_torch_fleet_sides.port_suite``,
with the port's fake H100 node where the JAX suite builds
``FakeTpuBackend``."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_ctl")
