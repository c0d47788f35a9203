"""Chaos fault injection (``faults/``) on the port: the cases of
``tests/test_chaos.py`` run through ``test_torch_fleet_sides.port_suite``,
over ``NodeBackend(FakeGpuBackend)`` where the JAX suite builds
``FakeTpuBackend``."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_chaos", drop=())
