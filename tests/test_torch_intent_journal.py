"""The node-local intent journal, and the manager's disconnected mode and
boot recovery on the port: the cases of ``tests/test_intent_journal.py``,
run through ``test_torch_fleet_sides.port_suite``, over the port's
``FakeKube`` and its fake H100 node where the JAX suite builds
``FakeTpuBackend``. Every case runs.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_intent_journal")
