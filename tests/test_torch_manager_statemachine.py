"""The reconcile loop as a hypothesis state machine on the port: the cases
of ``tests/test_manager_statemachine.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``. Every case
runs.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_manager_statemachine")
