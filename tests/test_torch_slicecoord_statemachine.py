"""The slice commit barrier as a hypothesis state machine on the port: the
cases of ``tests/test_slicecoord_statemachine.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube``. Every
case runs.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_slicecoord_statemachine")
