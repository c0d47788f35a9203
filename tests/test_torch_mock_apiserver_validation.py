"""The port's REST client against the validating mock apiserver
(``hack/mock_apiserver.py``) on the port: the cases of
``tests/test_mock_apiserver_validation.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``. Every case
runs.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_mock_apiserver_validation")
