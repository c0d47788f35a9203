"""The in-memory apiserver fake (``kubeclient/fake.py``) on the port: the
cases of ``tests/test_fake_kube.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube``. Every
case runs.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_fake_kube")
