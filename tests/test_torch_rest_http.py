"""The stdlib REST client over HTTP (``kubeclient/rest.py``) on the port:
the cases of ``tests/test_rest_http.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube``. Every
case runs.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_rest_http")
