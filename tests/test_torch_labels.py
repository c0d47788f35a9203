"""Mode canonicalisation and ready-state derivation (``labels.py``) on the
port: the cases of ``tests/test_labels.py``, run through
``test_torch_fleet_sides.port_suite``. Every case runs.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_labels")
