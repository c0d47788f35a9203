"""The watch loop (initial apply, change detection, 410 resync, error cap)
on the port: the cases of ``tests/test_watch.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``. Every case
runs.
"""

from test_torch_fleet_sides import fake_tpu, port_suite  # noqa: F401

port_suite(globals(), "test_watch")
