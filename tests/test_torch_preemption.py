"""The preemption fast drain and hand-off on the port: every case of
``tests/test_preemption.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``.
``test_slice_peer_fences_fast_instead_of_burning_barrier_deadline``
preempts one host of a two-host slice, each host a fake node of that slice.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_preemption")
