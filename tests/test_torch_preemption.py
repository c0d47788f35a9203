"""The preemption fast drain and hand-off on the port: the cases of
``tests/test_preemption.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``.

Left out: ``test_slice_peer_fences_fast_instead_of_burning_barrier_deadline``,
which preempts one host of a two-host slice; an H100 node is a one-host
slice of its GPUs (``ccmanager/node.py``).
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_preemption", drop=(
    "test_slice_peer_fences_fast_instead_of_burning_barrier_deadline",
))
