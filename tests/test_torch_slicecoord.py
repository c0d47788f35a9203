"""The slice commit barrier (``ccmanager/slicecoord.py``) on the port: every
case of ``tests/test_slicecoord.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``.

The multi-host cases build each host of a two-host slice as a fake node of
its own (``FakeGpuBackend(num_hosts=2, host_index=i, slice_id=...)``), as
the JAX suite builds two TPU hosts: the barrier's ordering, its timeout,
crash recovery on either side of the commit marker and a stuck drain on
one host all run on the port. The suite's ``SeqBackend`` subclasses the
port's fake node, so its stage and reset notes wrap the node's calls.
``test_crash_mid_barrier_peer_recovers`` waits out the barrier's deadline
(about 60 s), as it does in the JAX suite.
"""

from test_torch_fleet_sides import fake_kube, fake_tpu, port_suite  # noqa: F401

port_suite(globals(), "test_slicecoord")
