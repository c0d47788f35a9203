"""The slice commit barrier (``ccmanager/slicecoord.py``) on the port: the
cases of ``tests/test_slicecoord.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``.

Left out, each because it drives a multi-host slice (two or more hosts
staging, draining and meeting at the barrier); an H100 node is a one-host
slice of its GPUs (``ccmanager/node.py``), so the port's fake node refuses
``num_hosts > 1``:

- ``test_no_reset_before_all_hosts_staged_and_drained``;
- ``test_multi_host_barrier_applies_to_any_mode``;
- ``test_barrier_timeout_fails_soft``;
- ``test_crash_mid_barrier_peer_recovers``;
- ``test_leader_crash_after_commit_recovers``;
- ``test_stuck_drain_on_one_host_fails_the_slice_soft``;
- ``test_leader_leaves_commit_marker_when_peer_never_finishes``.

``test_single_host_topology_skips_barrier`` and
``test_barrier_tolerates_transient_peer_listing_failures`` run.
"""

from test_torch_fleet_sides import fake_kube, fake_tpu, port_suite  # noqa: F401

port_suite(globals(), "test_slicecoord", drop=(
    "test_no_reset_before_all_hosts_staged_and_drained",
    "test_multi_host_barrier_applies_to_any_mode",
    "test_barrier_timeout_fails_soft",
    "test_crash_mid_barrier_peer_recovers",
    "test_leader_crash_after_commit_recovers",
    "test_stuck_drain_on_one_host_fails_the_slice_soft",
    "test_leader_leaves_commit_marker_when_peer_never_finishes",
))
