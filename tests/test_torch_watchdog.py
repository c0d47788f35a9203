"""The runtime-health watchdog (tier export, demote and restore hysteresis,
busy standdown) on the port: the cases of ``tests/test_watchdog.py``, run
through ``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube``
and its fake H100 node where the JAX suite builds ``FakeTpuBackend``.

Left out, each because it needs the TPU VM's own device layer
(``tpu_cc_manager/tpudev/tpuvm.py``'s probe tiers: its health port, probe
command, systemd unit and ``/dev/accel*`` glob), which an H100 node does
not have:

- ``TestTpuVmProbeTiers`` (its four cases);
- ``test_unanswered_health_port_falls_through_not_fail_closed``.

The port's own tiers (NVML answering for every GPU, else ``/dev/nvidia<N>``,
``gpudev/h100.py::H100Backend.probe_runtime_health``) are held by
``tests/test_torch_gpudev_real.py::test_health_probe_tiers``.
"""

from test_torch_fleet_sides import fake_kube, fake_tpu, port_suite  # noqa: F401

port_suite(globals(), "test_watchdog", drop=(
    "TestTpuVmProbeTiers",
    "test_unanswered_health_port_falls_through_not_fail_closed",
))
