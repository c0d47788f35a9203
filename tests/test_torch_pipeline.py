"""Pipelined transitions on the port (stage with drain, attestation prep
with the boot wait, re-admission with the smoke, the digest fast path and
crash points): the cases of ``tests/test_pipeline.py`` run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``.

Left out: ``test_kill_mid_parallel_per_chip_reset``, which kills one
worker of the JAX fake's per-chip reset by replacing its private
``_maybe_fail`` and matching its fault point ``reset.chip<i>``. The port's
fake names that point ``reset.dev<i>``;
``tests/test_torch_gpudev.py::test_per_device_failure_keeps_unreset_devices_staged``
holds the port's per-device cut.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_pipeline", drop=("test_kill_mid_parallel_per_chip_reset",))
