"""The reconciler's state machine on the port: the cases of
``tests/test_manager.py`` run through ``test_torch_fleet_sides.port_suite``,
over the port's ``FakeKube`` and its fake H100 node where the JAX suite
builds ``FakeTpuBackend``. ``test_idempotent_apply_clears_stale_staged_marker``
builds a host of a two-host slice as a fake node of that slice.

Left out: ``test_devtools_mode_applies`` reads the JAX fake's
``runtime_env``, the TPU runtime's env file (``TPU_CC_MODE``,
``TPU_MIN_LOG_LEVEL``); an H100 node has no such file: its devtools mode
is the GPUs' own CC mode, which ``tests/test_torch_gpudev.py`` holds.
"""

from test_torch_fleet_sides import fake_kube, fake_tpu, port_suite  # noqa: F401

port_suite(globals(), "test_manager", drop=("test_devtools_mode_applies",))
