"""The workload drain handshake (``drain/handshake.py``) on the port: the
cases of ``tests/test_drain_handshake.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube`` and its
fake H100 node where the JAX suite builds ``FakeTpuBackend``.

Left out: ``test_drain_blocks_until_job_checkpoints_then_resumes_exactly``
and its helpers ``_train_step`` and ``_make_state``, which train a JAX
``(w, step)`` pytree under ``jax.jit`` and save it through orbax, JAX
itself. ``tests/test_torch_drain_job.py`` runs that case's protocol on the
port's own job: the Llama ``TrainState`` through the port's
``TrainCheckpointer``.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_drain_handshake", drop=(
    "_train_step",
    "_make_state",
    "test_drain_blocks_until_job_checkpoints_then_resumes_exactly",
    "TrainCheckpointer",
))
