"""The smoke warmup on the port (the compile→dispatch gate, released only
after the node is ready and attested): the cases of ``tests/test_warmup.py``
run through ``test_torch_fleet_sides.port_suite``, over the port's
``FakeKube`` and its fake H100 node where the JAX suite builds
``FakeTpuBackend``. The orphan case's child imports the gate from the
port's runner (``strings``)."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_warmup", strings={
    "from tpu_cc_manager.smoke.runner import": "from tpu_cc_manager_torch.smoke.runner import"})
