"""The Prometheus exposition lint (``lint/expo.py``) on the port: the cases
of ``tests/test_metrics_lint.py`` run through
``test_torch_fleet_sides.port_suite``, with the suite's
``check_metrics_lint`` (the JAX shim in ``hack/``) bound to the port's
``lint/expo.py``."""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_metrics_lint",
           modules={"check_metrics_lint": "tpu_cc_manager_torch.lint.expo"})
