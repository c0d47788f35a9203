"""Serving under the flip (``serve/``) on the port: the cases of
``tests/test_serve.py`` run through ``test_torch_fleet_sides.port_suite``,
whose ``ServeHarness`` builds its pool of fake H100 nodes. Left out: the
slow-marked ``test_rolling_flip_long_soak``, which tier-1 does not run."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_serve", drop=("test_rolling_flip_long_soak",))
