"""Zero-bounce flips, pre-staged-spare half, on the port: the cases of
``tests/test_prestage_spares.py`` run through
``test_torch_fleet_sides.port_suite``, ``ctl status``'s pre-staged note
included."""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_prestage_spares")
