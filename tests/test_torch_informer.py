"""The informer cache (``ccmanager/informer.py``) on the port: the cases of
``tests/test_informer.py``, run through
``test_torch_fleet_sides.port_suite``, over the port's ``FakeKube``.

Left out: ``test_informer_backed_sharded_rollout_converges_under_chaos``.
Its JAX original fails under CPU load, whatever loads the CPU: the seeded
plan's blackout can land on a sharded wave's desired-label patch, which the
rolling orchestrator does not retry, and thread scheduling decides which
call that is (``ROADMAP.md``, "Reference caveats"). The port's
``ccmanager/rolling.py`` is a copy with the same call, so it would fail the
same way.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_informer", drop=(
    "test_informer_backed_sharded_rollout_converges_under_chaos",
))
