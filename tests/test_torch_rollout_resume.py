"""Crash-safe rollouts (lease fencing, checkpointed records, resume) on the
port: the cases of ``tests/test_rollout_resume.py`` run through
``test_torch_fleet_sides.port_suite``, the kill at every crash point (each
kill a regional shard of a federation) and the cases that drive ``ctl``
included.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_rollout_resume")
