"""Crash-safe rollouts (lease fencing, checkpointed records, resume) on the
port: the cases of ``tests/test_rollout_resume.py`` run through
``test_torch_fleet_sides.port_suite``.

Left out until ``ccmanager/federation.py`` is ported: the kill at every
crash point (``_run_crash_resume`` runs each kill as a regional shard of a
federation, with ``OneClearVetter`` and ``ParentBlackoutKube``). Left out
until ``ctl.py`` is ported: the cases that drive its commands.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_rollout_resume", drop=(
    "federation_mod",
    "OneClearVetter",
    "ParentBlackoutKube",
    "_run_crash_resume",
    "test_successor_converges_after_kill_at_every_crash_point",
    "test_ctl_rollout_resume_and_status",
    "test_ctl_rollout_refuses_concurrent_invocation",
    "test_corrupt_record_is_a_clean_ctl_error",
    "test_resume_restores_persisted_budget_and_concurrency",
    "test_resume_with_no_lease_is_rejected",
    "test_invalid_mode_does_not_strand_a_held_lease",
    "test_unfenced_fallback_on_lease_less_client",
    "test_abort_refuses_live_holder_without_force",
    "test_status_honors_lease_namespace_flag",
))
