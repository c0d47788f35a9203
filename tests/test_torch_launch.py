"""The port's local-rank launcher (``tpu_cc_manager_torch/utils/launch.py``)."""

import sys

import pytest

from tpu_cc_manager_torch.utils import launch

# Prints the rank's torchrun names and a launcher name it must not inherit,
# then exits with the code in EXIT_<rank> (0 if unset).
CHILD = ("import os, sys; e = os.environ; "
         "print(e['RANK'], e['WORLD_SIZE'], e['LOCAL_RANK'], e['MASTER_ADDR'], "
         "e.get('JAX_PROCESS_ID'), e.get('MARK'), flush=True); "
         "print('to stderr', file=sys.stderr, flush=True); "
         "sys.exit(int(e.get('EXIT_' + e['RANK'], '0')))")


def test_run_ranks_gives_torchrun_names_and_each_stdout(monkeypatch):
    monkeypatch.setenv("JAX_PROCESS_ID", "7")  # a launcher name of the caller's
    outs = launch.run_ranks([sys.executable, "-c", CHILD], 3, timeout_s=60, env={"MARK": "m"})
    assert outs == [f"{r} 3 {r} 127.0.0.1 None m\n" for r in range(3)]


def test_run_ranks_fails_with_the_failed_rank_output():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 exited 3.*to stderr"):
        launch.run_ranks([sys.executable, "-c", CHILD], 2, timeout_s=60, env={"EXIT_1": "3"})


def test_ranks_stops_every_rank_on_leaving():
    blocked = "import threading; threading.Event().wait(60)"
    with launch.Ranks([sys.executable, "-c", blocked], 2) as ranks:
        assert ranks.failed() is None
        with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] still running"):
            ranks.wait(timeout_s=0.01)
    assert all(p.poll() is not None for p in ranks.procs)
