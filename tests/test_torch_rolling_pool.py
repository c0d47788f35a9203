"""``chip_smoke.py`` phase 17 on the CPU: the rolling flip of a pool of
``chip_smoke.POOL_NODES`` fake HGX H100 nodes, killed at its first window
boundary and resumed by a fenced successor, with a stand-in for K1's matmul
smoke child.

The phase's checks (``chip_smoke.pool_problems``) must all hold, and they
must catch what they exist for: a pool flipped two nodes at a time, a node
smoked twice, a torn flight line and a fenced write not counted."""

import copy
import pathlib
import sys
import time

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from tpu_cc_manager_torch.ops.matmul import default_blocks  # noqa: E402

K1 = 1922  # the matmul smoke's K1 launches (phase 5)


def stand_in_smoke(workload: str) -> dict:
    """What ``run_workload_subprocess("matmul", --kernel cuda)`` returns on
    the card, after a short wait."""
    assert workload == "matmul"
    time.sleep(0.05)  # cclint: test-sleep-ok(the stand-in smoke's own run time)
    return {"ok": True, "devices": 1, "per_device": [{"ok": True}],
            "kernel": "cuda", "generation": "h100-sxm", "size": 4096,
            "blocks": list(default_blocks("h100-sxm", 4096)),
            "kernel_launches": {"K1": K1, "K2": 0, "K3": 0, "K4": 0},
            "kernel_launches_by_variant": {"K1": {"sm90": K1, "simt": 0}}}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    return chip_smoke.rolling_pool(stand_in_smoke, tmp_path_factory.mktemp("pool"))


def test_the_pool_flips_once_per_node_across_the_takeover(pool):
    assert chip_smoke.pool_problems(pool) == []
    assert pool["converged_before_kill"] == ["pool-node-0"]
    assert pool["generations"] == (1, 2)
    # The successor waits out the killed orchestrator's lease.
    assert 0 < pool["takeover_gap_s"] <= 4 * chip_smoke.POOL_LEASE_S
    assert [s["node"] for s in sorted(pool["smokes"], key=lambda s: s["t0"])] == \
        [f"pool-node-{i}" for i in range(chip_smoke.POOL_NODES)]
    summary = pool["result"].summary()
    assert summary["resumed"] and summary["skipped_groups"] == 1
    assert summary["nodes"] == chip_smoke.POOL_NODES


def broken(pool, how):
    bad = copy.copy(pool)
    if how == "two at once":
        bad["desired_at"] = dict(pool["desired_at"], **{"pool-node-1": pool["desired_at"][
            "pool-node-0"]})
    elif how == "smoked twice":
        bad["smokes"] = pool["smokes"] + [dict(pool["smokes"][0], t0=1e12, t1=1e12 + 1)]
    elif how == "torn line":
        bad["torn_lines"] = 1
    elif how == "fence not counted":
        bad["fenced_writes"] = (0, 0)
    return bad


@pytest.mark.parametrize("how,words", [
    ("two at once", "out of service at once"),
    ("smoked twice", "want each node once"),
    ("torn line", "torn flight lines"),
    ("fence not counted", "refused and counted once"),
])
def test_the_checks_catch_what_they_exist_for(pool, how, words):
    problems = chip_smoke.pool_problems(broken(pool, how))
    assert len(problems) == 1 and words in problems[0], problems


def test_a_failed_smoke_fails_the_phase_by_name(pool, monkeypatch, capsys):
    """A verify smoke child that fails and returns no launch counts ends
    the phase with a line naming its node, not with a KeyError."""
    bad = copy.copy(pool)
    bad["smokes"] = [dict(s) for s in pool["smokes"]]
    bad["smokes"][1]["result"] = {"ok": False, "error": "K1 did not build"}
    monkeypatch.setattr(chip_smoke, "rolling_pool", lambda smoke, directory: bad)
    with pytest.raises(SystemExit) as exit_:
        chip_smoke.check_rolling_pool(None, "card", K1)
    assert exit_.value.code == 1
    out = capsys.readouterr().out.splitlines()[-1]
    node = bad["smokes"][1]["node"]
    assert out.startswith("FAIL: rolling pool: ") and f"{node}'s verify smoke failed" in out
    assert "K1 did not build" in out and out.count("verify smoke failed") == 1
