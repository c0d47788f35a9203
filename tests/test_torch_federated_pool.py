"""``chip_smoke.py`` phase 18 on the CPU: the federated flip of two regions,
one fake HGX H100 node each, through the port's ``ctl.cmd_rollout
--regions``, the r1 shard killed at its first parent exchange and resumed
by ``rollout --resume --regions``, with a stand-in for K1's matmul smoke
child.

The phase's checks (``chip_smoke.federated_problems``) must all hold, and
they must catch what they exist for: a node smoked twice, a shard that
did not resume its record, a region counted twice in the parent record, a
fenced write not counted, a torn flight line, a gateway sum that is off,
and a node that ``ctl status`` does not list on."""

import copy
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_rolling_pool import K1, stand_in_smoke  # noqa: E402


@pytest.fixture(scope="module")
def fed(tmp_path_factory):
    return chip_smoke.federated_pool(stand_in_smoke, tmp_path_factory.mktemp("federation"))


def test_the_regions_flip_once_per_node_across_the_resume(fed):
    assert chip_smoke.federated_problems(fed) == []
    # The r1 shard died before it touched its node; r2's shard finished.
    assert fed["converged_before_kill"] == ["fed-node-r2"]
    assert [s["node"] for s in sorted(fed["smokes"], key=lambda s: s["t0"])] == \
        ["fed-node-r2", "fed-node-r1"]
    regions = fed["summary"]["regions"]
    assert regions["r1"]["resumed"] and regions["r1"]["generation"] == 2
    assert regions["r2"]["skipped_groups"] == 1  # already on: not bounced again
    assert fed["parent"]["status"] == "complete" and fed["parent"]["budget_spend"] == []
    assert fed["timeline"]["generations"] == [1, 2] and fed["timeline"]["resumes"] == 1
    assert 'tpu_cc_phase_seconds_count{mode="on",phase="smoke"} 2' in fed["merged"]


def broken(fed, how):
    bad = copy.copy(fed)
    if how == "smoked twice":
        bad["smokes"] = fed["smokes"] + [dict(fed["smokes"][0], t0=1e12, t1=1e12 + 1)]
    elif how == "not resumed":
        bad["resume_digest"] = None
    elif how == "region counted twice":
        parent = copy.deepcopy(fed["parent"])
        parent["regions"]["r2"]["done"] = 2
        bad["parent"] = parent
    elif how == "fence not counted":
        bad["fenced_writes"] = (0, 0)
    elif how == "torn line":
        bad["torn_lines"] = 1
    elif how == "gateway sum off":
        bad["merged"] = fed["merged"].replace(
            'tpu_cc_phase_seconds_count{mode="on",phase="smoke"} 2',
            'tpu_cc_phase_seconds_count{mode="on",phase="smoke"} 1')
    elif how == "status not on":
        bad["status_text"] = fed["status_text"].replace("on         on", "on         off", 1)
    return bad


@pytest.mark.parametrize("how,words", [
    ("smoked twice", "want each node once"),
    ("not resumed", "record is not the parent's"),
    ("region counted twice", "each region's node once"),
    ("fence not counted", "refused and counted once"),
    ("torn line", "torn flight lines"),
    ("gateway sum off", "not the nodes' sums"),
    ("status not on", "ctl status does not list both nodes on"),
])
def test_the_checks_catch_what_they_exist_for(fed, how, words):
    problems = chip_smoke.federated_problems(broken(fed, how))
    assert len(problems) == 1 and words in problems[0], problems


def test_a_failed_smoke_fails_the_phase_by_name(fed, monkeypatch, capsys):
    """A verify smoke child that fails ends the phase with a line naming its
    node."""
    bad = copy.copy(fed)
    bad["smokes"] = [dict(s) for s in fed["smokes"]]
    bad["smokes"][0]["result"] = {"ok": False, "error": "K1 did not build"}
    monkeypatch.setattr(chip_smoke, "federated_pool", lambda smoke, directory: bad)
    with pytest.raises(SystemExit) as exit_:
        chip_smoke.check_federated_pool(None, "card", K1)
    assert exit_.value.code == 1
    out = capsys.readouterr().out.splitlines()[-1]
    node = bad["smokes"][0]["node"]
    assert out.startswith("FAIL: federated flip: ") and f"{node}'s verify smoke failed" in out
