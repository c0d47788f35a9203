"""``chip_smoke.py`` phase 16 (b): the agent CLI's flips with each verify
smoke, one agent after the other on one rig (``cli_flip``), the checks of
each flip's smoke (``cli_smoke_problems``), and the two-host flip of one
slice (``cli_slice_flip``), whose host 0 smoke phase 5's checks take
(``check_matmul_smoke``), on the CPU; and phase 22 (c)'s serving bench,
calibrated from the Llama flip's smoke (``serve_child``)."""

import json
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from tpu_cc_manager_torch.ccmanager import localrig  # noqa: E402

CARD = [{"ok": True}]
MATMUL = {"workload": "matmul", "ok": True, "backend": "cuda", "devices": 1, "per_device": CARD,
          "kernel": "cuda", "size": 4096, "generation": "h100-sxm", "blocks": [256, 128, 64],
          "tflops": 468.1, "mfu": 0.473, "ident_err": 0.0, "rowsum_rel_err": 1.2e-3,
          "visible_devices": 1,
          "kernel_launches": {"K1": 1922, "K2": 0, "K3": 0, "K4": 0},
          "kernel_launches_by_variant": {"K1": {"sm90": 1922, "simt": 0}}}
LLAMA = {"workload": "llama", "ok": True, "backend": "cuda", "devices": 1, "per_device": CARD,
         "model": "500m", "prefill_tokens_per_sec": 197912.03, "prefill_mfu": 0.127,
         "kernel_launches": {"K1": 0, "K2": 16, "K3": 0, "K4": 0},
         "kernel_launches_by_variant": {"K2": {"sm90": 16, "simt": 0}}}
RESNET = {"workload": "resnet", "ok": True, "backend": "cuda", "devices": 1, "per_device": CARD,
          "batch": 64, "timing_valid": True, "loss_first": 7.0088, "loss_last": 3.0181}


@pytest.mark.parametrize("workload, smokes, problem", [
    ("matmul", [MATMUL], None),
    ("llama", [LLAMA], None),
    ("resnet", [RESNET], None),
    ("llama", [], "0 verify smokes logged"),
    ("resnet", [RESNET, RESNET], "2 verify smokes logged"),
    ("matmul", [{**MATMUL, "blocks": [128, 128, 64]}], "not K1 at the default"),
    ("llama", [{**LLAMA, "ok": False}], "did not pass on every card"),
    ("llama", [{**LLAMA, "backend": "cpu"}], "did not pass on every card"),
    ("llama", [{**LLAMA, "devices": 2}], "did not pass on every card"),
    ("resnet", [{**RESNET, "per_device": [{"ok": False}]}], "did not pass on every card"),
    ("llama", [{**LLAMA, "kernel_launches_by_variant": {"K2": {"sm90": 15, "simt": 1}}}],
     "K2 launches not all sm90"),
    ("llama", [{**LLAMA, "kernel_launches": {"K2": 0}, "kernel_launches_by_variant": {}}],
     "K2 launches not all sm90"),
    ("llama", [{**LLAMA, "prefill_tokens_per_sec": None, "prefill_mfu": None}],
     "no prefill rate"),
    ("llama", [{**LLAMA, "prefill_mfu": 6.06}], "not in (0, 1]"),
    ("resnet", [{**RESNET, "loss_last": 7.5}], "timing or loss"),
    ("resnet", [{**RESNET, "timing_valid": False}], "timing or loss"),
])
def test_each_flips_smoke_is_held_to_its_checks(workload, smokes, problem, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    got = chip_smoke.cli_smoke_problems(workload, smokes)
    if problem is None:
        assert got == []
    else:
        assert len(got) == 1 and problem in got[0], got


def test_the_cli_flips_run_one_agent_after_another_on_one_rig(tmp_path, monkeypatch):
    """Each agent finds the node's CC labels cleared by ``cli_flip`` after
    the one before left it on, applies its default (off), flips to on
    within the budget with every phase recorded and one smoke of its own
    workload (on the CPU here), and exits 0 on SIGTERM."""
    seen = {}

    def smokes_of(workload, smokes):
        seen[workload] = smokes
        return [] if len(smokes) == 1 and smokes[0]["workload"] == workload \
            and smokes[0]["ok"] else [f"smokes {smokes}"]

    monkeypatch.setattr(chip_smoke, "cli_smoke_problems", smokes_of)
    env = {"CC_SMOKE_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "GPU_CC_FAKE_NUM_GPUS": "1",
           "GPU_CC_FAKE_NUM_SWITCHES": "0"}
    with localrig.LocalRig(str(tmp_path / "rig")) as rig:
        flips = {w: chip_smoke.cli_flip(rig, w, tmp_path, env, "cpu")
                 for w in chip_smoke.CLI_SMOKES}
        assert len(rig.procs) == 1 + len(chip_smoke.CLI_SMOKES)  # the mock, then each agent
    assert sorted(seen) == sorted(chip_smoke.CLI_SMOKES)
    for workload, flip in flips.items():
        assert flip["drain_to_ready_s"] < chip_smoke.AGENT_BUDGET_S
        assert set(chip_smoke.AGENT_PHASES) <= set(flip["phase_s"])
        assert flip["smoke"]["workload"] == workload and flip["smoke"]["backend"] == "cpu"
        assert (tmp_path / f"state-{workload}").is_dir()
    assert flips["resnet"]["smoke"]["model"] == "tiny"


SERVE_SMALL = ["--calibrate-smoke", "--nodes", "2", "--traffic-s", "1.5"]


def test_the_serving_bench_is_calibrated_from_the_llama_flips_smoke(tmp_path, capsys):
    """Phase 22 (c)'s child: ``serve_bench --calibrate-smoke`` takes phase
    16 (b)'s Llama flip's verify smoke (the same command) instead of running
    it again; the line's calibration is that smoke's, and the runner is
    restored after."""
    from tpu_cc_manager_torch.smoke import runner

    smoke = {**LLAMA, "batch": 4, "ms_per_token": 18.116, "hbm_bw_util": 0.0108,
             "hbm_bw_util_lower_bound": True}
    recorded = tmp_path / "smoke.json"
    recorded.write_text(json.dumps(smoke))
    spawn = runner.run_workload_subprocess
    rc = chip_smoke.serve_child(str(recorded), SERVE_SMALL)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["ok"], line
    assert line["requests_lost"] == 0 and line["nodes_bounced"] == 2
    assert line["calibration"] == {k: smoke[k] for k in chip_smoke.CALIBRATION_KEYS}
    assert runner.run_workload_subprocess is spawn


@pytest.mark.parametrize("call", [
    {"name": "matmul"},
    {"name": "llama", "extra_args": ["--size", "llama3-8b"]},
    {"name": "llama", "force_cpu": True},
    {"name": "llama", "extra_env": {"CC_SMOKE_DEVICE": "cpu"}},
])
def test_the_serving_bench_child_holds_only_the_default_llama_smoke(call, tmp_path, monkeypatch):
    """Any smoke but the one the flip ran is refused, not answered with it."""
    from tpu_cc_manager_torch.bench import serve_bench
    from tpu_cc_manager_torch.smoke import runner

    recorded = tmp_path / "smoke.json"
    recorded.write_text(json.dumps(LLAMA))
    monkeypatch.setattr(serve_bench, "main", lambda argv: runner.run_workload_subprocess(**call))
    with pytest.raises(runner.SmokeError, match="only the default Llama smoke"):
        chip_smoke.serve_child(str(recorded), SERVE_SMALL)


def test_the_two_host_flip_meets_at_the_slice_barrier(tmp_path, monkeypatch):
    """Phase 16 (b)'s two-host flip on the CPU: host 0 (the matmul smoke,
    on the CPU here) stays staged while alone, then both hosts reach
    ``slice`` with host 0 ready within the budget, host 0's phases hold its
    barrier wait, host 0 logs one smoke and host 1 none, and both agents
    exit 0."""
    seen = []

    def smokes_of(workload, smokes):
        seen.append((workload, smokes))
        return [] if len(smokes) == 1 and smokes[0]["ok"] else [f"smokes {smokes}"]

    monkeypatch.setattr(chip_smoke, "cli_smoke_problems", smokes_of)
    env = {"CC_SMOKE_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "GPU_CC_FAKE_NUM_GPUS": "1",
           "GPU_CC_FAKE_NUM_SWITCHES": "0"}
    flip = chip_smoke.cli_slice_flip(tmp_path, env, "cpu")
    assert [w for w, _ in seen] == ["matmul"]
    assert flip["smoke"]["workload"] == "matmul" and flip["smoke"]["backend"] == "cpu"
    assert flip["flip_s"] < chip_smoke.AGENT_BUDGET_S
    assert set(chip_smoke.SLICE_PHASES) <= set(flip["phase_s"])
    assert flip["phase_s"]["barrier"] > 0
    assert (tmp_path / "slice-rig" / "state").is_dir()
    assert (tmp_path / "slice-rig" / "state-demo-node-1").is_dir()


@pytest.mark.parametrize("res, problem", [
    (MATMUL, None),
    ({**MATMUL, "blocks": [128, 128, 64]}, "not K1 at the default"),
    ({**MATMUL, "kernel_launches_by_variant": {"K1": {"sm90": 1921, "simt": 1}}},
     "not all on its sm90 kernel"),
    ({**MATMUL, "backend": "cpu"}, "not the card"),
    ({**MATMUL, "devices": 2}, "devices"),
])
def test_phase_5_holds_the_two_host_flips_smoke(res, problem, monkeypatch, capsys):
    """Phase 5's ``--kernel cuda`` checks, given host 0's verify smoke of
    the two-host flip in place of a child of its own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if problem is None:
        launches = chip_smoke.check_matmul_smoke(torch, "cuda", res, "host 0")
        assert launches["K1"] == launches["K1/sm90"] == 1922
        assert "matmul smoke kernel=cuda (host 0)" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit):
            chip_smoke.check_matmul_smoke(torch, "cuda", res, "host 0")
        assert problem in capsys.readouterr().out
