"""The port's serving bench (``tpu_cc_manager_torch/bench/serve_bench.py``)
on the CPU, against the repository's ``hack/serve_bench.py``.

The default mode (a closed-loop rolling flip, SERVE_r01) runs in both, as
processes, at a small pool and a short traffic window: both must be ``ok``
by the reference's terms, with the same keys and no request lost. Then
``--calibrate-smoke`` runs with the port's smoke runner replaced: by a
recorded result of the port's default Llama smoke on an H100 (the executor
is calibrated from it, and the line carries its fields), and by a smoke
that fails, which must make the bench fail (one ``"ok": false`` line,
exit code 1) where the reference would go on uncalibrated.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from tpu_cc_manager_torch.bench import serve_bench  # noqa: E402
from tpu_cc_manager_torch.serve import SimulatedExecutor  # noqa: E402
from tpu_cc_manager_torch.smoke import runner  # noqa: E402

SMALL = ["--nodes", "2", "--traffic-s", "1.5"]
# The result line of the port's default Llama smoke (500m, batch 4) on one
# NVIDIA H100 80GB HBM3 at 700 W, ``python -m tpu_cc_manager_torch.smoke
# --workload llama``: what --calibrate-smoke reads on the card.
RECORDED = {'ok': True,
            'workload': 'llama',
            'model': '500m',
            'backend': 'cuda',
            'device_name': 'NVIDIA H100 80GB HBM3',
            'bdf': '0000:5d:00.0',
            'generation': 'h100-sxm',
            'params': 317228032,
            'batch': 4,
            'decode_len': 32,
            'timing_valid': True,
            'tokens_per_sec': 192.21,
            'ms_per_token': 20.81,
            'mfu': 0.0001,
            'hbm_bw_util': 0.0094,
            'hbm_bw_accounting': 'weights+allocated-kv',
            'hbm_bw_util_lower_bound': True,
            'prefill_tokens_per_sec': None,
            'prefill_mfu': None,
            'oracle_ok': True,
            'transcript_ok': True,
            'transcript_positions': 32,
            'transcript_margin': 0.001137,
            'flash_kernel_rel_err': 0.016538,
            'kernel_launches': {'K1': 0, 'K2': 16, 'K3': 0, 'K4': 0},
            'kernel_launches_by_variant': {'K1': {'sm90': 0, 'simt': 0},
                                           'K2': {'sm90': 16, 'simt': 0},
                                           'K3': {'sm90': 0, 'simt': 0},
                                           'K4': {'sm90': 0, 'simt': 0}},
            'devices': 1,
            'per_device': [{'device_name': 'NVIDIA H100 80GB HBM3',
                            'bdf': '0000:5d:00.0',
                            'ok': True,
                            'oracle_ok': True,
                            'transcript_ok': True,
                            'transcript_margin': 0.001137,
                            'flash_kernel_rel_err': 0.016538,
                            'tokens_per_sec': 192.21,
                            'kernel_launches': {'K1': 0, 'K2': 16, 'K3': 0, 'K4': 0}}]}


def run(tool: str, args: list[str]) -> tuple[dict, int]:
    proc = subprocess.run([sys.executable, tool, *args], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, (proc.stdout, proc.stderr[-2000:])
    return json.loads(lines[0]), proc.returncode


def test_the_default_mode_flips_the_pool_without_loss_as_the_reference_does():
    port, port_rc = run(os.path.join(REPO, "tpu_cc_manager_torch", "bench", "serve_bench.py"),
                        SMALL)
    ref, ref_rc = run(os.path.join(REPO, "hack", "serve_bench.py"), SMALL)
    for res, rc in ((port, port_rc), (ref, ref_rc)):
        assert rc == 0 and res["ok"], res
        assert res["requests_lost"] == 0 and res["nodes_bounced"] == 2
        assert res["latency_during_rollout"]["count"] > 0
        assert res["latency_steady_state"]["count"] > 0
        assert res["calibration"] is None
    assert sorted(port) == sorted(ref)
    assert sorted(port["fleet_rollup"]) == sorted(ref["fleet_rollup"])


def test_calibrate_smoke_calibrates_the_executor_from_the_port_smoke(monkeypatch, capsys):
    calls, made = [], []

    def recorded(name, **kwargs):
        calls.append((name, kwargs))
        return dict(RECORDED)

    calibrate = SimulatedExecutor.from_smoke_result.__func__

    def from_smoke_result(cls, smoke):
        made.append(calibrate(cls, smoke))
        return made[-1]

    monkeypatch.setattr(runner, "run_workload_subprocess", recorded)
    monkeypatch.setattr(SimulatedExecutor, "from_smoke_result", classmethod(from_smoke_result))
    rc = serve_bench.main([*SMALL, "--calibrate-smoke"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [("llama", {"timeout_s": 600.0, "cwd": REPO})]  # on the card
    assert line["calibration"] == {k: RECORDED[k] for k in (
        "ms_per_token", "hbm_bw_util", "hbm_bw_util_lower_bound", "backend", "batch")}
    assert rc == 0 and line["ok"], line
    assert line["requests_lost"] == 0 and line["nodes_bounced"] == 2
    assert len(made) >= 2  # one executor a node, each calibrated
    for ex in made:
        assert ex.per_token_s == pytest.approx(RECORDED["ms_per_token"] / 1e3)
        assert ex.weight_frac == pytest.approx(0.5 * RECORDED["hbm_bw_util"])
        assert ex.kv_frac == pytest.approx(0.5 * RECORDED["hbm_bw_util"] / RECORDED["batch"])


@pytest.mark.parametrize("smoke", [
    runner.SmokeError("workload llama exited rc=1: {'ok': False, 'error': 'CUDA was requested "
                      "but torch.cuda.is_available() is false'}"),
    {"ok": True, "workload": "llama", "backend": "cuda", "ms_per_token": None},
], ids=["smoke-failed", "no-ms-per-token"])
def test_a_failed_calibration_smoke_fails_the_bench(smoke, monkeypatch, capsys, tmp_path):
    def failed(name, **kwargs):
        if isinstance(smoke, Exception):
            raise smoke
        return dict(smoke)

    monkeypatch.setattr(runner, "run_workload_subprocess", failed)
    out = tmp_path / "serve.json"
    rc = serve_bench.main([*SMALL, "--calibrate-smoke", "--out", str(out)])
    said = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(said) == 1
    line = json.loads(said[0])
    assert line["ok"] is False and line["error"].startswith("calibration smoke failed: ")
    assert "nodes_bounced" not in line  # no traffic was served uncalibrated
    assert json.loads(out.read_text()) == line
    if isinstance(smoke, Exception):
        assert "CUDA was requested" in line["error"] and line["calibration"]["backend"] is None
    else:
        assert line["calibration"]["backend"] == "cuda"
