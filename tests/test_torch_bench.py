"""The port's node bench (``tpu_cc_manager_torch/bench/``) on the CPU.

The scenarios are asked for the CPU explicitly (the usable flag false, as a
caller may) and run the real pipeline with real smoke children: the
zero-latency scenario against the JAX ``bench.run_scenario`` (same
pipeline phases in the same order, same ``mode.state`` label sequence);
the realistic scenario at latencies cut to tenths of a second, whose
serialized sum folds in the per-GPU ``reset.chip`` spans; the handshake,
multihost (two fake H100 hosts of one slice, beside the JAX bench's two TPU
hosts) and spare scenarios; the cache bench's gate with its smoke children stubbed,
and the isolation its real children get; ``bench_ab`` as a process.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402
import bench_ab as jbench_ab  # noqa: E402

from tpu_cc_manager import labels as jlabels  # noqa: E402
from tpu_cc_manager.kubeclient import api as japi  # noqa: E402
from tpu_cc_manager_torch import labels as tlabels  # noqa: E402
from tpu_cc_manager_torch.bench import bench as tbench  # noqa: E402
from tpu_cc_manager_torch.kubeclient import api as tapi  # noqa: E402
from tpu_cc_manager_torch.smoke import runner as trunner  # noqa: E402

TENTHS = dict(reset_latency_s=[0.1] * 4, boot_latency_s=0.1, pod_delete_delay_s=0.1)
# The pipeline's phases in order; the manager overlaps the stage with the
# drain and re-admission with the smoke, so each pair ends in either order.
RANK = {"drain": 0, "stage": 0, "reset": 1, "wait_ready": 2, "attest": 3, "readmit": 4,
        "smoke": 4}


def labelled_run(mod, api, labels, monkeypatch, **kw) -> tuple[dict, list[str]]:
    """``mod.run_scenario(False, **kw)`` and the node's ``mode.state``
    values in the order they were written."""
    seen: list[str] = []
    made = mod.make_bench_kube

    def make(names, pod_delete_delay_s=0.0):
        kube = made(names, pod_delete_delay_s)

        def reactor(_name, patched):
            state = api.node_labels(patched).get(labels.CC_MODE_STATE_LABEL)
            if state and (not seen or seen[-1] != state):
                seen.append(state)

        kube.add_patch_reactor(reactor)
        return kube

    monkeypatch.setattr(mod, "make_bench_kube", make)
    return mod.run_scenario(False, **kw), seen


def test_the_control_scenario_runs_the_jax_pipeline(monkeypatch):
    port, port_labels = labelled_run(tbench, tapi, tlabels, monkeypatch)
    ref, ref_labels = labelled_run(jbench, japi, jlabels, monkeypatch)
    assert port["ok"] and ref["ok"]
    assert port["backend"] == "cpu"
    for phases in (port["phases"], ref["phases"]):
        ranks = [RANK[p] for p in phases]
        assert ranks == sorted(ranks), list(phases)
    assert set(port["phases"]) == set(ref["phases"]) == set(RANK)
    assert port_labels == ref_labels and port_labels[-1] == "on"
    assert set(port) == set(ref)


def test_the_realistic_scenario_folds_the_per_gpu_resets_into_the_sum():
    r = tbench.run_scenario(False, reset_parallelism=4, **TENTHS)
    assert r["ok"], r
    durations = r["phase_durations"]
    chips = durations["reset.chip"]
    assert len(chips) == 4 and min(chips) >= 0.1
    serial = sum(sum(durations.get(p, ())) for p in tbench.phase_names())
    folded = serial + max(0.0, sum(chips) - sum(durations["reset"]))
    folded += r["smoke_warmup"]["overlap_s"] or 0.0
    assert r["sum_phase_seconds"] == pytest.approx(folded, abs=2e-3)
    assert r["sum_phase_seconds"] >= r["wall_seconds"]
    assert r["overlap_saved_s"] == pytest.approx(
        r["sum_phase_seconds"] - r["wall_seconds"], abs=2e-3)
    hist = tbench.phase_histograms([r])
    assert hist["reset.chip"]["count"] == 4


def test_the_handshake_scenario_checkpoints_before_the_pause():
    r = tbench.run_handshake_scenario(checkpoint_s=0.1)
    assert r["ok"] and r["checkpoint_before_pause"], r


def test_the_multihost_scenario_meets_at_the_slice_barrier():
    """Both hosts of the 2-host slice reach ``slice`` through the commit
    barrier, each with its barrier wait, as in the JAX bench."""
    want = jbench.run_multihost_scenario()
    r = tbench.run_multihost_scenario()
    assert r["ok"] and want["ok"], (r, want)
    assert set(r) == set(want) == {"seconds", "ok", "barrier_wait_s"}
    assert len(r["barrier_wait_s"]) == 2
    assert all(w is not None and w >= 0 for w in r["barrier_wait_s"]), r


def test_the_spare_is_flipped_ahead_of_the_wave():
    r = tbench.run_spare_prestage_scenario(
        False, reset_latency_s=[0.1] * 4, boot_latency_s=0.2, pod_delete_delay_s=0.1)
    assert r["ok"], r
    assert r["effective_flip_wall_s"] < r["full_path_wall_s"]
    assert [s["backend"] for s in r["smokes"]] == ["cpu", "cpu"]
    assert r["smoke_windows_overlap"] in (True, False)
    assert tbench.windows_overlap([{"start": 0, "end": 2}, {"start": 1, "end": 3}])
    assert not tbench.windows_overlap([{"start": 0, "end": 1}, {"start": 1, "end": 3}])


def smoke_stub(calls: list, writes: dict):
    """A ``_smoke_subprocess`` that records its calls and writes
    ``writes[n]`` = (count, where) libraries on its n-th call: into the
    copy's build directory (``"cache"``) or the child's tmpdir (``"tmp"``)."""

    def stub(workload, timeout_s, force_cpu, extra_env=None, cwd=None):
        n = len(calls)
        calls.append((cwd, dict(extra_env or {}), force_cpu))
        count, where = writes.get(n, (0, "cache"))
        target = (os.path.join(cwd, "build", "torch_kernels") if where == "cache"
                  else os.path.join(extra_env["TMPDIR"], "tpu-cc-torch-kernels"))
        for i in range(count):
            os.makedirs(target, exist_ok=True)
            with open(os.path.join(target, f"matmul-{n}{i}.so"), "w") as f:
                f.write("lib")
        return {"ok": True, "backend": "cuda", "blocks": [256, 128, 64],
                "kernel_launches": {"K1": 3}, "kernel_launches_by_variant": {"K1": {"sm90": 3}}}

    return stub


@pytest.mark.parametrize("writes,ok", [
    ({0: (1, "cache")}, True),
    ({}, False),  # the cold child built nothing: it found a library elsewhere
    ({0: (1, "cache"), 1: (1, "cache")}, False),  # the warm child built again
    ({0: (1, "tmp")}, False),  # a library outside the cache
    ({0: (1, "cache"), 1: (1, "tmp")}, False),
], ids=["cold-built-warm-none", "cold-none", "warm-built", "tmp", "warm-tmp"])
def test_the_cache_gate(monkeypatch, writes, ok):
    calls: list = []
    monkeypatch.setattr(tbench, "_smoke_subprocess", smoke_stub(calls, writes))
    r = tbench.measure_smoke_cache(True)
    assert r["ok"] is ok, r
    assert r["cache_entries"] == (writes.get(0) == (1, "cache"))
    assert len(calls) == 2 and calls[0][:2] == calls[1][:2]
    cwd, env, force_cpu = calls[0]
    assert not force_cpu and env["TPU_CC_CACHE_DIR"] == ""
    assert os.path.dirname(env["TMPDIR"]) == os.path.dirname(cwd)
    assert not os.path.exists(os.path.dirname(cwd))  # removed after
    assert r["smokes"][0]["kernel_launches"] == {"K1": 3}


def test_the_cache_children_see_only_the_copy(monkeypatch):
    """A child started the way the runner starts a smoke, in the copy the
    cache bench makes, imports the copy's package: its kernel libraries are
    looked up only in the copy's build directory and the empty tmpdir,
    never the repository's ``build/torch_kernels``."""
    seen = {}

    def probe(workload, timeout_s, force_cpu, extra_env=None, cwd=None):
        cmd, env = trunner._subprocess_cmd_env(workload, force_cpu, None, extra_env)
        code = ("from tpu_cc_manager_torch.ops import _build; "
                "print([str(p) for p in _build.candidate_build_dirs()])")
        out = subprocess.run([cmd[0], "-c", code], cwd=cwd, env=env, text=True,
                             capture_output=True, timeout=60, check=True).stdout
        seen["dirs"] = json.loads(out.replace("'", '"'))
        seen["root"] = os.path.dirname(cwd)
        return {"ok": True}

    monkeypatch.setattr(tbench, "_smoke_subprocess", probe)
    tbench.measure_smoke_cache(True)
    root = seen["root"]
    assert seen["dirs"] == [os.path.join(root, "tree", "build", "torch_kernels"),
                            os.path.join(root, "tmp", "tpu-cc-torch-kernels")]


def test_a_failed_preflight_fails_the_bench(monkeypatch, capsys):
    """No card: one ``"ok": false`` line and exit 1, no scenario run on the
    CPU."""
    monkeypatch.setattr(tbench, "_cuda_preflight", lambda: False)
    monkeypatch.setattr(tbench, "run_scenario", lambda *a, **k: pytest.fail("ran a scenario"))
    assert tbench.main() == 1
    assert tbench.spare_main(None) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["ok"] for line in lines] == [False, False]
    assert "cuda preflight failed" in json.loads(lines[0])["error"]


def test_the_preflight_probes_the_card():
    """The probe is a torch matmul on ``cuda:0`` in a child: on a box
    without a card every attempt fails."""
    assert tbench._cuda_preflight(timeout_s=60, attempts=1) is False


def test_bench_ab_as_a_process():
    """``--cpu`` pins the smokes to the CPU: one JSON line with the
    reference's keys, each arm's as ``summarize_ab`` makes them, and every
    smoke's kernels."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_cc_manager_torch.bench.bench_ab", "--cpu",
         "--workloads", "matmul", "--reps", "1", "--cycles", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout + proc.stderr[-2000:]
    result = json.loads(lines[0])
    assert proc.returncode == (0 if result["ok"] else 1)
    ref = jbench_ab.summarize_ab(
        workloads=["matmul"], samples={"matmul": {"off": [(1.0, None, None)],
                                                  "on": [(1.0, None, None)]}},
        detail={"matmul": {}}, wall={"matmul": {"off": 1.0, "on": 1.0}},
        errors={"matmul": []}, retired=set(), planned_reps=1, target_pct=3.0)
    assert set(result) == set(ref) | {"smoke_kernels"}
    for mode in ("off", "on"):
        assert set(result["workloads"]["matmul"][mode]) == set(ref["workloads"]["matmul"][mode])
        assert result["workloads"]["matmul"][mode]["backend"] == "cpu"
    assert [(s["workload"], s["mode"], s["backend"]) for s in result["smoke_kernels"]] == [
        ("matmul", "off", "cpu"), ("matmul", "on", "cpu")]
