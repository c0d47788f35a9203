"""The port's smoke workloads, runner and isolation (tpu_cc_manager_torch/smoke).

Everything here runs on the CPU (``device="cpu"``), where the wrappers take
their kernels' plain versions.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_cc_manager_torch.ops.matmul import KERNEL_BLOCKS
from tpu_cc_manager_torch.smoke import llama_infer, runner
from tpu_cc_manager_torch.utils import gpu_info
from tpu_cc_manager_torch.utils.poll import poll_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "tpu_cc_manager_torch.smoke", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
    )


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_matmul_smoke_passes_on_cpu(kernel):
    result = runner.run_workload("matmul", size=256, iters=1, kernel=kernel, device="cpu")
    assert result["ok"] is True
    assert result["kernel"] == kernel
    assert result["backend"] == "cpu" and result["generation"] is None
    assert result["ident_err"] <= 1e-6 and result["rowsum_rel_err"] <= 2e-2
    assert result["blocks"] == (list(KERNEL_BLOCKS) if kernel == "cuda" else None)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert result["kernel_launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    zero = {"sm90": 0, "simt": 0}
    assert result["kernel_launches_by_variant"] == dict.fromkeys(("K1", "K2", "K3", "K4"), zero)
    assert result["mfu"] is None


def second_device_fails(dev, index, count, mode):
    """A smoke body whose second device fails: it raises, dies, or reports
    a failed oracle."""
    if index == 1:
        if mode == "raises":
            raise RuntimeError("device 1 is broken")
        if mode == "dies":
            os._exit(3)
        return {"ok": False, "device_name": "cpu"}
    return {"ok": True, "device_name": "cpu"}


@pytest.mark.parametrize("workload,kwargs", [
    ("matmul", dict(size=384, iters=1)),
    ("llama", dict(batch=2, prompt_len=8, decode_len=4)),
])
def test_smoke_verifies_every_device(monkeypatch, workload, kwargs):
    """Two devices injected on the CPU: one worker each, two sets of
    oracles, ``devices`` 2; every card's oracles pass."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned workers' threads
    result = runner.run_workload(workload, device="cpu", n_devices=2, **kwargs)
    assert result["ok"] is True and result["devices"] == 2
    assert len(result["per_device"]) == 2
    assert all(card["ok"] and card["device_name"] == "cpu" for card in result["per_device"])
    # Each card names its PCI address, the key gpudev resets it by; a CPU has none.
    assert [card["bdf"] for card in result["per_device"]] == [None, None]
    if workload == "matmul":
        assert result["size"] == 256  # a multiple of 128 rows on each of 2 cards
        assert all(card["ident_err"] <= 1e-6 and card["rowsum_rel_err"] <= 2e-2
                   for card in result["per_device"])
        assert result["ident_err"] == max(c["ident_err"] for c in result["per_device"])
    else:
        assert all(card["oracle_ok"] and card["transcript_ok"] for card in result["per_device"])
        assert result["transcript_margin"] == max(
            c["transcript_margin"] for c in result["per_device"])
        assert result["kernel_launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


def test_cuda_matmul_kernel_stays_on_one_device(monkeypatch):
    """K1, the default kernel, verifies every card as the stock kernel does:
    one worker and one set of oracles per card, each at K1's tile."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned workers' threads
    result = runner.run_workload("matmul", size=256, iters=1, device="cpu", n_devices=2)
    assert result["kernel"] == "cuda" and result["blocks"] == list(KERNEL_BLOCKS)
    assert result["ok"] is True and result["devices"] == 2 and result["visible_devices"] == 1
    assert len(result["per_device"]) == 2 and all(c["ok"] for c in result["per_device"])
    with pytest.raises(runner.SmokeConfigError, match="positive integer"):
        runner.run_workload("matmul", size=256, device="cpu", n_devices=0)


def test_device_bdf_reads_the_cards_pci_address(monkeypatch):
    """A card's BDF comes from its CUDA properties (CUDA gives no PCI
    function: a GPU is function 0), by the index torch gives it."""
    from types import SimpleNamespace

    props = {0: SimpleNamespace(pci_domain_id=0, pci_bus_id=0x19, pci_device_id=0),
             1: SimpleNamespace(pci_domain_id=1, pci_bus_id=0xAB, pci_device_id=3)}
    monkeypatch.setattr(torch.cuda, "get_device_properties", props.__getitem__)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert runner.device_bdf(torch.device("cpu")) is None
    assert runner.device_bdf(torch.device("cuda", 0)) == "0000:19:00.0"
    assert runner.device_bdf(torch.device("cuda")) == "0001:ab:03.0"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    from tpu_cc_manager_torch.gpudev.pci import torch_index_by_bdf

    assert torch_index_by_bdf() == {"0000:19:00.0": 0, "0001:ab:03.0": 1}


@pytest.mark.parametrize("mode", ["raises", "dies", "not-ok"])
def test_one_failing_device_fails_the_smoke(monkeypatch, mode):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cpu = torch.device("cpu")
    if mode == "not-ok":
        results = runner.run_per_device(second_device_fails, cpu, 2, mode=mode)
        combined = runner.combine(results, ("ok", "device_name"), {})
        assert combined["ok"] is False and combined["devices"] == 2
        assert [card["ok"] for card in combined["per_device"]] == [True, False]
    else:
        with pytest.raises(runner.SmokeError, match="device 1 of 2 failed"):
            runner.run_per_device(second_device_fails, cpu, 2, mode=mode)


def test_a_failing_device_fails_the_llama_smoke(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(runner.SmokeError, match="reported failure"):
        runner.run_workload("llama", batch=2, prompt_len=8, decode_len=16,
                            cache_position_offset=1, device="cpu", n_devices=2)


def test_matmul_rejects_bad_parameters():
    with pytest.raises(runner.SmokeConfigError, match="unknown matmul kernel"):
        runner.run_workload("matmul", size=256, kernel="pallas", device="cpu")
    with pytest.raises(runner.SmokeConfigError, match="integer"):
        runner.run_workload("matmul", size="big", device="cpu")


def test_llama_smoke_passes_on_cpu():
    result = runner.run_workload("llama", batch=2, prompt_len=8, decode_len=4, device="cpu")
    assert result["ok"] is True
    assert result["oracle_ok"] is True and result["transcript_ok"] is True
    assert 0.0 <= result["transcript_margin"] <= 1e-2
    assert result["flash_kernel_rel_err"] is None  # flash is the card's default only
    assert result["model"] == "tiny" and result["backend"] == "cpu"
    assert result["kernel_launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    for key in ("ms_per_token", "hbm_bw_util", "batch", "prefill_tokens_per_sec",
                "tokens_per_sec", "mfu", "prefill_mfu", "transcript_positions"):
        assert key in result
    if result["timing_valid"]:
        assert result["tokens_per_sec"] > 0


def test_llama_oracle_catches_cache_position_off_by_one():
    with pytest.raises(runner.SmokeError):
        runner.run_workload("llama", batch=2, prompt_len=8, decode_len=16,
                            cache_position_offset=1, device="cpu")
    result = llama_infer.run(batch=2, prompt_len=8, decode_len=16,
                             cache_position_offset=1, device="cpu")
    assert result["ok"] is False
    assert result["transcript_ok"] is False
    assert result["transcript_margin"] > 1e-2


def test_argmax_agrees_margin():
    ref = torch.tensor([[[0.0, 10.0, 9.95]]])
    assert llama_infer.argmax_agrees(ref, torch.tensor([[2]]))  # within 1e-2 of scale
    assert not llama_infer.argmax_agrees(ref, torch.tensor([[0]]))
    assert llama_infer.argmax_shortfall(ref, torch.tensor([[1]])) == 0.0
    got = llama_infer.argmax_shortfall(ref, torch.tensor([[2]]))
    assert got == pytest.approx(0.005, rel=1e-5)
    assert llama_infer.argmax_shortfall(ref, torch.tensor([[0]])) == pytest.approx(1.0)


def test_size_table_equals_jax():
    from tpu_cc_manager.smoke.llama_infer import _pick_config as jax_pick

    sizes = ("tiny", "500m", "llama3.2-1b", "llama3.2-3b", "llama2-7b", "llama3-8b",
             "llama3.1-8b")
    assert sorted(llama_infer.SIZES) == sorted(sizes)
    for size in sizes:
        got_size, cfg = llama_infer._pick_config(size, "cpu")
        want_size, jcfg = jax_pick(size)
        assert got_size == want_size == size
        assert cfg.param_dtype == torch.bfloat16
        assert cfg.param_count() == jcfg.param_count()
        assert (cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling) == (
            jcfg.max_seq_len, jcfg.rope_theta, jcfg.rope_scaling)
    assert llama_infer._pick_config(None, "cpu")[0] == "tiny"
    assert llama_infer._pick_config(None, "cuda")[0] == "500m"
    with pytest.raises(ValueError):
        llama_infer._pick_config("gpt5", "cpu")


def test_subprocess_runner_contract():
    result = runner.run_workload_subprocess("matmul", force_cpu=True, timeout_s=300)
    assert result["ok"] is True and result["backend"] == "cpu"
    with pytest.raises(runner.SmokeError, match="unknown smoke workload"):
        runner.run_workload_subprocess("does-not-exist", force_cpu=True)
    with pytest.raises(runner.SmokeError, match="unknown smoke workload"):
        runner.run_workload("does-not-exist")


@pytest.mark.parametrize("args,message", [
    (["--workload", "llama", "--kernel", "cuda"], "--kernel only applies"),
    (["--workload", "llama", "--batch", "0"], "--batch must be positive"),
    (["--workload", "matmul", "--batch", "2"], "--batch only applies"),
    (["--workload", "matmul", "--size", "big"], "--size must be an integer"),
    (["--workload", "llama", "--size", "gpt5"], "unknown llama smoke size"),
    (["--workload", "nope"], "unknown smoke workload"),
])
def test_cli_usage_errors_are_one_json_line(args, message):
    proc = smoke_cli(*args, "--device", "cpu")
    assert proc.returncode == 1
    out = last_json(proc.stdout)
    assert out["ok"] is False and message in out["error"]


def test_cuda_requested_without_a_card_fails_without_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    proc = smoke_cli("--workload", "matmul")
    assert proc.returncode == 1
    out = last_json(proc.stdout)
    assert out == {"ok": False, "workload": "matmul", "error": out["error"]}
    assert "CUDA" in out["error"]
    with pytest.raises(runner.SmokeError, match="CUDA"):
        runner.run_workload("llama", device="cuda")


def test_profile_dir_writes_a_trace(tmp_path):
    proc = smoke_cli("--workload", "matmul", "--size", "128", "--device", "cpu",
                     "--profile-dir", str(tmp_path / "trace"))
    assert proc.returncode == 0, proc.stderr[-400:]
    assert last_json(proc.stdout)["ok"] is True
    assert list((tmp_path / "trace").glob("*.trace.json")), "no trace written"


def test_dispatch_gate(monkeypatch, tmp_path):
    monkeypatch.delenv(runner.DISPATCH_GATE_ENV, raising=False)
    assert runner.await_dispatch_gate() is False
    gate = tmp_path / "gate"
    monkeypatch.setenv(runner.DISPATCH_GATE_ENV, str(gate))
    monkeypatch.setenv(runner.GATE_TIMEOUT_ENV, "0.2")
    monkeypatch.delenv(runner.GATE_PARENT_PID_ENV, raising=False)
    built = []
    with pytest.raises(runner.SmokeError, match="not released"):
        runner.await_dispatch_gate(compile_fns=(lambda: built.append(1),))
    assert built == [1]
    assert os.path.exists(runner.compiled_sentinel(str(gate)))
    gate.write_text("released")
    assert runner.await_dispatch_gate() is True


def test_dispatch_gate_orphan_exits(monkeypatch, tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait(timeout=60)
    monkeypatch.setenv(runner.DISPATCH_GATE_ENV, str(tmp_path / "gate"))
    monkeypatch.setenv(runner.GATE_PARENT_PID_ENV, str(dead.pid))
    monkeypatch.setenv(runner.GATE_TIMEOUT_ENV, "30")
    with pytest.raises(runner.SmokeError, match="orphan"):
        runner.await_dispatch_gate()


def test_smoke_warmup_gates_dispatch_until_release():
    warm = runner.SmokeWarmup("matmul", force_cpu=True, extra_args=["--size", "128"])
    try:
        assert poll_until(lambda: warm.compiled_after_s() is not None, 120, 0.05)
        assert not warm.died_during_warmup()
        result = warm.release_and_result()
    finally:
        warm.cancel("test cleanup")
    assert result["ok"] is True
    assert result["warmup_compile_s"] is not None
    assert result["warmup_overlap_s"] >= 0 and result["warmup_dispatch_s"] >= 0


def test_gpu_info_table():
    assert gpu_info.variant_from_name("NVIDIA H100 80GB HBM3") == "h100-sxm"
    assert gpu_info.variant_from_name("NVIDIA H100 PCIe") == "h100-pcie"
    assert gpu_info.variant_from_name("NVIDIA H100 NVL") == "h100-nvl"
    assert gpu_info.variant_from_name("NVIDIA H200") == "h200"
    assert gpu_info.variant_from_name("NVIDIA A100-SXM4-80GB") is None
    assert gpu_info.PEAK_BF16_FLOPS["h100-sxm"] == 989e12
    assert gpu_info.PEAK_HBM_BYTES_PER_S["h100-sxm"] == 3.35e12
    assert gpu_info.generation_for("cpu") is None
    # An unknown card has no peak: no MFU, never a silent default.
    assert gpu_info.peak_flops_per_chip("a100") is None
    assert gpu_info.peak_hbm_bytes_per_chip("a100") is None


def test_poll_until_deadline():
    now = [0.0]

    def sleep(dt):
        now[0] += dt

    assert poll_until(lambda: now[0] >= 1.0, 5.0, 0.25, sleep=sleep, clock=lambda: now[0])
    now[0] = 0.0
    assert not poll_until(lambda: False, 1.0, 0.3, sleep=sleep, clock=lambda: now[0])
    assert now[0] == pytest.approx(1.0)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports without JAX, the JAX package or
    nvcc: nothing is built or loaded at import. The agent's, the fleet
    rollout's and the operator's modules (``ccmanager``, ``serve``,
    ``faults``, ``ctl``, ``obs/fleet``, ``lint``, the deployment's readers
    ``deploy``, the node bench ``bench``, the measurement tools (``sweep``,
    ``tune_cuda``, ``batch_ladder``, ``apply_sweep``, ``serve_bench``,
    ``scale_bench``) and what they import) import no torch, and importing
    ``__main__`` does not start the agent. The kernels' build command
    (``ops/_build.py``) is one of the modules."""
    code = """
import importlib, pkgutil, sys
import tpu_cc_manager_torch.ccmanager.cli, tpu_cc_manager_torch.ccmanager.localrig
import tpu_cc_manager_torch.ccmanager.rolling, tpu_cc_manager_torch.serve
import tpu_cc_manager_torch.faults, tpu_cc_manager_torch.drain.sim
import tpu_cc_manager_torch.ctl, tpu_cc_manager_torch.ccmanager.federation
import tpu_cc_manager_torch.obs.fleet, tpu_cc_manager_torch.lint.__main__
import tpu_cc_manager_torch.deploy
import tpu_cc_manager_torch.bench.bench, tpu_cc_manager_torch.bench.bench_ab
import tpu_cc_manager_torch.bench.smoke_cache_bench, tpu_cc_manager_torch.bench.sweep
import tpu_cc_manager_torch.bench.tune_cuda, tpu_cc_manager_torch.bench.batch_ladder
import tpu_cc_manager_torch.bench.apply_sweep, tpu_cc_manager_torch.bench.serve_bench
import tpu_cc_manager_torch.bench.scale_bench
assert not [m for m in sys.modules if m == "torch" or m.startswith("torch.")]
import tpu_cc_manager_torch
names = [m.name for m in pkgutil.walk_packages(tpu_cc_manager_torch.__path__, "tpu_cc_manager_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m in ("jax", "flax") or m.startswith(("jax.", "flax."))
       or m == "tpu_cc_manager" or m.startswith("tpu_cc_manager.")]
assert not bad, bad
from tpu_cc_manager_torch.ops import _build
assert _build.loaded() == [], _build.loaded()
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    env.pop("NODE_NAME", None)  # so an agent that started would exit 1 at once
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 100
    assert "node-name" not in proc.stderr and "tpu-cc-manager" not in proc.stderr
