"""The port's sweep tools on the CPU: ``bench/sweep.py`` against the
repository's ``hack/sweep_lib.sh``, ``bench/tune_cuda.py`` and
``bench/batch_ladder.py`` (their rung commands, then real smoke rungs with
``--device cpu`` added here, in the test only: the tools have no CPU
option), and ``bench/apply_sweep.py`` against ``hack/apply_sweep.py`` on
the same artifacts (the reference without ``--write`` only: with it, it
edits the JAX package's table). ``--write`` runs on a temporary copy of the
port's ``ops/matmul.py``; the repository's file must stay byte for byte as
it was.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tpu_cc_manager_torch.bench import apply_sweep, batch_ladder, sweep, tune_cuda  # noqa: E402
from tpu_cc_manager_torch.ops import matmul  # noqa: E402

PY = sys.executable
# Three rungs: a JSON result after other output, a crash whose last line
# is no JSON, and a JSON error line followed by exit 1.
RUNGS = (
    ("json", [PY, "-c", 'import sys; print("warming up"); print("noise", file=sys.stderr); '
                        'print(\'{"ok": true, "tflops": 1.5, "blocks": [64, 64, 64]}\')']),
    ("crash", [PY, "-c", 'import sys; print("Traceback (most recent call last):", '
                         'file=sys.stderr); print("Segmentation fault"); sys.exit(139)']),
    ("error", [PY, "-c", 'import sys; print(\'{"ok": false, "error": "out of memory"}\'); '
                         'sys.exit(1)']),
)


def shell_sweep(out, errlog, rungs, resume: bool) -> str:
    """The rungs through ``hack/sweep_lib.sh``, as its tools loop over
    them; returns the shell's stdout."""
    script = ['. hack/sweep_lib.sh', 'sweep_init "$OUT" "$ERRLOG"']
    for tag, cmd in rungs:
        argv = " ".join("'" + a.replace("'", "'\\''") + "'" for a in cmd)
        script.append(f'if sweep_done "$OUT" "{tag}"; then echo "skip {tag}"; '
                      f'else run_rung "$OUT" "$ERRLOG" "{tag}" {argv}; fi')
    env = {**os.environ, "OUT": str(out), "ERRLOG": str(errlog), "RESUME": "1" if resume else "0"}
    proc = subprocess.run(["bash", "-c", "\n".join(script)], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def port_sweep(out, errlog, rungs, resume: bool, monkeypatch, capsys) -> str:
    """The same rungs through ``bench/sweep.py``; returns its stdout."""
    monkeypatch.setenv("RESUME", "1" if resume else "0")
    sweep.sweep_init(str(out), str(errlog))
    for tag, cmd in rungs:
        if sweep.sweep_done(str(out), tag):
            print(f"skip {tag}")
        else:
            sweep.run_rung(str(out), str(errlog), tag, cmd)
    return capsys.readouterr().out


def headers(path) -> list[str]:
    """The error log's headers, the resume stamp's time left out."""
    return [line.split(" 20")[0] if line.startswith("=== resume") else line
            for line in path.read_text().splitlines() if line.startswith("===")]


def test_the_sweep_helpers_record_and_resume_as_the_shell_does(tmp_path, monkeypatch, capsys):
    sides = {}
    for side in ("shell", "port"):
        out, errlog = tmp_path / f"{side}.jsonl", tmp_path / f"{side}.log"
        out.write_text("stale row\n")  # a fresh sweep truncates it
        run = shell_sweep if side == "shell" else (
            lambda *a: port_sweep(*a, monkeypatch=monkeypatch, capsys=capsys))
        first = run(out, errlog, RUNGS, False)
        rows, log = out.read_text(), errlog.read_text()
        again = run(out, errlog, RUNGS, True).replace(str(out), "OUT")
        sides[side] = (first, rows, log, again, out.read_text(), headers(errlog))
    shell, port = sides["shell"], sides["port"]
    assert port[1].splitlines() == shell[1].splitlines() == [
        '{"ok": true, "tflops": 1.5, "blocks": [64, 64, 64], "rung": "json"}',
        "Segmentation fault",
        '{"ok": false, "error": "out of memory", "rung": "error"}']
    assert port[0] == shell[0]  # the recorded lines, echoed
    # Every rung's header, each child's stderr below its own.
    assert port[2] == shell[2] == ("=== json ===\nnoise\n=== crash ===\nTraceback (most "
                                   "recent call last):\n=== error ===\n")
    # Resumed: the tagged rungs are skipped; the crash tail carries no tag,
    # so that rung runs again, in both.
    assert port[3] == shell[3]
    assert port[3].splitlines() == [">>> RESUME=1: keeping 3 existing row(s) in OUT",
                                    "skip json", "Segmentation fault", "skip error"]
    assert port[4] == shell[4] == shell[1] + "Segmentation fault\n"
    assert port[5] == shell[5] == ["=== json ===", "=== crash ===", "=== error ===",
                                   "=== resume", "=== crash ==="]


def test_the_rung_commands_are_the_reference_tools_commands():
    assert tune_cuda.rung_cmd("4096", "256,128,64") == [
        PY, "-m", "tpu_cc_manager_torch.smoke", "--workload", "matmul", "--kernel", "cuda",
        "--size", "4096", "--cuda-blocks", "256,128,64"]
    assert batch_ladder.rung_cmd("llama", "llama3.2-1b", "4") == [
        PY, "-m", "tpu_cc_manager_torch.smoke", "--workload", "llama", "--size", "llama3.2-1b",
        "--batch", "4"]
    assert batch_ladder.rung_cmd("resnet", "", "32") == [
        PY, "-m", "tpu_cc_manager_torch.smoke", "--workload", "resnet", "--batch", "32"]
    # The reference's rungs, flag for flag (pallas -> cuda).
    with open(os.path.join(REPO, "hack", "tune_pallas.sh"), encoding="utf-8") as f:
        tune = f.read()
    assert ("python3 -m tpu_cc_manager.smoke --workload matmul --kernel pallas \\\n"
            '    --size "$SIZE" --pallas-blocks "$cfg"') in tune


def test_the_default_tiles_are_every_compiled_tile_the_default_first():
    tiles = [tuple(int(b) for b in cfg.split(",")) for cfg in tune_cuda.default_configs().split()]
    assert sorted(tiles) == sorted(matmul.SM90_TILES) and len(tiles) == 16
    assert tiles[0] == matmul.DEFAULT_BLOCKS["h100-sxm"]
    assert tiles[:len(tune_cuda.RANKED)] == list(tune_cuda.RANKED)
    assert tiles[len(tune_cuda.RANKED):] == [t for t in matmul.SM90_TILES
                                             if t not in tune_cuda.RANKED]


def on_cpu(module, monkeypatch):
    """``module``'s rungs with the smoke's ``--device cpu`` added (this
    test's request, not the tool's), one intra-op thread each."""
    made = module.rung_cmd
    monkeypatch.setattr(module, "rung_cmd", lambda *a: made(*a) + ["--device", "cpu"])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_tune_cuda_runs_real_rungs_and_apply_sweep_refuses_the_cpu_artifact(
        tmp_path, monkeypatch, capsys):
    out, errlog = tmp_path / "cuda_sweep.jsonl", tmp_path / "cuda_sweep.stderr.log"
    for k, v in (("OUT", out), ("ERRLOG", errlog), ("SIZE", 256),
                 ("CONFIGS", "128,128,64 64,64,32"), ("RESUME", "0")):
        monkeypatch.setenv(k, str(v))
    on_cpu(tune_cuda, monkeypatch)
    assert tune_cuda.main() == 0
    said = capsys.readouterr().out
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["rung"], r["blocks"], r["size"], r["backend"], r["ok"], r["timing_valid"])
            for r in rows] == [("blocks=128,128,64", [128, 128, 64], 256, "cpu", True, True),
                               ("blocks=64,64,32", [64, 64, 32], 256, "cpu", True, True)]
    assert ">>> best configs:" in said and "failed" not in said.split(">>> best")[1]
    assert [line for line in errlog.read_text().splitlines() if line.startswith("===")] == [
        "=== blocks=128,128,64 ===", "=== blocks=64,64,32 ==="]
    # Both tools refuse to retune from a sweep that ran off the card.
    monkeypatch.setattr(sys, "argv", ["apply_sweep", str(out)])
    assert apply_sweep.main() == 1
    port = capsys.readouterr().out.splitlines()
    ref = subprocess.run([PY, os.path.join(REPO, "hack", "apply_sweep.py"), str(out)],
                         capture_output=True, text=True, timeout=60)
    assert ref.returncode == 1
    assert port[:2] == ref.stdout.splitlines()[:2] and port[1].endswith(" on cpu")
    assert port[2:] == ["sweep did not run on a card variant; not retuning the table"]
    assert ref.stdout.splitlines()[2:] == [
        "sweep did not run on a TPU generation; not retuning the table"]


def test_the_batch_ladder_runs_real_rungs(tmp_path, monkeypatch, capsys):
    out = tmp_path / "resnet_ladder.jsonl"
    for k, v in (("WORKLOAD", "resnet"), ("SIZE", "tiny"), ("BATCHES", "2 4"),
                 ("OUT", out), ("ERRLOG", tmp_path / "resnet_ladder.stderr.log")):
        monkeypatch.setenv(k, str(v))
    monkeypatch.delenv("RESUME", raising=False)
    on_cpu(batch_ladder, monkeypatch)
    assert batch_ladder.main() == 0
    said = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["rung"], r["batch"], r["ok"], r["model"]) for r in rows] == [
        ("batch=2", 2, True, "tiny"), ("batch=4", 4, True, "tiny")]
    summary = said[said.index(">>> ladder summary (throughput per rung):") + 1:]
    assert [line.split(":")[0] for line in summary] == ["  batch=2", "  batch=4"]
    assert all(f"{r['images_per_sec']}  mfu={r['mfu']}" in line for r, line in zip(rows, summary))


def test_the_ladder_summary_reads_the_llama_keys_and_failed_rungs(tmp_path):
    out = tmp_path / "llama_ladder.jsonl"
    out.write_text("\n".join([
        json.dumps({"ok": True, "batch": 1, "tokens_per_sec": 26.3, "mfu": 0.01,
                    "hbm_bw_util": 0.48, "prefill_tokens_per_sec": 3000.0, "rung": "batch=1"}),
        json.dumps({"ok": False, "workload": "llama", "error": "out of device memory: x",
                    "rung": "batch=512"}),
        "Killed"]) + "\n")
    assert batch_ladder.summary(str(out)) == [
        "  batch=1: 26.3  mfu=0.01  hbm_bw_util=0.48  prefill_tokens_per_sec=3000.0",
        "  batch=512: FAILED (out of device memory: x)"]


def test_the_smoke_turns_running_out_of_device_memory_into_one_failure_line(
        monkeypatch, capsys):
    import torch

    from tpu_cc_manager_torch.smoke import __main__ as smoke_main
    from tpu_cc_manager_torch.smoke import runner

    def oom(name, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(runner, "run_workload", oom)
    assert smoke_main.main(["--workload", "llama", "--batch", "512", "--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"ok": False, "workload": "llama",
                    "error": "out of device memory: CUDA out of memory. Tried to allocate "
                             "2.00 GiB"}

    def other(name, **kwargs):
        raise RuntimeError("a defect keeps its traceback")

    monkeypatch.setattr(runner, "run_workload", other)
    with pytest.raises(RuntimeError, match="keeps its traceback"):
        smoke_main.main(["--workload", "llama", "--device", "cpu"])


def artifact(path, generation, rows) -> str:
    """A sweep artifact of ``rows`` (blocks, tflops) on ``generation``, plus
    a refused rung and a crash tail."""
    lines = [json.dumps({"ok": True, "workload": "matmul", "backend": "cuda",
                         "generation": generation, "timing_valid": True, "tflops": tf,
                         "mfu": round(tf / 989, 4), "blocks": list(b), "size": 4096,
                         "rung": "blocks=" + ",".join(map(str, b))}) for b, tf in rows]
    lines.append(json.dumps({"ok": False, "workload": "matmul", "error": "refused",
                             "rung": "blocks=256,256,128"}))
    lines.append("Segmentation fault")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_apply_sweep_prints_the_winner_the_reference_prints(tmp_path):
    path = artifact(tmp_path / "pcie.jsonl", "h100-pcie",
                    [((256, 128, 64), 510.2), ((128, 256, 64), 521.7), ((128, 128, 64), 430.0)])
    said = []
    for tool in (os.path.join(REPO, "hack", "apply_sweep.py"),
                 os.path.join(REPO, "tpu_cc_manager_torch", "bench", "apply_sweep.py")):
        proc = subprocess.run([PY, tool, path], capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        said.append(proc.stdout)
    assert said[0] == said[1]
    assert said[1].splitlines() == [
        "rungs: 4 (3 ok)", "best: blocks=[128, 256, 64] 521.7 TF/s mfu=0.5275 on h100-pcie",
        f"DEFAULT_BLOCKS entry (evidence: {path}):", '    "h100-pcie": (128, 256, 64),']


def test_apply_sweep_writes_only_the_table_it_is_given(tmp_path, monkeypatch, capsys):
    repo_file = os.path.join(REPO, "tpu_cc_manager_torch", "ops", "matmul.py")
    with open(repo_file, "rb") as f:
        before = hashlib.sha256(f.read()).hexdigest()
    assert apply_sweep.MATMUL_PY == __import__("pathlib").Path(repo_file)
    copy = tmp_path / "matmul.py"
    shutil.copy(repo_file, copy)
    monkeypatch.setattr(apply_sweep, "MATMUL_PY", copy)

    def table() -> tuple[dict, dict]:
        spec = importlib.util.spec_from_file_location("matmul_copy", copy)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.DEFAULT_BLOCKS, mod.DEFAULT_BLOCKS_BY_ROWS

    def write(path) -> list[str]:
        monkeypatch.setattr(sys, "argv", ["apply_sweep", "--write", path])
        assert apply_sweep.main() == 0
        return capsys.readouterr().out.splitlines()

    pcie = artifact(tmp_path / "pcie.jsonl", "h100-pcie", [((128, 256, 64), 521.7)])
    assert write(pcie)[-1].startswith(f"wrote {copy}")
    blocks, by_rows = table()
    assert blocks == {"h100-pcie": (128, 256, 64), **matmul.DEFAULT_BLOCKS}
    assert list(blocks)[0] == "h100-pcie"  # a new variant goes to the top
    sxm = artifact(tmp_path / "sxm.jsonl", "h100-sxm", [((128, 128, 128), 600.0)])
    assert write(sxm)[-1].startswith(f"wrote {copy}")
    blocks, by_rows2 = table()
    assert blocks == {"h100-pcie": (128, 256, 64), "h100-sxm": (128, 128, 128)}
    assert by_rows == by_rows2 == matmul.DEFAULT_BLOCKS_BY_ROWS  # never written
    assert write(sxm)[-1] == "table already carries this entry; nothing to write"
    with open(repo_file, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == before
