"""The check of loaded modules compares whole top-level names: the JAX
package and JAX fail a run, the port (whose name begins with the JAX
package's) passes; and nothing the benchmark or the port loads is JAX."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.parametrize("names, found", [
    (["tpu_cc_manager_torch", "tpu_cc_manager_torch.ops.flash_attention", "numpy"], []),
    (["tpu_cc_manager.ops.flash_attention"], ["tpu_cc_manager"]),
    (["tpu_cc_manager"], ["tpu_cc_manager"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "tpu_cc_managers"], []),
])
def test_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_that_loaded_the_jax_package_prints_no_result(monkeypatch, capsys):
    import io

    import torch
    from conftest import tiny_cell

    class Idle:
        def __init__(self, *_):
            pass

        def setup(self):
            pass

        def window(self, seconds):
            return {"train_tokens_per_s": 1.0}, 1

        def release(self):
            pass

        def check(self):
            return [("loss_gap", 0.0), ("grad_gap", 0.0), ("change_gap", 0.0)], 0

    monkeypatch.setitem(sys.modules, "tpu_cc_manager.fake", object())
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(tiny_cell("smollm2-1.7b.train-16x512"), 1, 0.1, False, torch.device("cpu"),
                     0.0, out=out, err=err, driver_cls=Idle)
    assert rc != 0 and out.getvalue() == "" and "tpu_cc_manager" in err.getvalue()


def test_the_reference_imports_nothing_of_the_program():
    source = (harness.HERE / "reference" / "llama.py").read_text()
    imported = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            imported |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").partition(".")[0])
    assert imported <= {"__future__", "contextlib", "math", "torch", "benchmark"}
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.llama; "
            "print(sorted({m.partition('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpu_cc_manager', 'tpu_cc_manager_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_port_and_the_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.harness as h; "
            "import benchmark.drivers.train, benchmark.drivers.prefill, benchmark.devtrace; "
            "import tpu_cc_manager_torch.parallel.train, tpu_cc_manager_torch.models.llama; "
            "print(h.forbidden_modules(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_a_directory_without_the_port_fails(tmp_path):
    import shutil

    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "traces"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "smollm2-1.7b.train-16x512", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
