"""cclint (``lint/``) on the port: the cases of ``tests/test_cclint.py`` run
through ``test_torch_fleet_sides.port_suite``. The port's lint scans
``tpu_cc_manager_torch/``, so the suite's fixture paths under
``tpu_cc_manager/`` are read as the port's (``paths=True``); the whole-tree
case holds the port to its own baseline,
``tpu_cc_manager_torch/lint/cclint-baseline.json``. Two cases of the port's
own follow: what its env table documents, and what its baseline may
grandfather."""

import json
import pathlib

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_cclint", paths=True)


def test_the_port_env_table_documents_only_its_own_rows(tmp_path):
    """An env name is documented by a row of the port's env table (the
    README section under ``PORT_ENV_HEADING``), not by a mention elsewhere
    in the README."""
    files = {
        "tpu_cc_manager_torch/mod.py": (
            "import os\n"
            'A = os.environ.get("CC_IN_TABLE", "")\n'
            'B = os.environ.get("CC_IN_PROSE", "")\n'
            'C = os.environ.get("CC_IN_DOCS", "")\n'),
        "docs/operations.md": "| `CC_IN_DOCS` | x | documented |\n",
        "README.md": (
            "# Project\n\nSet `CC_IN_PROSE` to taste.\n\n"
            f"{surface.PORT_ENV_HEADING}\n\n| Variable | Default | Read by |\n|---|---|---|\n"
            "| `CC_IN_TABLE` | on | mod.py |\n\n## Next section\n\n| `CC_IN_PROSE` | x | y |\n"),
    }
    findings = surface.check(ctx_of(tmp_path, files))
    assert sorted(f.detail for f in findings if f.symbol == "env-undocumented") == \
        ["CC_IN_PROSE"]


def test_the_port_baseline_grandfathers_only_the_fake_waits_and_the_jax_manifest():
    entries = json.loads((pathlib.Path(REPO) / baseline_mod.BASELINE_FILE).read_text())["entries"]
    kinds = sorted((e["fingerprint"].split(":")[0], e["fingerprint"].split(":")[1])
                   for e in entries)
    # The JAX manifest's seven env-unread entries went with the H100
    # manifest (tpu_cc_manager_torch/deploy/daemonset.yaml), which sets no
    # env the port does not read.
    assert kinds == [("waits", "tpu_cc_manager_torch/gpudev/fake.py")] * 3
    assert all(e["reason"] and not e["reason"].startswith("TODO") for e in entries)
