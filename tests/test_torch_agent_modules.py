"""The port's copies of the agent's modules against the JAX modules.

Each module of the agent the port copied keeps the JAX module's public
surface (names, signatures, constants), and the same inputs give the same
outputs: label constants, retry backoff schedules, the metrics exposition
byte for byte, the intent journal's file bytes (each package replays the
other's file), and ``RestKube`` over HTTP against ``hack/mock_apiserver.py``.
Every copied line of code equals the JAX file's but the manager's device
seam (``ccmanager/node.py``), the serving harness's fake nodes and the
lint's baseline file and env table; a few lines of prose are reworded."""

import difflib
import importlib
import inspect
import io
import os
import random
import re
import sys
import threading
import time
import tokenize
from http.server import ThreadingHTTPServer

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "hack"))
import mock_apiserver  # noqa: E402

MODULES = [
    "version", "labels", "utils.locks", "utils.logging", "utils.retry", "obs",
    "obs.journal", "obs.trace", "utils.metrics", "kubeclient", "kubeclient.api",
    "kubeclient.rest", "kubeclient.fake", "drain", "drain.pause", "drain.state",
    "drain.handshake", "drain.evict", "ccmanager", "ccmanager.intent_journal",
    "ccmanager.slicecoord", "ccmanager.informer", "ccmanager.metrics_server",
    "ccmanager.multislice", "ccmanager.watchdog", "ccmanager.remediation",
    "ccmanager.manager", "ccmanager.cli",
    "obs.slo", "obs.flight", "obs.failslow", "faults", "faults.plan", "faults.kube",
    "drain.sim", "ccmanager.rollout_state", "ccmanager.rolling", "serve", "serve.server",
    "serve.driver", "serve.sweep", "serve.harness",
    "obs.fleet", "ccmanager.federation", "ctl", "lint", "lint.base", "lint.baseline",
    "lint.flow", "lint.crash", "lint.crashpoints", "lint.expo", "lint.fenced", "lint.journal",
    "lint.locks", "lint.surface", "lint.waits", "lint.__main__",
]
# The contract names of the device seam: the port's modules import
# ``ccmanager.node``'s views and ``GpuError`` in their place.
RENAMES = {"TpuCcBackend": "NodeBackend", "SliceTopology": "SliceView",
           "TpuChip": "ChipView", "TpuError": "GpuError", "FakeTpuBackend": "FakeGpuBackend"}
# Names the CLI takes from its device layer: present, typed by that layer.
DEVICE_LAYER = {"ccmanager.cli": {"load_backend"}}
# Constants the port sets to its own value: the lint's baseline is a file
# of the port's package, and its manifest the H100 DaemonSet.
OWN_VALUES = {"lint.baseline": {"BASELINE_FILE"}, "lint.surface": {"DAEMONSET_PATH"}}


def normalise(text: str) -> str:
    """A port source or signature in the JAX package's names."""
    text = re.sub(r"\btpu_cc_manager_torch\b", "tpu_cc_manager", text)
    text = re.sub(r"\bccmanager\.node\b", "tpudev.contract", text)
    text = re.sub(r"\bgpudev\b", "tpudev", text)
    for jax_name, port_name in RENAMES.items():
        text = re.sub(rf"\b{port_name}\b", jax_name, text)
    return re.sub(r" at 0x[0-9a-f]+", "", text)


def modules(name):
    return (importlib.import_module(f"tpu_cc_manager.{name}"),
            importlib.import_module(f"tpu_cc_manager_torch.{name}"))


def public_names(mod) -> list[str]:
    if hasattr(mod, "__path__"):  # a package: what it exports
        return list(getattr(mod, "__all__", []))
    return [n for n in vars(mod) if not n.startswith("_")]


def signature(obj) -> str | None:
    try:
        return normalise(str(inspect.signature(obj)))
    except (TypeError, ValueError):  # builtins and exception classes
        return None


def surface(obj) -> dict:
    """A name's comparable face: a callable's signature (a class's, and each
    of its public methods'), a plain constant's value, else its kind."""
    if inspect.ismodule(obj):
        return {"module": obj.__name__.rsplit(".", 1)[-1]}
    if inspect.isclass(obj):
        methods = {n: signature(v) for n, v in vars(obj).items()
                   if not n.startswith("_") and callable(v)}
        return {"class": signature(obj), "methods": methods}
    if callable(obj):
        return {"callable": signature(obj)}
    if isinstance(obj, str):  # paths of the package, as the seam diff reads them
        return {"value": normalise(obj)}
    if isinstance(obj, tuple):
        return {"value": normalise(repr(obj))}
    if isinstance(obj, (int, float, bool, frozenset, type(None))):
        return {"value": obj}
    if isinstance(obj, (dict, list, set)):
        return {"value": normalise(repr(obj))}
    return {"type": type(obj).__name__}


@pytest.mark.parametrize("name", MODULES)
def test_every_public_name_keeps_its_signature(name):
    jax_mod, port_mod = modules(name)
    for attr in public_names(jax_mod):
        port_attr = RENAMES.get(attr, attr)
        assert hasattr(port_mod, port_attr), f"{name}.{port_attr} missing"
        if attr in RENAMES or attr in DEVICE_LAYER.get(name, ()):
            continue
        if attr in OWN_VALUES.get(name, ()):
            assert type(getattr(port_mod, attr)) is type(getattr(jax_mod, attr)), attr
            continue
        assert surface(getattr(port_mod, port_attr)) == surface(getattr(jax_mod, attr)), attr


def test_the_contract_views_have_the_jax_fields():
    from tpu_cc_manager.tpudev import contract
    from tpu_cc_manager_torch.ccmanager import node

    for jax_cls, port_cls in ((contract.TpuChip, node.ChipView),
                              (contract.SliceTopology, node.SliceView)):
        assert signature(port_cls) == signature(jax_cls)
        assert surface(port_cls)["methods"] == surface(jax_cls)["methods"]
    jax_methods = {n for n in vars(contract.TpuCcBackend) if not n.startswith("_")}
    assert jax_methods <= set(vars(node.NodeBackend))


def test_label_constants_are_equal():
    jax_labels, port_labels = modules("labels")
    names = [n for n in public_names(jax_labels) if n.isupper()]
    assert len(names) >= 38
    assert {n: getattr(port_labels, n) for n in names} == \
        {n: getattr(jax_labels, n) for n in names}
    for value in ("on", "ppcie", "Slice", "x" * 80, "a/b c"):
        assert port_labels.canonical_mode(value) == jax_labels.canonical_mode(value)
        assert port_labels.label_safe(value) == jax_labels.label_safe(value)


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_backoff_schedules_are_equal(seed):
    jax_retry, port_retry = modules("utils.retry")

    def schedule(mod):
        slept = []
        policy = mod.RetryPolicy(max_attempts=6, base_delay_s=0.5, max_delay_s=4.0,
                                 rng=random.Random(seed), sleep=slept.append,
                                 metrics=mod._default_metrics())
        verdict = mod.Classification(transient=True, reason="io")

        def fail():
            raise OSError("down")

        with pytest.raises(OSError):
            policy.call(fail, op="probe", classify=lambda e: verdict)
        capped = [policy.delay_for(a, retry_after_s=3.0) for a in range(4)]
        return slept, capped, [policy.backoff_cap(a) for a in range(8)]

    assert schedule(port_retry) == schedule(jax_retry)


def call_every_recorder(registry) -> None:
    """The same observations, each recorder called with arguments built
    from its parameters' names."""
    values = {"mode": "on", "phase": "reset", "seconds": 1.25, "reason": "smoke-failed",
              "op": "patch", "name": "api", "state": "open", "tier": "probe-cmd",
              "strength": 3, "healthy": True, "quarantined": True, "step": "retry",
              "outcome": "ok", "count": 2, "reserved": 3, "spent": 1,
              "connected": False, "verb": "patch", "node": "gpu-node-0",
              "depth": 4, "inflight": 2, "util": 0.5, "in_progress": True,
              "rps": 12.5, "suspect": True, "deviation": 1.75, "verdict": "cleared",
              "window_s": 5.0, "p99_s": 0.25, "burn_rate": 1.5}
    for attr in sorted(dir(registry)):
        if not attr.startswith(("record_", "set_", "observe_")):
            continue
        fn = getattr(registry, attr)
        kwargs = {}
        for p in inspect.signature(fn).parameters.values():
            if p.default is not inspect.Parameter.empty:
                continue
            kwargs[p.name] = values[p.name]
        fn(**kwargs)
    reconcile = registry.start("on")
    for phase in ("drain", "stage", "reset", "wait", "attest", "smoke", "readmit"):
        with reconcile.phase(phase):
            pass
    reconcile.finish("ok")


def test_metrics_exposition_is_byte_equal(monkeypatch):
    """The same observations, with one clock stepping 0.25 s a read."""
    jax_metrics, port_metrics = modules("utils.metrics")
    texts = []
    for mod in (jax_metrics, port_metrics):
        ticks = iter(range(10**6))
        monkeypatch.setattr(time, "monotonic", lambda: 0.25 * next(ticks))
        registry = mod.MetricsRegistry()
        call_every_recorder(registry)
        texts.append(registry.render_prometheus())
    assert 'tpu_cc_phase_seconds_count{mode="on",phase="readmit"} 1' in texts[0]
    assert texts[1] == texts[0]


def write_journal(mod, state_dir):
    j = mod.IntentJournal.from_state_dir(str(state_dir))
    j.note_desired("on")
    txn = j.begin("transition", mode="on", chips=[0, 1, 2, 3])
    j.mark(txn, mod.PHASE_STAGED)
    j.mark(txn, mod.PHASE_RESET)
    j.defer_patch({"cloud.google.com/tpu-cc.mode.state": "on"})
    j.commit(txn)
    drain = j.begin("drain", paused=["device-plugin"])
    return j, drain


def test_intent_journals_are_byte_equal_and_replay_each_other(tmp_path, monkeypatch):
    jax_ij, port_ij = modules("ccmanager.intent_journal")
    monkeypatch.setattr(time, "time", lambda: 1700000000.125)
    blobs = {}
    for mod in (jax_ij, port_ij):
        write_journal(mod, tmp_path / mod.__name__)
        path = mod.IntentJournal.from_state_dir(str(tmp_path / mod.__name__)).path
        with open(path, "rb") as f:
            blobs[mod] = f.read()
    assert blobs[port_ij] == blobs[jax_ij] and blobs[jax_ij].count(b"\n") == 7
    for reader, writer in ((jax_ij, port_ij), (port_ij, jax_ij)):
        j = reader.IntentJournal.from_state_dir(str(tmp_path / writer.__name__))
        result = j.replay()
        assert result.truncated_bytes == 0 and len(result.records) == 7
        assert [i["kind"] for i in j.open_intents()] == ["drain"]
        assert j.last_desired_mode == "on"
        assert j.pending_patches() == {"cloud.google.com/tpu-cc.mode.state": "on"}


@pytest.fixture()
def two_apiservers():
    """Two fresh mock apiservers (hack/mock_apiserver.py), one per package."""
    servers = []
    for _ in range(2):
        state = mock_apiserver.MockState()
        state.add_node("rest-node-0")
        state.add_node("rest-node-1")
        srv = ThreadingHTTPServer(("127.0.0.1", 0), mock_apiserver.make_handler(state))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append((srv, state))
    yield servers
    for srv, _ in servers:
        srv.shutdown()
        srv.server_close()


def test_restkube_sees_the_same_nodes_and_patches(two_apiservers):
    from tpu_cc_manager.kubeclient.api import node_annotations, node_labels

    results = []
    for (srv, state), name in zip(two_apiservers, ("jax", "port")):
        mod = modules("kubeclient.rest")[name == "port"]
        kube = mod.RestKube(mod.ClusterConfig(server=f"http://127.0.0.1:{srv.server_port}"))
        kube.patch_node_labels("rest-node-0", {"cloud.google.com/tpu-cc.mode": "on",
                                               "google.com/tpu.deploy.device-plugin": "false"})
        kube.patch_node_annotations("rest-node-1", {"cloud.google.com/tpu-cc.note": "x"})
        kube.patch_node_labels("rest-node-0", {"cloud.google.com/tpu-cc.mode": None})
        node = kube.get_node("rest-node-0")
        listed = kube.list_nodes("google.com/tpu.deploy.device-plugin=true")
        pods = kube.list_pods("tpu-operator", label_selector="app=tpu-device-plugin")
        results.append((
            node_labels(node), node["metadata"]["resourceVersion"],
            [(n["metadata"]["name"], node_labels(n), node_annotations(n)) for n in listed],
            sorted(p["metadata"]["name"] for p in pods),
            {n: dict(v["metadata"].get("labels", {})) for n, v in state.nodes.items()},
            dict(state.request_counts),
        ))
    assert results[1] == results[0]
    labels, _, listed, pods, _, counts = results[0]
    assert "cloud.google.com/tpu-cc.mode" not in labels
    assert [n for n, _, _ in listed] == ["rest-node-1"]
    assert pods == ["tpu-device-plugin-rest-node-0", "tpu-device-plugin-rest-node-1"]
    assert counts["patch"] == 3


# The only lines of code (normalised) where the port's copies differ from
# the JAX modules: the device seam in manager.py and the serving harness's
# backend construction. Each is listed in CHANGES.md.
SEAM = {
    "ccmanager/manager.py": (
        ["                from tpu_cc_manager.tpudev.fake import FakeTpuBackend",
         "                allow_fake_quotes = isinstance(backend, FakeTpuBackend)"],
        ["                from tpu_cc_manager.tpudev.contract import is_fake_backend",
         "                allow_fake_quotes = is_fake_backend(backend)",
         # The H100's CC ready state, set after a verified quote: on the
         # idempotent re-attestation path, then on the apply path.
         "                    self.backend.set_gpus_ready()",
         "                    self.backend.set_gpus_ready()"]),
    # The serving harness's pool: one HGX-style fake node behind the
    # manager's NodeBackend where the JAX harness builds a two-chip v5p.
    "serve/harness.py": (
        ["        self.backends: dict[str, FakeTpuBackend] = {}",
         "            backend = FakeTpuBackend(",
         "                num_chips=2,",
         '                accelerator_type="v5p-8",',
         '                slice_id=f"serve-slice-{i}",',
         "            )"],
        ["from tpu_cc_manager.tpudev.contract import TpuCcBackend",
         "        self.backends: dict[str, TpuCcBackend] = {}",
         "            backend = TpuCcBackend(FakeTpuBackend(",
         '                node_id=f"serve-slice-{i}",',
         "            ))"]),
    # The port's lint: its baseline is a file of the port's package, and
    # an env name may stand in the port's env table (README.md) as well as
    # in docs/operations.md; neither JAX file is the port's to edit.
    "lint/baseline.py": (
        ['BASELINE_FILE = ".cclint-baseline.json"'],
        ['BASELINE_FILE = "tpu_cc_manager/lint/cclint-baseline.json"']),
    # Its manifest is the H100 DaemonSet (tpu_cc_manager_torch/deploy/).
    "lint/surface.py": (
        ['DAEMONSET_PATH = "deployments/manifests/daemonset.yaml"'],
        ['PORT_ENV_PATH = "README.md"',
         'PORT_ENV_HEADING = "### Environment of the port"',
         'DAEMONSET_PATH = "tpu_cc_manager/deploy/daemonset.yaml"',
         'def _port_env_table(text: str | None) -> str:',
         '    if text is None or PORT_ENV_HEADING not in text:',
         '        return ""',
         '    section = re.split(r"\\n#{1,3} ", text.split(PORT_ENV_HEADING, 1)[1])[0]',
         '    return "\\n".join(',
         '        line for line in section.splitlines() if line.startswith("| `CC_")',
         '    )',
         '        docs += _port_env_table(ctx.read_text(PORT_ENV_PATH))']),
}
# Lines of prose (docstrings, comments) the copies reword: a path on the
# author's machine and the numbers of the changes that added a feature,
# which a copy does not carry.
PROSE = {"ccmanager/remediation.py": 2, "ccmanager/multislice.py": 1,
         # The comment above each ready-state line.
         "ccmanager/manager.py": (0, 2),
         "ccmanager/rollout_state.py": 3, "ccmanager/rolling.py": 2, "serve/sweep.py": 1,
         "obs/fleet.py": 1, "ccmanager/federation.py": 2, "lint/__init__.py": 2,
         "lint/baseline.py": 1, "lint/fenced.py": 1, "lint/journal.py": 1, "lint/waits.py": 1,
         # The port's env table, described in the docstring and its reader's.
         "lint/surface.py": (1, 4)}
COPIES = ["ccmanager/watchdog.py", "ccmanager/remediation.py", "ccmanager/slicecoord.py",
          "ccmanager/multislice.py", "ccmanager/intent_journal.py", "ccmanager/informer.py",
          "ccmanager/metrics_server.py", "version.py", "labels.py", "utils/locks.py",
          "utils/logging.py", "utils/retry.py", "utils/metrics.py", "obs/journal.py",
          "obs/trace.py", "kubeclient/__init__.py", "kubeclient/api.py", "kubeclient/rest.py",
          "kubeclient/fake.py", "drain/__init__.py", "drain/pause.py", "drain/state.py",
          "drain/handshake.py", "drain/evict.py", "obs/__init__.py", "obs/slo.py",
          "obs/flight.py", "obs/failslow.py", "faults/__init__.py", "faults/plan.py",
          "faults/kube.py", "drain/sim.py", "ccmanager/rollout_state.py",
          "ccmanager/rolling.py", "serve/__init__.py", "serve/server.py", "serve/driver.py",
          "serve/sweep.py", "obs/fleet.py", "ccmanager/federation.py", "ctl.py",
          "lint/__init__.py", "lint/__main__.py", "lint/base.py", "lint/baseline.py",
          "lint/crash.py", "lint/crashpoints.py", "lint/expo.py", "lint/fenced.py",
          "lint/flow.py", "lint/journal.py", "lint/locks.py", "lint/surface.py", "lint/waits.py"]


def prose_lines(text: str) -> set[int]:
    """Indices of the lines that hold a comment or a triple-quoted string."""
    lines = set()
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.COMMENT or (
                tok.type == tokenize.STRING
                and tok.string.lstrip("rbuRBU").startswith(('"""', "'''"))):
            lines.update(range(tok.start[0] - 1, tok.end[0]))
    return lines


@pytest.mark.parametrize("rel", ["ccmanager/manager.py", "serve/harness.py"] + COPIES)
def test_the_copies_differ_from_the_jax_files_only_at_the_seam(rel):
    texts = []
    for package in ("tpu_cc_manager", "tpu_cc_manager_torch"):
        with open(os.path.join(REPO, package, rel), encoding="utf-8") as f:
            texts.append(normalise(f.read()))
    (jax_lines, port_lines), (jax_prose, port_prose) = (
        [t.splitlines() for t in texts], [prose_lines(t) for t in texts])
    code, prose = ([], []), [0, 0]
    matcher = difflib.SequenceMatcher(None, jax_lines, port_lines, autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        for side, (lines, marked, span) in enumerate(
                ((jax_lines, jax_prose, range(i1, i2)), (port_lines, port_prose, range(j1, j2)))):
            for i in span:
                if i in marked:
                    prose[side] += 1
                elif lines[i].strip():
                    code[side].append(lines[i])
    assert code == SEAM.get(rel, ([], []))
    want = PROSE.get(rel, 0)
    assert prose == (list(want) if isinstance(want, tuple) else [want] * 2)
