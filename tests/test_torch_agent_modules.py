"""The port's copies of the agent's modules against the JAX modules.

Each module of the agent the port copied keeps the JAX module's public
surface (names, signatures, constants), and the same inputs give the same
outputs: label constants, retry backoff schedules, the metrics exposition
byte for byte, the intent journal's file bytes (each package replays the
other's file), and ``RestKube`` over HTTP against ``hack/mock_apiserver.py``.
Every copied line of code equals the JAX file's but the manager's device
seam (``ccmanager/node.py``), the serving harness's fake nodes, the lint's
baseline file and env table, the node bench's seams (its copies of the
repository's ``bench.py``, ``bench_ab.py`` and ``hack/smoke_cache_bench.py``)
and the measurement tools' (``hack/apply_sweep.py``, ``hack/serve_bench.py``
and ``hack/scale_bench.py``); a few lines of prose are reworded."""

import ast
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
           "TpuChip": "ChipView", "TpuError": "GpuError", "FakeTpuBackend": "FakeGpuBackend",
           # The node bench's usable flag and preflight name the card.
           "tpu_usable": "cuda_usable", "_tpu_preflight": "_cuda_preflight"}
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
# The node bench's copies: a torch matmul preflight on the card; no CPU
# re-run after a failed smoke; the port's node backend over 4 fake GPUs;
# the repository root as the children's directory; retry.wait for
# time.sleep (the port's lint); the cache bench on a copy of the package;
# the spare held to its pool-mate; the multihost scenario's two hosts, each
# a node of 4 fake GPUs; and what every verify smoke ran, reported.
SEAM.update({
    'bench/bench.py': (
        ['        "import jax, jax.numpy as jnp;"',
         '        "print(float(jax.jit(lambda x: (x @ x).sum())(jnp.ones((128, 128)))))"',
         '                f"# tpu preflight attempt {attempt} failed; retrying in "',
         '            time.sleep(backoff_s)',
         '        cwd=os.path.dirname(os.path.abspath(__file__)),',
         '        "tpu" if any(s.get("backend") == "tpu" for s in smokes)',
         '        from tpu_cc_manager.smoke.runner import SmokeError',
         '        try:',
         '            result = _smoke_subprocess(',
         '                workload, timeout_s=240.0, force_cpu=not tpu_usable',
         '            )',
         '        except SmokeError:',
         '            result = _smoke_subprocess(workload, timeout_s=240.0, force_cpu=True)',
         '                cwd=os.path.dirname(os.path.abspath(__file__)),',
         '            from tpu_cc_manager.smoke.runner import SmokeError',
         '            try:',
         '                result = self._inner.release_and_result()',
         '            except SmokeError:',
         '                result = _smoke_subprocess(',
         '                    self._workload, timeout_s=240.0, force_cpu=True',
         '                )',
         '    backend = FakeTpuBackend(',
         '        num_chips=4,',
         '        accelerator_type="v5p-8",',
         '    )',
         '        backend = FakeTpuBackend(',
         '            num_chips=4,',
         '            accelerator_type="v5p-8",',
         '            slice_id=f"bench-spare-slice-{i}",',
         '        )',
         '            smoke_runner=lambda w: _smoke_subprocess(',
         '                w, timeout_s=240.0, force_cpu=not tpu_usable',
         '            ),',
         '        backend = FakeTpuBackend(',
         '            num_chips=4, accelerator_type="v5p-32",',
         '        )',
         '        backend=FakeTpuBackend(),',
         '    cache_dir = tempfile.mkdtemp(prefix="tpu-cc-smoke-cache-")',
         '    extra_env = {',
         '        "JAX_COMPILATION_CACHE_DIR": cache_dir,',
         '        "TPU_CC_CACHE_DIR": cache_dir,',
         '        "TPU_CC_NO_COMPILATION_CACHE": "",',
         '        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",',
         '        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "-1",',
         '    }',
         '            extra_env=extra_env,',
         '        result["cache_entries"] = len(os.listdir(cache_dir))',
         '            extra_env=extra_env,',
         '        shutil.rmtree(cache_dir, ignore_errors=True)',
         '    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))',
         '    from tpu_cc_manager.utils.tpu_info import tpu_generation',
         '    chip_generation = smoke.get("generation") or tpu_generation()',
         '    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))',
         '    reference = 31.45',
         '        result["ok"] and value is not None and value < reference'],
        ['_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))',
         '    from tpu_cc_manager.utils import retry',
         '        "import torch; x = torch.ones((128, 128), device=\'cuda\');"',
         '        "print(float((x @ x).sum()))"',
         '                f"# cuda preflight attempt {attempt} failed; retrying in "',
         '            retry.wait(backoff_s)',
         '    cwd: str | None = None,',
         '        cwd=cwd or _REPO_ROOT,',
         '        "cuda" if any(s.get("backend") == "cuda" for s in smokes)',
         '    from tpu_cc_manager.tpudev.contract import TpuCcBackend',
         '        result = _smoke_subprocess(',
         '            workload, timeout_s=240.0, force_cpu=not tpu_usable',
         '        )',
         '                cwd=_REPO_ROOT,',
         '            result = self._inner.release_and_result()',
         '    backend = TpuCcBackend(FakeTpuBackend(',
         '        num_gpus=4,',
         '    ))',
         '    from tpu_cc_manager.tpudev.contract import TpuCcBackend',
         '    smokes: list[dict] = []',
         '    def timed_smoke(workload: str) -> dict:',
         '        t0 = time.monotonic()',
         '        result = _smoke_subprocess(',
         '            workload, timeout_s=240.0, force_cpu=not tpu_usable',
         '        )',
         '        smokes.append({"start": t0, "end": time.monotonic(), **smoke_kernels(result)})',
         '        return result',
         '        backend = TpuCcBackend(FakeTpuBackend(',
         '            num_gpus=4,',
         '            node_id=f"bench-spare-slice-{i}",',
         '        ))',
         '            smoke_runner=timed_smoke,',
         '            "smokes": smokes,',
         '            "smoke_windows_overlap": windows_overlap(smokes),',
         '    from tpu_cc_manager.tpudev.contract import TpuCcBackend',
         '        backend = TpuCcBackend(FakeTpuBackend(',
         '            num_gpus=4, node_id=name,',
         '        ))',
         '    from tpu_cc_manager.tpudev.contract import TpuCcBackend',
         '    from tpu_cc_manager.utils import retry',
         '        backend=TpuCcBackend(FakeTpuBackend()),',
         '    root = tempfile.mkdtemp(prefix="tpu-cc-smoke-cache-")',
         '    tree, tmp = os.path.join(root, "tree"), os.path.join(root, "tmp")',
         '    shutil.copytree(',
         '        os.path.join(_REPO_ROOT, "tpu_cc_manager"),',
         '        os.path.join(tree, "tpu_cc_manager"),',
         '        ignore=shutil.ignore_patterns("__pycache__"),',
         '    )',
         '    os.mkdir(tmp)',
         '    cache_dir = os.path.join(tree, "build", "torch_kernels")',
         '    extra_env = {"TPU_CC_CACHE_DIR": "", "TMPDIR": tmp}',
         '    def libraries() -> dict:',
         '        found = {}',
         '        for dirpath, _dirs, files in os.walk(root):',
         '            for f in files:',
         '                if f.endswith(".so"):',
         '                    path = os.path.join(dirpath, f)',
         '                    found[path] = os.stat(path).st_mtime_ns',
         '        return found',
         '            extra_env=extra_env, cwd=tree,',
         '        after_cold = libraries()',
         '        result["cache_entries"] = sum(',
         '            os.path.dirname(p) == cache_dir for p in after_cold',
         '        )',
         '            extra_env=extra_env, cwd=tree,',
         '        after_warm = libraries()',
         '        result["warm_built"] = sum(',
         '            after_cold.get(p) != mtime for p, mtime in after_warm.items()',
         '        )',
         '        result["elsewhere"] = sorted(',
         '            os.path.relpath(p, root) for p in after_warm',
         '            if os.path.dirname(p) != cache_dir',
         '        )',
         '        result["smokes"] = [smoke_kernels(cold), smoke_kernels(warm)]',
         '            and result["warm_built"] == 0 and not result["elsewhere"]',
         '        shutil.rmtree(root, ignore_errors=True)',
         'def smoke_kernels(smoke: dict) -> dict:',
         '    return {',
         '        k: smoke.get(k)',
         '        for k in ("backend", "kernel", "generation", "size", "devices", "blocks",',
         '                  "kernel_launches", "kernel_launches_by_variant")',
         '    }',
         'def windows_overlap(smokes: list[dict]) -> bool:',
         '    spans = sorted((s["start"], s["end"]) for s in smokes)',
         '    return any(b[0] < a[1] for a, b in zip(spans, spans[1:]))',
         'def preflight_failed(metric: str) -> int:',
         '    print(json.dumps({',
         '        "metric": metric,',
         '        "ok": False,',
         '        "error": "cuda preflight failed: no torch matmul on cuda:0 in a "',
         '                 "child process succeeded",',
         '    }))',
         '    return 1',
         '    sys.path.insert(0, _REPO_ROOT)',
         '    if not tpu_usable:',
         '        return preflight_failed("node_drain_cc_on_ready_sec")',
         '    from tpu_cc_manager.utils.gpu_info import gpu_variant',
         '    chip_generation = smoke.get("generation") or gpu_variant()',
         '        "smoke_kernels": [',
         '            smoke_kernels(r["smoke"]) for r in [control] + realistic_runs',
         '        ],',
         '    sys.path.insert(0, _REPO_ROOT)',
         '    if not tpu_usable:',
         '        return preflight_failed("spare_prestage_flip_sec")',
         '    reference = spare.get("full_path_wall_s")',
         '        result["ok"] and value is not None and reference is not None',
         '        and value < reference']),
    'bench/bench_ab.py': (
        ['        cwd=os.path.dirname(os.path.abspath(__file__)),',
         '        help="pin the smokes to CPU (CI harness mode)",',
         '        help="llama config for the A/B (e.g. llama3.2-3b — the largest "',
         '        "single-chip v5e fit; default: the smoke\'s backend default)",',
         '    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))',
         '    backend = FakeTpuBackend(',
         '        num_chips=4, accelerator_type="v5p-8", initial_mode=MODE_ON',
         '    )'],
        ['_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))',
         '        cwd=_REPO_ROOT,',
         '        help="pin the smokes to the CPU (CI harness mode); without it they "',
         '        "run on the card and a smoke that fails there is an error",',
         '        help="llama config for the A/B (one of the port smoke\'s --size "',
         '        "names, e.g. llama3.2-3b; default: the smoke\'s backend default)",',
         '    sys.path.insert(0, _REPO_ROOT)',
         '    from tpu_cc_manager.tpudev.contract import TpuCcBackend',
         '    backend = TpuCcBackend(FakeTpuBackend(',
         '        num_gpus=4, initial_mode=MODE_ON',
         '    ))',
         '    from tpu_cc_manager.bench.bench import smoke_kernels as kernels_of',
         '    smoke_kernels: list[dict] = []',
         '                    smoke_kernels.append(',
         '                        {"workload": w, "mode": mode, **kernels_of(result)})',
         '    result["smoke_kernels"] = smoke_kernels']),
    'bench/smoke_cache_bench.py': (
        ['import os',
         '    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))',
         '    sys.path.insert(0, repo_root)'],
        ['    from tpu_cc_manager.bench import bench',
         '    if not tpu_usable:',
         '        return bench.preflight_failed("smoke_cache_cold_warm_s")']),
})
PROSE.update({'bench/bench.py': (85, 116), 'bench/bench_ab.py': (12, 25), 'bench/smoke_cache_bench.py': (12, 14)})
# The measurement tools' copies: the port's K1 table three directories
# up, and texts that name the card (apply_sweep); the repository root,
# and a calibration smoke that fails failing the bench (serve_bench); the
# repository root, the mock apiserver from its hack/, and torch_-prefixed
# default artifacts (scale_bench). Each seam line is commented, and each
# copy's docstring says what it changes; the prose also drops the numbers
# of the issues that asked for a feature.
SEAM.update({
    'bench/apply_sweep.py': (
        ['MATMUL_PY = Path(__file__).resolve().parent.parent / (',
         '    parser.add_argument("sweep", help="pallas sweep JSONL artifact")',
         '        print("sweep did not run on a TPU generation; not retuning the table")'],
        ['MATMUL_PY = Path(__file__).resolve().parent.parent.parent / (',
         '    parser.add_argument("sweep", help="cuda sweep JSONL artifact")',
         '        print("sweep did not run on a card variant; not retuning the table")']),
    'bench/serve_bench.py': (
        ['    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))',
         '                        "the knee (the ISSUE bar: 80%%)")',
         '        from tpu_cc_manager.smoke.runner import run_workload_subprocess',
         '        smoke = run_workload_subprocess(',
         '            "llama", timeout_s=600.0, cwd=repo_root,',
         '        )'],
        ['    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))',
         '                        "the knee (the acceptance bar: 80%%)")',
         '        from tpu_cc_manager.smoke.runner import SmokeError, run_workload_subprocess',
         '        try:',
         '            smoke = run_workload_subprocess(',
         '                "llama", timeout_s=600.0, cwd=repo_root,',
         '            )',
         '        except SmokeError as e:',
         '            smoke = {"ok": False, "error": str(e)}',
         '        if not smoke.get("ok") or not smoke.get("ms_per_token"):',
         '            result = {',
         '                "metric": "serve_bench_calibration",',
         '                "ok": False,',
         '                "error": "calibration smoke failed: "',
         '                + str(smoke.get("error") or "no ms_per_token in its result"),',
         '                "calibration": calibration,',
         '            }',
         '            line = json.dumps(result)',
         '            print(line)',
         '            if args.out:',
         '                with open(args.out, "w", encoding="utf-8") as f:',
         '                    f.write(line + "\\n")',
         '            return 1']),
    'bench/scale_bench.py': (
        ['sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))',
         '    sys.path.insert(',
         '        0, os.path.join(os.path.dirname(os.path.abspath(__file__)))',
         '    )',
         '    path = os.path.join(',
         '        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),',
         '        "SCALE_r02.json",',
         '    )',
         '        "wire); defaults to the 1k-node fleet and SCALE_r02.json",',
         '        "flight files (obs/fleet.py); defaults to FLEET_r01.json",',
         '        "nodes, 10 regions, SCALE_r03.json",',
         '        "regions, SCALE_r04.json",',
         '        out = args.out or "FLEET_r01.json"',
         '        out = args.out or ("SCALE_r04.json" if blackout else "SCALE_r03.json")',
         '        args.out = "SCALE_r02.json" if args.apiserver else "SCALE_r01.json"'],
        ['_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))',
         'sys.path.insert(0, _REPO_ROOT)',
         '    sys.path.insert(0, os.path.join(_REPO_ROOT, "hack"))',
         '    path = os.path.join(_REPO_ROOT, "SCALE_r02.json")',
         '        "wire); defaults to the 1k-node fleet and torch_SCALE_r02.json",',
         '        "flight files (obs/fleet.py); defaults to torch_FLEET_r01.json",',
         '        "nodes, 10 regions, torch_SCALE_r03.json",',
         '        "regions, torch_SCALE_r04.json",',
         '        out = args.out or "torch_FLEET_r01.json"',
         '        out = args.out or ("torch_SCALE_r04.json" if blackout else "torch_SCALE_r03.json")',
         '        args.out = "torch_SCALE_r02.json" if args.apiserver else "torch_SCALE_r01.json"']),
})
PROSE.update({'bench/apply_sweep.py': (11, 22), 'bench/serve_bench.py': (1, 15),
              'bench/scale_bench.py': (9, 30)})
# The fleet gateway's server: the repository root three directories up,
# and its usage lines run as the port's module.
SEAM.update({
    'bench/obs_gateway.py': (
        ['sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))'],
        ['sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname('
         'os.path.abspath(__file__)))))']),
})
PROSE.update({'bench/obs_gateway.py': (3, 4)})
# The port's compute-path regions: the model's and the train step's
# profiler ranges, beside the control plane's spans, and the paragraph of
# the module docstring and the function docstring that describe them.
SEAM.update({
    'obs/trace.py': (
        [],
        ['import sys',
         '_NO_REGION = contextlib.nullcontext()',
         'def region(name: str):',
         '    profiler = sys.modules.get("torch.autograd.profiler")',
         '    if profiler is None or not profiler._is_profiler_enabled:',
         '        return _NO_REGION',
         '    return profiler.record_function(name)']),
})
PROSE.update({'obs/trace.py': (0, 18)})
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


# The node bench's copies and the repository files they copy (the others
# copy ``tpu_cc_manager/<rel>``), and the top-level functions of a JAX
# file that its copy leaves out: none, the bench's multihost scenario runs
# over two fake H100 hosts of one slice.
JAX_FILES = {"bench/bench.py": "bench.py", "bench/bench_ab.py": "bench_ab.py",
             "bench/smoke_cache_bench.py": "hack/smoke_cache_bench.py",
             "bench/apply_sweep.py": "hack/apply_sweep.py",
             "bench/serve_bench.py": "hack/serve_bench.py",
             "bench/scale_bench.py": "hack/scale_bench.py",
             "bench/obs_gateway.py": "hack/obs_gateway.py"}
LEFT_OUT = {"bench/bench.py": ()}


def without_functions(text: str, names: tuple[str, ...]) -> str:
    """``text`` less the lines of its top-level functions ``names``."""
    lines = text.splitlines()
    drop = set()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            drop.update(range(node.lineno - 1, node.end_lineno))
    assert len({n.name for n in ast.parse(text).body if isinstance(n, ast.FunctionDef)}
               & set(names)) == len(names)
    return "\n".join(line for i, line in enumerate(lines) if i not in drop) + "\n"


def prose_lines(text: str) -> set[int]:
    """Indices of the lines that hold a comment or a triple-quoted string."""
    lines = set()
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.COMMENT or (
                tok.type == tokenize.STRING
                and tok.string.lstrip("rbuRBU").startswith(('"""', "'''"))):
            lines.update(range(tok.start[0] - 1, tok.end[0]))
    return lines


@pytest.mark.parametrize("rel", ["ccmanager/manager.py", "serve/harness.py"] + COPIES
                         + list(JAX_FILES))
def test_the_copies_differ_from_the_jax_files_only_at_the_seam(rel):
    texts = []
    for path in (JAX_FILES.get(rel, f"tpu_cc_manager/{rel}"), f"tpu_cc_manager_torch/{rel}"):
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            texts.append(normalise(f.read()))
    texts[0] = without_functions(texts[0], LEFT_OUT.get(rel, ()))
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
