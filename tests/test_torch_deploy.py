"""The H100 DaemonSet and image of the port (``tpu_cc_manager_torch/deploy/``).

The manifest's env against what the port reads, its RBAC against ``ctl
rbac-check``'s verbs and the JAX manifest's, the Dockerfile's stages, the
line readers of ``deploy/__init__.py`` against a YAML parser, the lint over
the new manifest, and the agent started as its container starts it (the
image's entrypoint and env, the manifest's env, hostPaths under a temp
directory) against the mock apiserver: one flip to on with the fake device
layer, the verify smoke's K1 on the CPU."""

import ast
import json
import os
import pathlib
import signal
import subprocess
import sys
import types

import pytest
import yaml

from tpu_cc_manager_torch import deploy
from tpu_cc_manager_torch.ccmanager import localrig
from tpu_cc_manager_torch.ctl import cmd_rbac_check
from tpu_cc_manager_torch.labels import (
    CC_MODE_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    QUARANTINE_TAINT_KEY,
)
from tpu_cc_manager_torch.lint import surface
from tpu_cc_manager_torch.ops import _build
from tpu_cc_manager_torch.utils.launch import free_port

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "tpu_cc_manager_torch"
JAX_MANIFEST = REPO / "deployments" / "manifests" / "daemonset.yaml"
# The JAX DaemonSet's TPU-runtime env, which no port module reads.
TPU_RUNTIME_ENV = {"CC_HOST_ROOT", "CC_RUNTIME_SHOW_CMD", "CC_GOOGLE_JWKS_FILE",
                   "CC_JWKS_CACHE_FILE", "CC_RUNTIME_HEALTH_PORT", "CC_RUNTIME_ENV_FILE",
                   "CC_RUNTIME_MEASURE_PATHS"}
# Read by the NVIDIA container runtime, not by the agent.
CONTAINER_RUNTIME_ENV = {"NVIDIA_VISIBLE_DEVICES", "NVIDIA_DRIVER_CAPABILITIES"}
FLIP_S = 90  # one flip on the CPU (the smoke child imports torch)


def docs(path):
    return list(yaml.safe_load_all(pathlib.Path(path).read_text()))


def of_kind(documents, kind):
    return next(d for d in documents if d and d["kind"] == kind)


def container(documents):
    return of_kind(documents, "DaemonSet")["spec"]["template"]["spec"]["containers"][0]


def env_reads() -> set[str]:
    """Every env name the port's package reads: ``os.environ.get``,
    ``os.getenv``, ``os.environ[...]`` with a literal, and ``*_ENV``
    constants (the lint's idiom, for every name)."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                name = surface._env_name_of(node)
                if name:
                    names.add(name)
            elif (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute)
                  and node.value.attr == "environ" and isinstance(node.slice, ast.Constant)):
                names.add(node.slice.value)
            elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Name)
                  and node.targets[0].id.endswith("_ENV")
                  and isinstance(node.value, ast.Constant)):
                names.add(node.value.value)
    return names


def test_the_line_reader_reads_what_a_yaml_parser_reads():
    text = deploy.MANIFEST.read_text()
    ctr = container(docs(deploy.MANIFEST))
    assert deploy.env(text) == {e["name"]: e.get("value") for e in ctr["env"]}
    assert deploy.mounts(text) == {m["mountPath"]: m["name"] for m in ctr["volumeMounts"]}
    # And the lint's own reader sees the same CC_* names.
    seen = [m.group(1) for line in text.splitlines()
            if (m := surface._DAEMONSET_ENV_RE.search(line))]
    assert seen == [n for n in deploy.env(text) if n.startswith("CC_")]


def test_every_env_the_manifest_sets_is_read_by_the_port():
    env = deploy.env(deploy.MANIFEST.read_text())
    unread = set(env) - env_reads() - CONTAINER_RUNTIME_ENV
    assert not unread, f"the manifest sets {sorted(unread)}, which nothing in the port reads"
    # What the CLI requires, and the device layer the DaemonSet is for.
    assert env["NODE_NAME"] is None and env["GPU_CC_BACKEND"] == "h100"
    assert env["CC_SMOKE_DEVICE"] == "cuda" and env["CC_SMOKE_WORKLOAD"] == "matmul"
    assert env["NVIDIA_VISIBLE_DEVICES"] == "all"
    for name in ("CC_GPU_ADMIN_TOOLS_PATH", "CC_NVIDIA_ROOT_CERT_FILE", "TPU_CC_CACHE_DIR"):
        assert env[name].startswith("/")


def test_the_manifest_sets_the_jax_manifests_env_the_port_reads():
    jax = {e["name"]: e.get("value") for e in container(docs(JAX_MANIFEST))["env"]}
    env = deploy.env(deploy.MANIFEST.read_text())
    want = {n for n in jax if n in env_reads()} - TPU_RUNTIME_ENV
    assert want <= set(env), sorted(want - set(env))
    assert TPU_RUNTIME_ENV.isdisjoint(env)
    for name in want - {"NODE_NAME"}:
        assert env[name] == jax[name], name


def test_the_cluster_role_grants_exactly_the_rbac_checks_verbs():
    asked = []
    api = types.SimpleNamespace(self_subject_access_review=lambda verb, resource, namespace:
                                asked.append((resource, verb)) or True)
    assert cmd_rbac_check(api, types.SimpleNamespace(namespace="tpu-operator")) == 0
    documents = docs(deploy.MANIFEST)
    granted = {(resource, verb) for rule in of_kind(documents, "ClusterRole")["rules"]
               for resource in rule["resources"] for verb in rule["verbs"]}
    assert granted == set(asked)
    jax = docs(JAX_MANIFEST)
    for kind in ("ServiceAccount", "ClusterRole", "ClusterRoleBinding"):
        assert of_kind(documents, kind) == of_kind(jax, kind), kind


def test_the_daemonset_runs_privileged_as_root_on_gpu_nodes_without_a_gpu_request():
    documents = docs(deploy.MANIFEST)
    pod = of_kind(documents, "DaemonSet")["spec"]["template"]["spec"]
    ctr = container(documents)
    assert pod["nodeSelector"] == {"nvidia.com/gpu.present": "true"}
    assert pod["runtimeClassName"] == "nvidia"
    keys = {t["key"] for t in pod["tolerations"]}
    assert keys == {"nvidia.com/gpu", QUARANTINE_TAINT_KEY}
    assert ctr["securityContext"] == {"privileged": True, "runAsUser": 0}
    assert "resources" not in ctr
    assert of_kind(documents, "DaemonSet")["metadata"]["namespace"] == "tpu-operator"
    # The readiness file the preStop hook removes is the one the image sets.
    hook = ctr["lifecycle"]["preStop"]["exec"]["command"]
    image = deploy.image_env(deploy.DOCKERFILE.read_text())
    assert hook == ["/bin/rm", "-f", image["CC_READINESS_FILE"]]
    assert ctr["livenessProbe"]["httpGet"] == {"path": "/healthz", "port": "metrics"}
    port = next(p["containerPort"] for p in ctr["ports"] if p["name"] == "metrics")
    assert str(port) == deploy.env(deploy.MANIFEST.read_text())["CC_METRICS_PORT"]
    mounted = set(deploy.mounts(deploy.MANIFEST.read_text()))
    assert {"/var/lib/tpu-cc-manager", "/dev", "/sys",
            os.path.dirname(image["CC_READINESS_FILE"])} <= mounted
    env = deploy.env(deploy.MANIFEST.read_text())
    for name in ("CC_GPU_ADMIN_TOOLS_PATH", "CC_STATE_DIR", "TPU_CC_CACHE_DIR"):
        assert any(env[name].startswith(m) for m in mounted), name
    assert os.path.dirname(env["CC_NVIDIA_ROOT_CERT_FILE"]) in mounted


def test_the_dockerfile_copies_the_port_alone_and_prebuilds_its_kernels():
    text = deploy.DOCKERFILE.read_text()
    stages = [stage for stage, word, _ in deploy.instructions(text) if word == "FROM"]
    assert stages == ["kernels", "rmbuild", "runtime"]
    for _, origin, sources, _ in deploy.copies(text):
        if origin is None:
            for source in sources:
                assert (REPO / source).exists(), source
    copied = [s for _, origin, sources, _ in deploy.copies(text) if origin is None
              for s in sources]
    assert "tpu_cc_manager" not in copied and "native/rmutil" in copied
    lowered = text.lower()
    for stage in ("kernels", "runtime"):
        for command in deploy.runs(text, stage):
            assert "jax" not in command.lower(), command
    assert "jax[" not in lowered and "flax" not in lowered
    froms = {stage: args for stage, word, args in deploy.instructions(text) if word == "FROM"}
    assert "devel" in froms["kernels"] and "devel" not in froms["runtime"]
    assert deploy.entrypoint(text) == ["python", "-m", "tpu_cc_manager_torch"]
    # The prebuilt libraries land where the runtime's loader looks: the
    # build directory beside the installed package (ops/_build.py BUILD_DIR).
    package = deploy.package_dir(text)
    assert deploy.prebuild_command(text)[:3] == ["python", "-m",
                                                 "tpu_cc_manager_torch.ops._build"]
    assert deploy.prebuild_dir(text) == os.path.join(os.path.dirname(package), "build",
                                                     "torch_kernels")
    assert _build.BUILD_DIR == PACKAGE.parent / "build" / "torch_kernels"
    # The runtime gets the venv and the app (package and libraries) from the
    # kernels stage, and the static rm.
    runtime = [(origin, sources) for stage, origin, sources, _ in deploy.copies(text)
               if stage == "runtime"]
    assert runtime == [("kernels", ["/opt/venv"]), ("kernels", [os.path.dirname(package)]),
                       ("rmbuild", ["/src/rmutil/rm"])]


def test_the_lint_reads_the_h100_manifest_clean():
    assert surface.DAEMONSET_PATH == "tpu_cc_manager_torch/deploy/daemonset.yaml"
    baseline = json.loads((PACKAGE / "lint" / "cclint-baseline.json").read_text())
    assert not [e for e in baseline["entries"] if ":env-unread:" in e["fingerprint"]]
    proc = subprocess.run([sys.executable, "-m", "tpu_cc_manager_torch.lint"],
                          capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "cclint: 0 new, 3 grandfathered, 0 stale baseline entries" in proc.stdout


def test_container_launch_maps_the_containers_paths(tmp_path, monkeypatch):
    launch = deploy.container_launch(tmp_path / "host", REPO, "node-a")
    env, paths = launch["env"], launch["paths"]
    assert launch["cmd"] == [sys.executable, "-m", "tpu_cc_manager_torch"]
    assert launch["cwd"] == str(REPO) and env["PYTHONPATH"] == str(REPO)
    assert env["NODE_NAME"] == "node-a" and env["GPU_CC_BACKEND"] == "h100"
    host = tmp_path / "host"
    assert env["TPU_CC_CACHE_DIR"] == str(host / "var/lib/tpu-cc-manager/jax-cache")
    assert env["CC_READINESS_FILE"] == str(
        host / "run/tpu/validations/.tpu-cc-manager-ctr-ready")
    assert env["CC_NVIDIA_ROOT_CERT_FILE"] == str(
        host / "etc/tpu-cc-manager/nvidia-root/root.pem")
    assert set(paths) >= {"/var/lib/tpu-cc-manager/gpudev", "/usr/local/gpu-admin-tools"}
    for mount in ("var/lib/tpu-cc-manager", "run/tpu/validations", "usr/local/gpu-admin-tools"):
        assert (host / mount).is_dir()
    assert not (host / "dev").exists() and not (host / "sys").exists()
    # Nothing of the caller's own CC env leaks into the container's.
    monkeypatch.setenv("CC_STATE_DIR", "/elsewhere")
    monkeypatch.setenv("CC_SHUTDOWN_GRACE_S", "1")
    env = deploy.container_launch(tmp_path / "h2", REPO, "n")["env"]
    assert env["CC_STATE_DIR"] == str(tmp_path / "h2/var/lib/tpu-cc-manager/gpudev")
    assert "CC_SHUTDOWN_GRACE_S" not in env


@pytest.fixture()
def rig(tmp_path):
    with localrig.LocalRig(str(tmp_path / "rig")) as r:
        yield r


def test_the_agent_started_as_its_container_flips_the_node(rig, tmp_path):
    """The image's entrypoint with the manifest's env, hostPaths under a temp
    directory; overridden: the fake device layer and, on this CPU host, the
    smoke's device and the metrics port (pytest workers share the host).
    The flip to on verifies through the K1 smoke (its plain version on the
    CPU), the smoke's default kernel, after the fake's ready state was set."""
    import chip_smoke

    launch = deploy.container_launch(tmp_path / "host", REPO, localrig.NODE)
    port = free_port()
    agent = rig.start_container(launch, env={
        "GPU_CC_BACKEND": "fake", "GPU_CC_FAKE_NUM_GPUS": "1", "GPU_CC_FAKE_NUM_SWITCHES": "0",
        "CC_SMOKE_DEVICE": "cpu", "CC_METRICS_PORT": str(port), "OMP_NUM_THREADS": "1"})
    # The host is not CC capable, so the agent first applies its default, off.
    assert rig.await_labels({CC_MODE_STATE_LABEL: "off"}, 60), rig.log_of(agent)[-3000:]
    rig.set_label(CC_MODE_LABEL, "on")
    assert rig.await_labels({CC_MODE_STATE_LABEL: "on", CC_READY_STATE_LABEL: "true"},
                            FLIP_S), rig.log_of(agent)[-3000:]
    phases, _ = localrig.await_phases(port, "on", ("attest", "smoke"), 30)
    assert {"attest", "smoke"} <= set(phases)
    log = rig.log_of(agent)
    assert "tpu_cc_manager_torch.smoke --workload matmul --device cpu" in log
    assert [(res["kernel"], res["devices"]) for res in chip_smoke.smoke_results_in(log)] \
        == [("cuda", 1)]
    ops = chip_smoke.fake_ops_in(log)
    assert ops == ["attest", "set_ready"]
    assert pathlib.Path(launch["env"]["CC_READINESS_FILE"]).exists()
    assert not list((tmp_path / "host").rglob("*.so"))
    agent.send_signal(signal.SIGTERM)
    assert agent.wait(timeout=30) == 0, rig.log_of(agent)[-3000:]


def test_chip_smoke_phase_19_b_on_the_cpu(tmp_path):
    """``chip_smoke.daemonset_fake_flip`` and its checks on the CPU: an
    image laid out under ``tmp_path`` (the package copied, a read-only
    prebuilt directory of stub libraries), the smoke asked onto the CPU.
    The one problem found is the one the CPU causes: the smoke ran there."""
    import shutil

    import chip_smoke

    image = tmp_path / "image"
    app = image / "app"
    shutil.copytree(PACKAGE, app / "tpu_cc_manager_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    prebuilt = app / "build" / "torch_kernels"
    prebuilt.mkdir(parents=True)
    for name in _build.sources():
        (prebuilt / _build.library_name(name)).write_bytes(b"stub library")
    for path in [*prebuilt.iterdir(), prebuilt]:
        path.chmod(0o555)
    run = chip_smoke.daemonset_fake_flip(image, app, smoke_k1=0, cards=1, extra_env={
        "CC_SMOKE_DEVICE": "cpu", "GPU_CC_FAKE_NUM_GPUS": "1",
        "GPU_CC_FAKE_NUM_SWITCHES": "0", "OMP_NUM_THREADS": "1"})
    assert run["problems"] == ["the verify smoke ran cuda on 1 cpu device(s), not K1 on the "
                               "1 card(s)"]
    assert run["fake_ops"] == ["attest", "set_ready"]
    assert str(run["port"]) != deploy.env(deploy.MANIFEST.read_text())["CC_METRICS_PORT"]
    assert run["ready"] and run["healthz"] == 200 and run["sigterm_rc"] == 0
    assert [res["kernel"] for res in run["smokes"]] == ["cuda"]
    assert run["prebuilt_after"] == run["prebuilt_before"] and run["built"] == []
    assert run["launch"]["env"]["TPU_CC_CACHE_DIR"].startswith(str(image / "host"))
    chip_smoke.make_writable(image)
