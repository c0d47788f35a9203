"""The agent on one host with no cluster: ``hack/mock_apiserver.py`` in a
process of its own, a kubeconfig that points at it, and the port's agent
(``python -m tpu_cc_manager_torch``) as a process, as
``hack/demo_local.sh`` runs the JAX agent::

    with LocalRig(workdir) as rig:
        agent = rig.start_agent(["--gpu-backend", "fake", "--smoke-workload", "matmul"],
                                metrics_port=free_port())
        rig.set_label(CC_MODE_LABEL, "on")
        rig.await_labels({CC_MODE_STATE_LABEL: "on"}, timeout_s=120)

Every process runs under ``timeout --foreground``, in a process group of
its own that the rig's ``close`` ends. A signal sent to ``timeout`` reaches
the process once: without ``--foreground`` it also signals its whole group,
and the agent takes a second SIGTERM as "exit now" (143).
The mock serves one node, ``demo-node-0``, with the operator's component
labels and pods, and plays their DaemonSets: a paused component's pod goes
and comes back on unpause.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import urllib.error
import urllib.request

from tpu_cc_manager_torch.utils.launch import free_port
from tpu_cc_manager_torch.utils.poll import poll_until

REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[2])
NODE = "demo-node-0"
POLL_S = 0.1
LIFETIME_S = 300  # each process's ``timeout``
START_S = 30  # the mock apiserver's start
# The mock's watch bookmarks (5 s by default): the agent's watch loop sees a
# SIGTERM at its next event, and its hard-exit fallback (exit 143) fires
# about 3 s after the signal when no event came.
BOOKMARK_INTERVAL_S = 0.5

KUBECONFIG = """apiVersion: v1
kind: Config
clusters:
- cluster: {{server: "http://127.0.0.1:{port}"}}
  name: mock
contexts:
- context: {{cluster: mock, user: mock}}
  name: mock
current-context: mock
users:
- name: mock
  user: {{}}
"""


def _request(url: str, body: dict | None = None) -> bytes:
    data = json.dumps(body).encode() if body is not None else None
    with urllib.request.urlopen(url, data=data, timeout=5) as r:
        return r.read()


class LocalRig:
    """A mock apiserver and the agents started against it, under
    ``workdir`` (kubeconfig, readiness files, state dirs, logs)."""

    def __init__(self, workdir: str) -> None:
        self.workdir = pathlib.Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.port = free_port()
        self.kubeconfig = str(self.workdir / "kubeconfig.yaml")
        pathlib.Path(self.kubeconfig).write_text(KUBECONFIG.format(port=self.port))
        self.procs: list[subprocess.Popen] = []
        self.logs: dict[int, pathlib.Path] = {}

    def __enter__(self) -> "LocalRig":
        self.start_apiserver()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _spawn(self, name: str, cmd: list[str], env: dict,
               cwd: str = REPO_ROOT) -> subprocess.Popen:
        log = self.workdir / f"{name}.log"
        with open(log, "w", encoding="utf-8") as out:
            proc = subprocess.Popen(
                ["timeout", "--foreground", "-k", "5", str(LIFETIME_S), *cmd],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=cwd,
                start_new_session=True)
        self.procs.append(proc)
        self.logs[proc.pid] = log
        return proc

    def start_apiserver(self) -> None:
        """``hack/mock_apiserver.py`` on ``self.port``, run as its own
        script: it reads none of the JAX package (its own copy of the
        component labels)."""
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["MOCK_BOOKMARK_INTERVAL_S"] = str(BOOKMARK_INTERVAL_S)
        proc = self._spawn("apiserver", [sys.executable, "hack/mock_apiserver.py",
                                         str(self.port)], env)

        def up() -> bool:
            if proc.poll() is not None:
                raise RuntimeError(f"mock apiserver exited rc={proc.returncode}: "
                                   f"{self.log_of(proc)[-2000:]}")
            try:
                self.state()
                return True
            except (OSError, urllib.error.URLError):
                return False

        if not poll_until(up, START_S, POLL_S):
            raise RuntimeError(f"mock apiserver did not answer within {START_S} s")

    def start_agent(self, args: list[str], metrics_port: int | None = None,
                    env: dict | None = None) -> subprocess.Popen:
        """``python -m tpu_cc_manager_torch [args]`` for the mock's node,
        with its readiness file and state dir under the rig's workdir."""
        full_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        full_env.update(
            NODE_NAME=NODE, KUBECONFIG=self.kubeconfig, OPERATOR_NAMESPACE="tpu-operator",
            CC_READINESS_FILE=str(self.readiness_file()),
            CC_STATE_DIR=str(self.workdir / "state"), PYTHONPATH=REPO_ROOT)
        full_env.update(env or {})
        if metrics_port:
            args = [*args, "--metrics-port", str(metrics_port)]
        return self._spawn(f"agent-{len(self.procs)}",
                           [sys.executable, "-m", "tpu_cc_manager_torch", *args], full_env)

    def start_container(self, launch: dict, env: dict | None = None) -> subprocess.Popen:
        """The agent as its container runs it (``deploy.container_launch``:
        command, environment, working directory) for the mock's node, with
        ``KUBECONFIG`` pointing at the mock in place of the in-cluster
        config, and ``env`` over the container's."""
        full_env = {**launch["env"], "KUBECONFIG": self.kubeconfig, **(env or {})}
        return self._spawn(f"agent-{len(self.procs)}", launch["cmd"], full_env,
                           cwd=launch["cwd"])

    def log_of(self, proc: subprocess.Popen) -> str:
        return self.logs[proc.pid].read_text(encoding="utf-8", errors="replace")

    def state(self) -> dict:
        """The node's labels, pods and events as the mock holds them."""
        return json.loads(_request(f"http://127.0.0.1:{self.port}/_ctl/state", {}))

    def labels(self) -> dict:
        return self.state()["labels"]

    def set_label(self, key: str, value: str | None) -> None:
        _request(f"http://127.0.0.1:{self.port}/_ctl/set-label",
                 {"node": NODE, "key": key, "value": value})

    def await_labels(self, want: dict, timeout_s: float) -> bool:
        """Poll until every label in ``want`` holds its value (None: absent)."""
        return poll_until(lambda: all(self.labels().get(k) == v for k, v in want.items()),
                          timeout_s, POLL_S)

    def readiness_file(self) -> pathlib.Path:
        return self.workdir / "ready"

    def close(self) -> None:
        """SIGTERM each process group still running, SIGKILL after 15 s."""
        for sig in (signal.SIGTERM, signal.SIGKILL):
            for proc in self.procs:
                if proc.poll() is None:
                    try:
                        os.killpg(proc.pid, sig)
                    except ProcessLookupError:
                        pass
            for proc in self.procs:
                try:
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    continue


def metrics_text(port: int) -> str | None:
    """The agent's ``/metrics`` exposition, or None while it does not answer."""
    try:
        return _request(f"http://127.0.0.1:{port}/metrics").decode()
    except (OSError, urllib.error.URLError):
        return None


def phase_seconds(text: str, mode: str) -> dict[str, float]:
    """``tpu_cc_phase_seconds_sum`` by phase for ``mode``, from an
    exposition."""
    out = {}
    prefix = "tpu_cc_phase_seconds_sum{"
    for line in text.splitlines():
        if not line.startswith(prefix):
            continue
        labels, value = line[len(prefix):].rsplit("} ", 1)
        fields = dict(part.split("=", 1) for part in labels.split(","))
        if fields.get("mode") == f'"{mode}"':
            out[fields["phase"].strip('"')] = float(value)
    return out


def await_phases(port: int, mode: str, phases, timeout_s: float) -> tuple[dict, str]:
    """``phase_seconds`` for ``mode`` and the exposition it came from, once
    every name in ``phases`` is there, or as last read at the deadline. The
    agent writes a flip's labels before its reconcile ends (re-admission
    joined, intents closed) and only then records the flip's phases, so a
    reader that saw the labels polls for the phases."""
    seen = ({}, "")

    def recorded() -> bool:
        nonlocal seen
        text = metrics_text(port) or ""
        seen = (phase_seconds(text, mode), text)
        return set(phases) <= set(seen[0])

    poll_until(recorded, timeout_s, POLL_S)
    return seen
