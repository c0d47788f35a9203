"""The agent on one machine with no cluster: ``hack/mock_apiserver.py`` in a
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
The mock serves ``nodes`` nodes (one by default), ``demo-node-0`` to
``demo-node-<nodes - 1>``, each with the operator's component labels and
pods, and plays their DaemonSets: a paused component's pod goes and comes
back on unpause. ``start_agent``, ``set_label``, ``labels`` and
``await_labels`` take the node, ``demo-node-0`` unless told.

Two agents can be the two hosts of one slice on the fake device layer, as
``hack/demo_multihost.sh`` runs the JAX agent (:func:`start_slice_agents`,
:func:`flip_slice`): the desired mode on host 0 alone leaves it staged at
the slice commit barrier, and once host 1 is labelled too the barrier forms
and both hosts commit::

    with LocalRig(workdir, nodes=2) as rig:
        agents = start_slice_agents(rig, ["none", "none"], env={...})
        flip = flip_slice(rig, agents)  # flip["problems"] is empty when it passed

A training job can ride through a flip beside the agent, as the workload
side of the drain handshake (``drain/handshake.py``) sees it: the job
(:func:`run_job`, ``python -m tpu_cc_manager_torch.ccmanager.localrig job``)
trains the Llama on a fixed batch and polls a request file between steps;
the sidecar ``python -m tpu_cc_manager_torch.ctl drain-subscribe`` runs
``python -m tpu_cc_manager_torch.ccmanager.localrig request-checkpoint`` as
its ``--on-drain`` command, which asks the job to checkpoint and returns
once the job has saved and exited, and its ``--on-resume`` command starts a
fresh job that restores the newest checkpoint::

    rig.start_job(job_dir, ["--until", "8", "--hold-at", "3"])
    rig.start_ctl(["drain-subscribe", "--node", NODE, "--job", "train",
                   "--on-drain", request_checkpoint_cmd(job_dir),
                   "--on-resume", job_cmd(job_dir, ["--resume", "--until", "8"])])

Every job writes its steps, its checkpoint and its restore as JSON lines to
``<job dir>/events.jsonl`` (:func:`job_events`).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shlex
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

from tpu_cc_manager_torch.labels import (
    CC_MODE_LABEL,
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    MODE_SLICE,
    SLICE_STAGED_LABEL,
)
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

    def __init__(self, workdir: str, nodes: int = 1) -> None:
        self.workdir = pathlib.Path(workdir)
        self.nodes = [f"demo-node-{i}" for i in range(nodes)]
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
                                         str(self.port), str(len(self.nodes))], env)

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
                    env: dict | None = None, node: str = NODE) -> subprocess.Popen:
        """``python -m tpu_cc_manager_torch [args]`` for the mock's ``node``,
        with its readiness file and state dir under the rig's workdir."""
        full_env = self._port_env({
            "NODE_NAME": node, "OPERATOR_NAMESPACE": "tpu-operator",
            "CC_READINESS_FILE": str(self.readiness_file(node)),
            "CC_STATE_DIR": str(self._node_path("state", node)), **(env or {})})
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

    def _port_env(self, env: dict | None) -> dict:
        """This process's environment for a process of the port's against
        the mock, ``env`` over it."""
        full_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        full_env.update(KUBECONFIG=self.kubeconfig, PYTHONPATH=REPO_ROOT, **(env or {}))
        return full_env

    def start_ctl(self, args: list[str], env: dict | None = None) -> subprocess.Popen:
        """``python -m tpu_cc_manager_torch.ctl [args]`` against the mock."""
        return self._spawn(f"ctl-{len(self.procs)}",
                           [sys.executable, "-m", "tpu_cc_manager_torch.ctl", *args],
                           self._port_env(env))

    def start_job(self, job_dir: str, args: list[str],
                  env: dict | None = None) -> subprocess.Popen:
        """A training job (:func:`run_job`) writing under ``job_dir``."""
        return self._spawn(f"job-{len(self.procs)}", shlex.split(job_cmd(job_dir, args)),
                           self._port_env(env))

    def log_of(self, proc: subprocess.Popen) -> str:
        return self.logs[proc.pid].read_text(encoding="utf-8", errors="replace")

    def state(self) -> dict:
        """The nodes' labels, the pods and the events as the mock holds
        them: ``labels`` for a rig of one node, ``nodes`` (each node's
        labels by name) for more."""
        return json.loads(_request(f"http://127.0.0.1:{self.port}/_ctl/state", {}))

    def labels(self, node: str = NODE) -> dict:
        state = self.state()
        return state["labels"] if "labels" in state else state["nodes"][node]

    def set_label(self, key: str, value: str | None, node: str = NODE) -> None:
        _request(f"http://127.0.0.1:{self.port}/_ctl/set-label",
                 {"node": node, "key": key, "value": value})

    def await_labels(self, want: dict, timeout_s: float, node: str = NODE) -> bool:
        """Poll until every label in ``want`` holds its value (None: absent)
        on ``node``."""
        return poll_until(
            lambda: all(self.labels(node).get(k) == v for k, v in want.items()),
            timeout_s, POLL_S)

    def _node_path(self, name: str, node: str) -> pathlib.Path:
        """``name`` under the workdir for the first node, ``name-<node>``
        for any other."""
        return self.workdir / (name if node == NODE else f"{name}-{node}")

    def readiness_file(self, node: str = NODE) -> pathlib.Path:
        return self._node_path("ready", node)

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


# ---- two hosts of one slice ------------------------------------------------------

SLICE_ID = "demo-slice"
SLICE_BARRIER_TIMEOUT_S = 120  # each agent's CC_SLICE_BARRIER_TIMEOUT_S
HOLD_S = 6.0  # host 0 labelled alone, as hack/demo_multihost.sh sleeps
START_AGENT_S = 60  # an agent's /metrics and its first reconcile
SLICE_FLIP_S = 120  # the demo's wait for both hosts' mode.state


def start_slice_agents(rig: LocalRig, workloads: list[str],
                       env: dict | None = None) -> list[subprocess.Popen]:
    """One agent a node of ``rig``, host i of a ``len(workloads)``-host
    slice on the fake device layer with ``--smoke-workload workloads[i]``
    and the demo's barrier deadline, each serving ``/metrics`` on a port of
    its own (``proc.metrics_port``). Returns once every agent answers and
    its node has its first mode state; raises ``RuntimeError`` with the
    agent's log when one did not."""
    agents = []
    for i, workload in enumerate(workloads):
        port = free_port()
        host = {"GPU_CC_FAKE_NUM_HOSTS": str(len(workloads)),
                "GPU_CC_FAKE_HOST_INDEX": str(i), "GPU_CC_FAKE_SLICE_ID": SLICE_ID,
                "CC_SLICE_BARRIER_TIMEOUT_S": str(SLICE_BARRIER_TIMEOUT_S)}
        proc = rig.start_agent(["--gpu-backend", "fake", "--smoke-workload", workload],
                               metrics_port=port, env={**(env or {}), **host},
                               node=rig.nodes[i])
        proc.metrics_port, proc.node = port, rig.nodes[i]
        agents.append(proc)
    for proc in agents:
        started = poll_until(
            lambda p=proc: p.poll() is not None or (
                metrics_text(p.metrics_port) is not None
                and rig.labels(p.node).get(CC_MODE_STATE_LABEL) is not None),
            START_AGENT_S, POLL_S)
        if not started or proc.poll() is not None:
            raise RuntimeError(f"the agent of {proc.node} did not start: "
                               f"{rig.log_of(proc)[-3000:]}")
    return agents


def flip_slice(rig: LocalRig, agents: list[subprocess.Popen],
               timeout_s: float = SLICE_FLIP_S) -> dict:
    """``hack/demo_multihost.sh``'s flip over agents of
    :func:`start_slice_agents`: the desired mode ``slice`` on host 0 alone,
    which must not commit in the ``HOLD_S`` after its label and must show
    its staged marker at the end of them; then on every other host, after which every node must read
    ``slice`` and host 0 must read ready. Returns what host 0 showed while
    alone, the seconds from the last host's label to that (``flip_s``,
    drain->ready of the slice as host 0 sees it), and ``problems``: empty
    when the flip passed."""
    host0, others, mode = agents[0], agents[1:], MODE_SLICE
    rig.set_label(CC_MODE_LABEL, mode, node=host0.node)
    # Host 0 alone, as the demo sleeps: watched for a commit through the
    # hold, which its drain and stage take the start of.
    committed = poll_until(
        lambda: rig.labels(host0.node).get(CC_MODE_STATE_LABEL) == mode, HOLD_S, POLL_S)
    alone = {k: rig.labels(host0.node).get(k)
             for k in (SLICE_STAGED_LABEL, CC_MODE_STATE_LABEL)}
    problems = []
    if alone[SLICE_STAGED_LABEL] != mode:
        problems.append(f"host 0 did not publish its staged marker: {alone}")
    if committed or alone[CC_MODE_STATE_LABEL] == mode:
        problems.append(f"host 0 committed {mode} without its peers")
    t0 = time.perf_counter()
    for proc in others:
        rig.set_label(CC_MODE_LABEL, mode, node=proc.node)
    flipped = all(rig.await_labels({CC_MODE_STATE_LABEL: mode}, timeout_s, node=p.node)
                  for p in agents)
    flipped = flipped and rig.await_labels({CC_READY_STATE_LABEL: "true"}, timeout_s,
                                           node=host0.node)
    flip_s = time.perf_counter() - t0
    if not flipped:
        problems.append(f"the slice did not reach {mode} with host 0 ready in "
                        f"{timeout_s:g} s: " + json.dumps(
                            {p.node: rig.labels(p.node).get(CC_MODE_STATE_LABEL)
                             for p in agents}))
    return {"alone": alone, "flip_s": flip_s, "problems": problems}


# ---- the training job beside the agent ------------------------------------------

JOB_EVENTS = "events.jsonl"
JOB_REQUEST = "checkpoint-request"
JOB_PID = "job.pid"
JOB_POLL_S = 0.05
# The longest a held job waits for the request, and a request for the job's exit.
JOB_HOLD_S = 600


def job_cmd(job_dir: str, args: list[str]) -> str:
    """The shell command of a job under ``job_dir``, under ``timeout``."""
    return shlex.join(["timeout", "-k", "5", str(LIFETIME_S), sys.executable, "-m",
                       "tpu_cc_manager_torch.ccmanager.localrig", "job", "--dir", job_dir,
                       *args])


def request_checkpoint_cmd(job_dir: str) -> str:
    """The shell command that asks the job under ``job_dir`` to checkpoint
    and returns once it has saved and exited (:func:`request_checkpoint`)."""
    return shlex.join(["timeout", "-k", "5", str(JOB_HOLD_S + 30), sys.executable, "-m",
                       "tpu_cc_manager_torch.ccmanager.localrig", "request-checkpoint",
                       "--dir", job_dir])


def _event(job_dir: pathlib.Path, **fields) -> None:
    fields.setdefault("t", time.time())
    with open(job_dir / JOB_EVENTS, "a", encoding="utf-8") as f:
        f.write(json.dumps(fields, sort_keys=True) + "\n")


def job_events(job_dir: str) -> list[dict]:
    """Every event the jobs under ``job_dir`` and their requests wrote,
    oldest first."""
    path = pathlib.Path(job_dir) / JOB_EVENTS
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text(encoding="utf-8").splitlines()
            if line.strip()]


def _tree_bytes(path: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def run_job(job_dir: str, size: str = "llama3_2_1b", batch: int = 4, seq: int = 1024,
            until: int = 8, hold_at: int = 0, device: str = "cuda",
            resume: bool = False, layers: int | None = None) -> int:
    """Train the Llama ``size`` (``LlamaConfig.<size>()``, at ``layers`` of
    its layers when given, weights from seed 0) with AdamW on one fixed
    batch of ``batch`` x ``seq`` + 1 tokens
    (numpy's generator from seed 0, as ``chip_smoke.py``'s training phase
    draws it) on a one-rank mesh, up to step ``until``. With ``resume`` the
    newest checkpoint is restored first. Between steps the job looks for
    the checkpoint request
    (:func:`request_checkpoint`); on it, it saves through
    ``TrainCheckpointer`` and exits, which frees the card as a reset would
    force. At step ``hold_at`` it stops stepping and waits for the request,
    as a job whose next batch has not come. Each step's loss and kernel
    launches go to the events file. Returns 0 when it reached ``until`` or
    saved on request, 1 when a held job was never asked."""
    import numpy as np
    import torch

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models.llama import LlamaConfig
    from tpu_cc_manager_torch.parallel.checkpoint import TrainCheckpointer
    from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh
    from tpu_cc_manager_torch.parallel.train import (
        make_llama_train_state,
        make_llama_train_step,
    )

    directory = pathlib.Path(job_dir)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / JOB_PID).write_text(str(os.getpid()))
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = getattr(LlamaConfig, size)(**({"n_layers": layers} if layers else {}))
    mesh = make_mesh(MeshSpec(), device_type=device)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq + 1))).to(device)
    state, shardings = make_llama_train_state(cfg, mesh, seed=0)
    step = make_llama_train_step(cfg, mesh, shardings)
    ckpt = TrainCheckpointer(str(directory / "ckpt"))
    if resume:
        t0 = time.perf_counter()
        ckpt.restore(state)
        _event(directory, event="restored", step=state.step,
               restore_s=time.perf_counter() - t0, pid=os.getpid())
    request = directory / JOB_REQUEST

    def save_on_request() -> bool:
        if not request.exists():
            return False
        t0 = time.perf_counter()
        ckpt.save(state.step, state)
        ckpt.close()
        _event(directory, event="checkpoint", step=state.step,
               save_s=time.perf_counter() - t0,
               bytes=_tree_bytes(directory / "ckpt" / str(state.step)), pid=os.getpid())
        return True

    while state.step < until:
        if save_on_request():
            return 0
        ops.reset_launch_counts()
        state, loss = step(state, tokens)
        loss = float(loss)  # waits for the step
        launches = {**ops.launch_counts(),
                    **{f"{k}/{v}": n for k, counts in ops.variant_launch_counts().items()
                       for v, n in counts.items()}}
        _event(directory, event="step", step=state.step, loss=loss, launches=launches,
               pid=os.getpid())
        if state.step == hold_at:
            _event(directory, event="held", step=state.step, pid=os.getpid())
            if not poll_until(request.exists, JOB_HOLD_S, JOB_POLL_S):
                return 1
    if save_on_request():
        return 0
    _event(directory, event="done", step=state.step, pid=os.getpid())
    return 0


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:  # a zombie has exited; its parent has not reaped it yet
        with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def request_checkpoint(job_dir: str) -> int:
    """Ask the job under ``job_dir`` to checkpoint: write the request file,
    wait until the job process has exited and its checkpoint is in the
    events file, and record when the exit was seen. 0 on a checkpoint, 1
    when no job runs or none came within ``JOB_HOLD_S``."""
    directory = pathlib.Path(job_dir)
    try:
        pid = int((directory / JOB_PID).read_text())
    except (OSError, ValueError):
        print(f"no job under {job_dir}", file=sys.stderr)
        return 1
    if not _alive(pid):
        print(f"the job {pid} under {job_dir} is not running", file=sys.stderr)
        return 1
    _event(directory, event="request", pid=pid)
    (directory / JOB_REQUEST).write_text(str(time.time()))
    if not poll_until(lambda: not _alive(pid), JOB_HOLD_S, JOB_POLL_S):
        print(f"the job {pid} did not exit within {JOB_HOLD_S} s", file=sys.stderr)
        return 1
    saved = [e for e in job_events(job_dir) if e["event"] == "checkpoint" and e["pid"] == pid]
    (directory / JOB_REQUEST).unlink()
    _event(directory, event="exited", pid=pid, saved=bool(saved))
    if not saved:
        print(f"the job {pid} exited without a checkpoint", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="the training job beside the agent")
    sub = p.add_subparsers(dest="command", required=True)
    job = sub.add_parser("job", help="train, checkpoint on request (run_job)")
    job.add_argument("--dir", required=True)
    job.add_argument("--size", default="llama3_2_1b", help="a LlamaConfig constructor")
    job.add_argument("--layers", type=int, default=None,
                     help="the model's depth (default: the size's own)")
    job.add_argument("--batch", type=int, default=4)
    job.add_argument("--seq", type=int, default=1024)
    job.add_argument("--until", type=int, default=8, help="the last step")
    job.add_argument("--hold-at", type=int, default=0,
                     help="stop stepping here until the checkpoint request (0: never)")
    job.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    job.add_argument("--resume", action="store_true", help="restore the newest checkpoint")
    req = sub.add_parser("request-checkpoint", help="ask the job to checkpoint and exit")
    req.add_argument("--dir", required=True)
    args = p.parse_args(argv)
    if args.command == "request-checkpoint":
        return request_checkpoint(args.dir)
    return run_job(args.dir, size=args.size, batch=args.batch, seq=args.seq, until=args.until,
                   hold_at=args.hold_at, device=args.device, resume=args.resume,
                   layers=args.layers)


if __name__ == "__main__":
    sys.exit(main())
