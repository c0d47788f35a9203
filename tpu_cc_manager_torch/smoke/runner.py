"""Smoke-workload registry and runners of the port.

Port of ``tpu_cc_manager/smoke/runner.py``. Each workload module exposes
``run(**kwargs) -> dict`` returning at least ``{"ok": bool, "workload": str}``
plus its measurements. The agent runs workloads through
:func:`run_workload_subprocess` (``python -m tpu_cc_manager_torch.smoke``),
so the card is acquired and released by a child process, never by the
long-lived agent; ``CCManager(smoke_runner=..., smoke_warmup_factory=...)``
takes this module's runner and :class:`SmokeWarmup`.

A smoke verifies every visible card, as the JAX smokes use every device:
inside its child, after the dispatch gate, :func:`run_per_device` runs the
smoke's body once per card, concurrently in one spawned worker per card,
and :func:`combine` makes one result of theirs (``ok`` only when every card
passed, ``devices`` the card count, ``per_device`` each card's oracles).
The agent still sees one child and one JSON line.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

from tpu_cc_manager_torch.utils.launch import free_port
from tpu_cc_manager_torch.utils.poll import poll_until

log = logging.getLogger(__name__)

WORKLOADS = {
    "matmul": "tpu_cc_manager_torch.smoke.matmul",
    "llama": "tpu_cc_manager_torch.smoke.llama_infer",
    "resnet": "tpu_cc_manager_torch.smoke.resnet_train",
}

_REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[2])


class SmokeError(Exception):
    """Workload failed — treated like a device verification failure."""


class SmokeConfigError(SmokeError, ValueError):
    """Bad workload PARAMETERS (unknown size name or kernel): a
    misconfiguration reported as the structured JSON error line. Also a
    ValueError for in-process callers."""


def resolve_device(device: str):
    """``torch.device`` for a workload. CUDA that is asked for and absent
    is a :class:`SmokeError`: a run never carries on on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SmokeError(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "pass --device cpu to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise SmokeConfigError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


# ---------------------------------------------------------------------------
# Two-phase COMPILE→DISPATCH warmup gate (same env contract as the JAX
# package, so the agent arms either runner the same way)
# ---------------------------------------------------------------------------

#: Path of the gate file; its EXISTENCE releases dispatch.
DISPATCH_GATE_ENV = "CC_SMOKE_DISPATCH_GATE"
#: Pid of the process that owns the gate; if it dies before releasing, the
#: child exits instead of waiting out the timeout as an orphan.
GATE_PARENT_PID_ENV = "CC_SMOKE_GATE_PARENT_PID"
#: Upper bound on the gate wait (seconds).
GATE_TIMEOUT_ENV = "CC_SMOKE_GATE_TIMEOUT_S"

DEFAULT_GATE_TIMEOUT_S = 600.0
GATE_POLL_S = 0.05
_COMPILED_SUFFIX = ".compiled"


def compiled_sentinel(gate_path: str) -> str:
    """File the child touches when its COMPILE phase is done."""
    return gate_path + _COMPILED_SUFFIX


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def await_dispatch_gate(compile_fns: tuple = ()) -> bool:
    """Workload-side gate, called after setup and strictly before the first
    device allocation. A no-op (False) unless ``CC_SMOKE_DISPATCH_GATE`` is
    set. Otherwise: run ``compile_fns`` (the port's compile phase is the
    kernels' nvcc build), touch the compiled sentinel, then block until the
    gate file appears. Raises :class:`SmokeError` when the gate times out or
    the parent named in ``CC_SMOKE_GATE_PARENT_PID`` died without
    releasing."""
    gate = os.environ.get(DISPATCH_GATE_ENV)
    if not gate:
        return False
    for fn in compile_fns:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - warm-up is advisory
            log.warning("warmup kernel build failed (advisory): %s", e)
    try:
        with open(compiled_sentinel(gate), "w", encoding="utf-8") as f:
            f.write(str(os.getpid()))
    except OSError as e:
        log.warning("could not touch compiled sentinel for %s: %s", gate, e)
    try:
        timeout_s = float(os.environ.get(GATE_TIMEOUT_ENV) or DEFAULT_GATE_TIMEOUT_S)
    except ValueError:
        timeout_s = DEFAULT_GATE_TIMEOUT_S
    parent = os.environ.get(GATE_PARENT_PID_ENV, "")
    parent_pid = int(parent) if parent.isdigit() else None
    state = {"orphan": False}

    def released_or_orphaned() -> bool:
        if os.path.exists(gate):
            return True
        if parent_pid is not None and not _pid_alive(parent_pid):
            state["orphan"] = True
            return True
        return False

    opened = poll_until(released_or_orphaned, timeout_s, GATE_POLL_S)
    if state["orphan"]:
        raise SmokeError(
            f"dispatch gate abandoned: parent pid {parent_pid} is gone — "
            "exiting instead of dispatching as an orphan"
        )
    if not opened:
        raise SmokeError(f"dispatch gate {gate} not released within {timeout_s:.0f}s")
    return True


# ---------------------------------------------------------------------------
# Every visible card: one worker per card inside the smoke's child
# ---------------------------------------------------------------------------

#: Seconds a worker that reported may take to exit before it is killed.
WORKER_EXIT_TIMEOUT_S = 60.0
_PR_SET_PDEATHSIG = 1


def device_count(dev, n_devices: int | None = None) -> int:
    """How many devices a smoke verifies: ``n_devices`` when given (the CPU
    tests inject it), else every visible card for CUDA and one CPU."""
    import torch

    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_devices is None:
        return visible
    if not isinstance(n_devices, int) or n_devices < 1:
        raise SmokeConfigError(f"n_devices must be a positive integer (got {n_devices!r})")
    if dev.type == "cuda" and n_devices > visible:
        raise SmokeConfigError(f"n_devices={n_devices} but only {visible} card(s) are visible")
    return n_devices


def _die_with_parent(parent_pid: int) -> None:
    """Have the kernel kill this worker when the smoke's child dies (a
    killed child must not leave workers holding cards)."""
    if sys.platform.startswith("linux"):
        import ctypes
        import signal

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
        libc.prctl.restype = ctypes.c_int
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent_pid:
        os._exit(1)


def _device_worker(body, dev, index: int, count: int, port: int, parent_pid: int,
                   kwargs: dict, conn) -> None:
    """One card's worker: torchrun's environment for rank ``index`` of
    ``count``, the card pinned, then ``body``; sends ``(True, result)`` or
    ``(False, traceback)`` back."""
    _die_with_parent(parent_pid)
    os.environ.update(RANK=str(index), WORLD_SIZE=str(count), LOCAL_RANK=str(index),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch

    try:
        if dev.type == "cuda":
            torch.cuda.set_device(index)
        conn.send((True, body(torch_device(dev, index), index, count, **kwargs)))
    except Exception:  # the worker's boundary: report, then exit non-zero
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_per_device(body, dev, count: int, **kwargs) -> list[dict]:
    """``body(device, index, count, **kwargs) -> dict`` once per device,
    results in device order. One device runs in this process; more run
    concurrently, one spawned worker per card (``cuda:i`` pinned, rank
    ``i`` of ``count`` in torchrun's environment names, so a body that calls
    ``parallel.distributed.bootstrap`` joins one process group over them).
    ``body`` must be a module-level function. A worker that raises or dies
    fails the smoke: :class:`SmokeError`, and the other workers are
    killed."""
    if count == 1:
        return [body(torch_device(dev, 0), 0, 1, **kwargs)]
    import multiprocessing.connection

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    procs, conns = [], []
    for index in range(count):
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_device_worker, daemon=True, args=(
            body, dev, index, count, port, os.getpid(), kwargs, send))
        proc.start()
        send.close()
        procs.append(proc)
        conns.append(recv)
    results: dict[int, dict] = {}
    try:
        while len(results) < count:
            pending = [i for i in range(count) if i not in results]
            ready = multiprocessing.connection.wait(
                [conns[i] for i in pending] + [procs[i].sentinel for i in pending])
            for i in pending:
                if conns[i] not in ready and procs[i].sentinel not in ready:
                    continue
                try:  # a dead worker's pipe holds its result or ends
                    ok, payload = conns[i].recv()
                except EOFError:
                    ok, payload = False, "exited without a result"
                if not ok:
                    procs[i].join(timeout=WORKER_EXIT_TIMEOUT_S)
                    raise SmokeError(f"device {i} of {count} failed (worker exit code "
                                     f"{procs[i].exitcode}): {payload}")
                results[i] = payload
    finally:
        failed = len(results) < count
        for proc in procs:
            proc.join(timeout=0 if failed else WORKER_EXIT_TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in conns:
            conn.close()
    return [results[i] for i in range(count)]


def torch_device(dev, index: int):
    """Card ``index`` for a CUDA ``dev``; the CPU itself for a CPU one."""
    import torch

    return torch.device("cuda", index) if dev.type == "cuda" else torch.device("cpu")


def device_bdf(dev) -> str | None:
    """The PCI address of card ``dev``, the key ``gpudev`` resets it by
    (torch's device indices follow ``CUDA_VISIBLE_DEVICES`` and
    ``CUDA_DEVICE_ORDER``); None for the CPU."""
    if dev.type != "cuda":
        return None
    import torch

    from tpu_cc_manager_torch.gpudev.pci import bdf_of_torch_device

    return bdf_of_torch_device(torch.cuda.current_device() if dev.index is None else dev.index)


def combine(results: list[dict], per_device_keys: tuple, reducers: dict) -> dict:
    """One smoke result from the per-device ones: device 0's keys, then
    ``ok`` only when every device is ok, ``devices`` their count, each key of
    ``reducers`` reduced over the devices, and ``per_device`` holding each
    device's ``per_device_keys``."""
    out = dict(results[0])
    out["ok"] = all(r["ok"] for r in results)
    out["devices"] = len(results)
    for key, reduce in reducers.items():
        out[key] = reduce([r[key] for r in results])
    out["per_device"] = [{k: r[k] for k in per_device_keys} for r in results]
    return out


def worst(pick):
    """A reducer: ``pick`` (``max`` or ``min``) over the devices' values, or
    None when any device has none."""
    return lambda values: None if any(v is None for v in values) else pick(values)


def summed_counts(values: list[dict]) -> dict:
    """Launch counts (flat or by variant) summed over the devices."""
    out = {}
    for counts in values:
        for key, n in counts.items():
            out[key] = summed_counts([out.get(key, {}), n]) if isinstance(n, dict) else out.get(key, 0) + n
    return out


def run_workload(name: str, **kwargs) -> dict:
    """Run a workload in-process (tests, chip_smoke.py)."""
    if name not in WORKLOADS:
        raise SmokeError(f"unknown smoke workload {name!r} (have {sorted(WORKLOADS)})")
    mod = importlib.import_module(WORKLOADS[name])
    result = mod.run(**kwargs)
    if not result.get("ok"):
        raise SmokeError(f"workload {name} reported failure: {result}")
    return result


def _subprocess_cmd_env(
    name: str,
    force_cpu: bool,
    extra_args: list[str] | None,
    extra_env: dict[str, str] | None,
) -> tuple[list[str], dict[str, str]]:
    """The shared ``python -m tpu_cc_manager_torch.smoke`` command and
    child environment (one place, so the blocking and warmup spawns never
    diverge). The package's root goes on the child's PYTHONPATH, so the
    caller's working directory does not matter."""
    if name not in WORKLOADS:
        raise SmokeError(f"unknown smoke workload {name!r} (have {sorted(WORKLOADS)})")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p
    )
    if extra_env:
        env.update(extra_env)
    cmd = [sys.executable, "-m", "tpu_cc_manager_torch.smoke", "--workload", name]
    if force_cpu:
        cmd.extend(["--device", "cpu"])
    if extra_args:
        cmd.extend(extra_args)
    return cmd, env


def _parse_smoke_stdout(name: str, stdout: str, returncode: int, stderr: str) -> dict:
    """Parse the final JSON line of a smoke child's stdout; raises
    :class:`SmokeError` unless the child exited 0 with an ok result."""
    last_json = None
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                last_json = json.loads(line)
            except json.JSONDecodeError:
                continue
    if returncode != 0:
        raise SmokeError(
            f"workload {name} exited rc={returncode}: {last_json} "
            f"{(stderr or '')[-512:]}"
        )
    if not last_json or not last_json.get("ok"):
        raise SmokeError(f"workload {name} produced no passing result: {last_json}")
    return last_json


def run_workload_subprocess(
    name: str,
    timeout_s: float = 900.0,
    force_cpu: bool = False,
    cwd: str | None = None,
    extra_args: list[str] | None = None,
    extra_env: dict[str, str] | None = None,
) -> dict:
    """Run a workload as ``python -m tpu_cc_manager_torch.smoke`` and parse
    the final JSON line of its stdout. ``force_cpu`` passes ``--device
    cpu``; without it the child runs on the card, and fails when there is
    none."""
    cmd, env = _subprocess_cmd_env(name, force_cpu, extra_args, extra_env)
    log.info("running smoke workload: %s", " ".join(cmd))
    try:
        proc = subprocess.run(
            cmd, capture_output=True, timeout=timeout_s, text=True, env=env, cwd=cwd,
        )
    except subprocess.TimeoutExpired as e:
        raise SmokeError(f"workload {name} timed out after {timeout_s:.0f}s") from e
    last_json = _parse_smoke_stdout(name, proc.stdout, proc.returncode, proc.stderr or "")
    log.info("smoke workload %s passed: %s", name, last_json)
    return last_json


class SmokeWarmup:
    """Parent-side handle on a two-phase smoke subprocess (the port's copy
    of the JAX package's class, spawning the port's smoke).

    The child is spawned at once with the dispatch gate armed; it builds
    its kernels, then blocks. :meth:`release` opens the gate (the agent
    calls it only after the runtime is ready and attested); :meth:`result`
    joins the child and returns its parsed result with ``warmup_compile_s``,
    ``warmup_overlap_s`` and ``warmup_dispatch_s`` added; :meth:`cancel`
    kills the child on any path where its dispatch must never run."""

    def __init__(
        self,
        name: str,
        timeout_s: float = 900.0,
        force_cpu: bool = False,
        cwd: str | None = None,
        extra_args: list[str] | None = None,
        extra_env: dict[str, str] | None = None,
        gate_timeout_s: float | None = None,
    ) -> None:
        cmd, env = _subprocess_cmd_env(name, force_cpu, extra_args, extra_env)
        self.name = name
        self._timeout_s = timeout_s
        self._tmp = tempfile.mkdtemp(prefix="tpu-cc-torch-smoke-gate-")
        self._gate = os.path.join(self._tmp, "dispatch-gate")
        env[DISPATCH_GATE_ENV] = self._gate
        env[GATE_PARENT_PID_ENV] = str(os.getpid())
        if gate_timeout_s is not None:
            env[GATE_TIMEOUT_ENV] = str(gate_timeout_s)
        self._stdout_path = os.path.join(self._tmp, "stdout")
        self._stderr_path = os.path.join(self._tmp, "stderr")
        log.info("starting warmup smoke (gated dispatch): %s", " ".join(cmd))
        try:
            with open(self._stdout_path, "w", encoding="utf-8") as out, open(
                self._stderr_path, "w", encoding="utf-8"
            ) as err:
                self._proc = subprocess.Popen(
                    cmd, stdout=out, stderr=err, env=env, cwd=cwd, text=True,
                )
        except BaseException:
            shutil.rmtree(self._tmp, ignore_errors=True)
            raise
        self._t0 = time.monotonic()
        # Wall-clock twin of _t0: the sentinel's mtime is wall time.
        self._t0_wall = time.time()
        self._released_at: float | None = None
        self._released_wall: float | None = None
        self._done = False

    @property
    def gate_path(self) -> str:
        return self._gate

    def compiled_after_s(self) -> float | None:
        """Seconds from spawn to the child's compiled sentinel (None while
        the COMPILE phase runs or when the sentinel never landed)."""
        try:
            mtime = os.path.getmtime(compiled_sentinel(self._gate))
        except OSError:
            return None
        return max(0.0, mtime - self._t0_wall)

    def died_during_warmup(self) -> bool:
        """True when the child exited before the gate was released."""
        return self._released_at is None and self._proc.poll() is not None

    def release(self) -> None:
        """Open the dispatch gate. Idempotent."""
        if self._released_at is not None:
            return
        with open(self._gate, "w", encoding="utf-8") as f:
            f.write("released")
        self._released_at = time.monotonic()
        self._released_wall = time.time()

    def cancel(self, reason: str = "") -> None:
        """Kill the child (no dispatch must run). Safe on any state."""
        if self._done:
            return
        self._done = True
        if self._proc.poll() is None:
            log.info("cancelling warmup smoke %s%s", self.name,
                     f" ({reason})" if reason else "")
            self._proc.kill()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover - kill() sent
            log.warning("warmup smoke %s did not reap after kill", self.name)
        shutil.rmtree(self._tmp, ignore_errors=True)

    def result(self) -> dict:
        """Join the released child and return its parsed result (raises
        :class:`SmokeError` exactly like :func:`run_workload_subprocess`)."""
        if self._released_at is None:
            self.release()
        remaining = max(1.0, self._timeout_s - (time.monotonic() - self._t0))
        try:
            rc = self._proc.wait(timeout=remaining)
        except subprocess.TimeoutExpired as e:
            self.cancel("timeout")
            raise SmokeError(
                f"workload {self.name} timed out after {self._timeout_s:.0f}s"
            ) from e
        compile_s = self.compiled_after_s()
        released_delta = max(0.0, self._released_wall - self._t0_wall)
        dispatch_s = max(0.0, time.time() - self._released_wall)
        try:
            with open(self._stdout_path, encoding="utf-8") as f:
                stdout = f.read()
            with open(self._stderr_path, encoding="utf-8") as f:
                stderr = f.read()
        except OSError:
            stdout, stderr = "", ""
        self._done = True
        shutil.rmtree(self._tmp, ignore_errors=True)
        last_json = _parse_smoke_stdout(self.name, stdout, rc, stderr)
        last_json["warmup_compile_s"] = round(compile_s, 3) if compile_s is not None else None
        # Only the pre-release part of the compile span was hidden; a missing
        # sentinel means the span is unknown, so claim zero.
        overlap = 0.0 if compile_s is None else min(compile_s, released_delta)
        last_json["warmup_overlap_s"] = round(max(0.0, overlap), 3)
        last_json["warmup_dispatch_s"] = round(dispatch_s, 3)
        log.info("warmup smoke %s passed: %s", self.name, last_json)
        return last_json

    def release_and_result(self) -> dict:
        self.release()
        return self.result()
