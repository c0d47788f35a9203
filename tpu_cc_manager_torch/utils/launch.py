"""Local ranks of one command, started the way torchrun starts them.

``entry.dryrun_multichip``, the port's multi-process tests and
``chip_smoke.py``'s two-process step each run ``world`` copies of one
command on this host: rank ``r`` gets torchrun's environment names
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
so ``parallel.distributed.bootstrap`` (or ``init_process_group``'s
``env://``) joins them into one process group::

    outputs = run_ranks([sys.executable, "child.py"], world=2, timeout_s=180)
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import tempfile
import time

REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[2])
# Launcher names a rank must not inherit from the caller's environment.
LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID")
POLL_INTERVAL_S = 0.2
TAIL_BYTES = 4000


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, extra: dict | None = None) -> dict:
    """Rank ``rank`` of ``world``'s environment: the caller's without the
    launcher names, the repository on ``PYTHONPATH``, ``extra``, then
    torchrun's names with the rendezvous at ``127.0.0.1:port``."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
    env.update(extra or {})
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


class Ranks:
    """``world`` processes of ``cmd``, rank ``r`` with :func:`rank_env`.
    Each rank writes its stdout and stderr to files of its own, so no pipe
    fills while the caller waits or works. Leaving the ``with`` block kills
    every rank still running."""

    def __init__(self, cmd: list[str], world: int, env: dict | None = None):
        self.cmd = cmd
        self.logs = []
        self.procs = []
        port = free_port()
        try:
            for rank in range(world):
                out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
                self.logs.append((out, err))
                self.procs.append(subprocess.Popen(cmd, env=rank_env(rank, world, port, env),
                                                   stdout=out, stderr=err))
        except BaseException:
            self.close()
            raise

    def __enter__(self) -> Ranks:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def output(self, rank: int, stderr: bool = False) -> str:
        """What rank ``rank`` has written to stdout (or stderr) so far."""
        f = self.logs[rank][1 if stderr else 0]
        f.flush()
        f.seek(0)
        return f.read().decode(errors="replace")

    def failed(self) -> int | None:
        """The first rank that has exited non-zero, if any."""
        return next((r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)), None)

    def wait(self, timeout_s: float) -> list[str]:
        """Every rank's stdout once all have exited 0. A rank that exits
        non-zero raises ``RuntimeError`` at once, with the tail of its
        output; ranks still running after ``timeout_s`` raise
        ``TimeoutError``."""
        deadline = time.monotonic() + timeout_s
        while True:
            r = self.failed()
            if r is not None:
                raise RuntimeError(
                    f"{' '.join(self.cmd)}: rank {r} of {len(self.procs)} exited "
                    f"{self.procs[r].returncode}\nstdout:\n{self.output(r)[-TAIL_BYTES:]}"
                    f"\nstderr:\n{self.output(r, stderr=True)[-TAIL_BYTES:]}")
            running = [r for r, p in enumerate(self.procs) if p.poll() is None]
            if not running:
                return [self.output(r) for r in range(len(self.procs))]
            if time.monotonic() > deadline:
                raise TimeoutError(f"{' '.join(self.cmd)}: ranks {running} still running "
                                   f"after {timeout_s}s")
            try:
                self.procs[running[0]].wait(timeout=POLL_INTERVAL_S)
            except subprocess.TimeoutExpired:
                pass

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in self.logs:
            out.close()
            err.close()


def run_ranks(cmd: list[str], world: int, timeout_s: float,
              env: dict | None = None) -> list[str]:
    """Run :class:`Ranks` of ``cmd`` to the end: each rank's stdout, in
    rank order; raises as :meth:`Ranks.wait` does, every rank stopped."""
    with Ranks(cmd, world, env) as ranks:
        return ranks.wait(timeout_s)
