"""Multi-process bootstrap and the data-mesh health check.

Port of ``tpu_cc_manager/parallel/distributed.py``:

- :func:`bootstrap` joins this process to its peers with
  ``torch.distributed.init_process_group`` from the environment a launcher
  sets: ``torchrun``'s names first, then the JAX package's (so a pod spec
  written for the JAX agent starts the port too);
- :func:`verify_dcn_mesh` all-reduces ones over the data axes, run after a
  node returns from a CC bounce and before training resumes: a half-formed
  mesh hangs or mis-counts here instead of corrupting gradients silently.

gloo has no ``ReduceOp.AVG``: every reduction of the port sums and divides.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from tpu_cc_manager_torch.parallel.mesh import BACKENDS

log = logging.getLogger(__name__)

JAX_COORDINATOR_PORT = 8476  # the JAX package's TPU_WORKER_HOSTNAMES port


def _env_int(*names: str, default: int | None = None) -> int | None:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            try:
                return int(v)
            except ValueError:
                continue
    return default


def _from_env() -> tuple[int | None, int, str | None, int]:
    """(process count, process id, coordinator host:port, local rank), the
    first launcher whose names are set winning."""
    if _env_int("WORLD_SIZE") is not None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        coordinator = f"{addr}:{port}" if addr and port else None
        return (_env_int("WORLD_SIZE"), _env_int("RANK", default=0), coordinator,
                _env_int("LOCAL_RANK", default=0))
    hostnames = [h for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    num = _env_int("JAX_NUM_PROCESSES")
    if num is None and len(hostnames) > 1:
        num = len(hostnames)
    coordinator = (
        os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("MEGASCALE_COORDINATOR_ADDRESS")
        or (f"{hostnames[0]}:{JAX_COORDINATOR_PORT}" if hostnames else None)
    )
    return (num, _env_int("JAX_PROCESS_ID", "TPU_WORKER_ID", default=0), coordinator,
            _env_int("LOCAL_RANK", default=0))


def bootstrap(timeout_s: int = 300, device: str = "cuda") -> dict:
    """Initialise the default process group from the environment,
    idempotently. A single process (no launcher names set) is a no-op.
    Returns a summary dict for logs."""
    num, pid, coordinator, local_rank = _from_env()
    if not num or num <= 1:
        log.info("distributed bootstrap: single process, nothing to do")
        return {"processes": 1, "initialized": False}
    if coordinator is None:
        raise RuntimeError(
            "multi-process env detected but no coordinator address "
            "(set MASTER_ADDR and MASTER_PORT, or JAX_COORDINATOR_ADDRESS)"
        )
    if not dist.is_initialized():
        device_type = torch.device(device).type
        if device_type not in BACKENDS:
            raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("bootstrap: CUDA requested but no CUDA card is present")
            torch.cuda.set_device(local_rank)
        dist.init_process_group(
            BACKENDS[device_type],
            init_method=f"tcp://{coordinator}",
            world_size=num,
            rank=pid,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        log.info("torch.distributed initialized: coordinator=%s process %d/%d local_rank %d",
                 coordinator, pid, num, local_rank)
    return {"processes": num, "process_id": pid, "initialized": True}


def sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed in place over each process group in turn (together:
    over their product), returned."""
    for group in groups:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def verify_dcn_mesh(mesh) -> bool:
    """All-reduce ones over the mesh's data axes (``dcn``, ``dp``,
    ``fsdp``); True when the total equals the number of participants."""
    from tpu_cc_manager_torch.parallel.sharding import data_groups

    groups, n = data_groups(mesh)
    dev = "cuda" if mesh.device_type == "cuda" else "cpu"
    total = int(sum_over(torch.ones(1, device=dev), groups).item())
    ok = total == n
    (log.info if ok else log.error)(
        "DCN mesh verification: expected %d, got %d -> %s", n, total, ok
    )
    return ok
