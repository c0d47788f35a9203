"""Device meshes with the JAX package's five axes.

Port of ``tpu_cc_manager/parallel/mesh.py``. Axes, outermost first:

- ``dcn``  data parallelism across nodes;
- ``dp``   data parallelism within a node;
- ``fsdp`` parameter sharding (ZeRO-style) over data-parallel ranks;
- ``sp``   sequence parallelism (ring attention, ``ops/ring_attention.py``);
- ``tp``   tensor parallelism over the innermost, fastest dimension.

A mesh is a ``torch.distributed.DeviceMesh`` with one process per device
over the world of the default process group. Ranks are numbered node-major,
as ``torchrun`` numbers them, so the row-major layout puts ``dcn`` across
nodes and every other axis within one: the counterpart of JAX's
``create_hybrid_device_mesh``.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

log = logging.getLogger(__name__)

AXES = ("dcn", "dp", "fsdp", "sp", "tp")
DATA_AXES = ("dcn", "dp", "fsdp")

# One backend per device type; on the card, gloo serves only CPU tensors
# (torch.distributed.checkpoint's async save stages through them).
BACKENDS = {"cuda": "cpu:gloo,cuda:nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each mesh axis; -1 on dp means 'absorb remaining devices'."""

    dcn: int = 1
    dp: int = -1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        fixed = self.dcn * self.fsdp * self.sp * self.tp
        dp = self.dp
        if dp == -1:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by dcn*fsdp*sp*tp={fixed}"
                )
            dp = n_devices // fixed
        total = fixed * dp
        if total != n_devices:
            raise ValueError(f"mesh {self} needs {total} devices, have {n_devices}")
        return {"dcn": self.dcn, "dp": dp, "fsdp": self.fsdp, "sp": self.sp, "tp": self.tp}


def _ensure_process_group(device_type: str) -> None:
    """A default process group for ``device_type``'s backend. In a process
    that no launcher has joined to others, a one-rank group on an in-memory
    store: ``init_device_mesh`` would otherwise call ``init_process_group``
    with ``env://`` and fail without ``MASTER_ADDR``."""
    if dist.is_initialized():
        return
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported device type {device_type!r} (cuda or cpu)")
    dist.init_process_group(BACKENDS[device_type], store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(spec: MeshSpec | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` with ``mesh_dim_names=AXES`` over every rank of the
    default process group (created here, one rank, if there is none)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA requested but no CUDA card is present")
    spec = spec or MeshSpec()
    _ensure_process_group(device_type)
    sizes = spec.resolve(dist.get_world_size())
    mesh = init_device_mesh(device_type, tuple(sizes[a] for a in AXES), mesh_dim_names=AXES)
    log.info("mesh: %s over %d ranks", sizes, dist.get_world_size())
    return mesh


def mesh_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """Axis name -> size (the JAX ``mesh.shape`` mapping)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def default_spec_for(n_devices: int, want_tp: bool = True) -> MeshSpec:
    """A sensible mesh for n devices: largest power-of-two tp up to 4 that
    divides the device count, rest data-parallel."""
    tp = 1
    if want_tp:
        for candidate in (4, 2):
            if n_devices % candidate == 0 and n_devices > candidate:
                tp = candidate
                break
    dp = n_devices // tp
    return MeshSpec(dcn=1, dp=dp, fsdp=1, tp=tp)


def pad_batch_to(batch: int, mesh: DeviceMesh) -> int:
    """Smallest batch >= requested divisible by the mesh's data axes."""
    sizes = mesh_sizes(mesh)
    denom = math.prod(sizes[a] for a in DATA_AXES)
    return ((batch + denom - 1) // denom) * denom
