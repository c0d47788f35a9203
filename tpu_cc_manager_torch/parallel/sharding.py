"""Logical-axis -> mesh-axis sharding rules.

Port of ``tpu_cc_manager/parallel/sharding.py``. The JAX model annotates its
parameters with logical axis names and the rules map them onto mesh axes.
The port's modules carry no such metadata, so :data:`LLAMA_PARAM_AXES`
lists the logical axes of every parameter of the port's Llama, by the names
of ``models/convert.py`` (``blocks.attn.wq`` is the JAX
``blocks/attn/wq/kernel``); a stacked ``(L, ...)`` parameter leads with
``layers``, as the JAX ``nn.scan`` adds it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from tpu_cc_manager_torch.parallel.mesh import DATA_AXES, mesh_sizes

# logical axis -> mesh axis (None = replicated along that logical axis).
LOGICAL_AXIS_RULES = (
    ("batch", ("dcn", "dp", "fsdp")),  # global batch over all data axes
    ("seq", None),                      # sequence sharding arrives with ring attention
    ("embed", "fsdp"),                  # ZeRO-style weight sharding
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("layers", None),                   # the stacked-layer axis stays replicated
)

# The JAX Llama's axes: models/llama.py's RMSNorm scale, _dense kernels,
# embedding and lm_head.
LLAMA_PARAM_AXES = {
    "embedding": ("vocab", "embed"),
    "blocks.attn_norm.scale": ("layers", "embed"),
    "blocks.attn.wq": ("layers", "embed", "heads"),
    "blocks.attn.wk": ("layers", "embed", "kv_heads"),
    "blocks.attn.wv": ("layers", "embed", "kv_heads"),
    "blocks.attn.wo": ("layers", "heads", "embed"),
    "blocks.mlp_norm.scale": ("layers", "embed"),
    "blocks.mlp.w_gate": ("layers", "embed", "mlp"),
    "blocks.mlp.w_up": ("layers", "embed", "mlp"),
    "blocks.mlp.w_down": ("layers", "mlp", "embed"),
    "final_norm.scale": ("embed",),
    "lm_head": ("embed", "vocab"),
}


def _mesh_names(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_mesh_axes(logical: tuple[str, ...]) -> tuple:
    """flax's rule resolution: rules in order of precedence, each logical
    axis taking its rule's mesh axes unless an earlier assignment already
    used one of them; unmatched axes are replicated (None)."""
    unassigned = object()
    result = [unassigned] * len(logical)
    for name, mesh_axes in LOGICAL_AXIS_RULES:
        if name not in logical:
            continue
        pos = logical.index(name)
        used = {a for r in result if r is not unassigned for a in _mesh_names(r)}
        if result[pos] is unassigned and not used & set(_mesh_names(mesh_axes)):
            result[pos] = mesh_axes
    return tuple(None if r is unassigned else r for r in result)


def mesh_axes_for(param_name: str) -> tuple:
    """The mesh axes of each dim of a Llama parameter: the entries of the
    ``PartitionSpec`` that the JAX ``logical_state_sharding`` gives it."""
    return logical_to_mesh_axes(LLAMA_PARAM_AXES[param_name])


def placements_for(param_name: str, mesh: DeviceMesh) -> tuple:
    """DTensor placements of a Llama parameter on ``mesh``, one per mesh
    dim: ``Shard(d)`` where tensor dim ``d`` maps to that axis, else
    ``Replicate()``."""
    dims = {a: d for d, entry in enumerate(mesh_axes_for(param_name))
            for a in _mesh_names(entry)}
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.mesh_dim_names)


def fsdp_dim(param_name: str) -> int:
    """The dim the rules put on ``fsdp`` (the ``embed`` dim)."""
    return next(d for d, entry in enumerate(mesh_axes_for(param_name))
                if "fsdp" in _mesh_names(entry))


def data_groups(mesh: DeviceMesh):
    """(the process groups of the data axes, their product's size): summing
    over each group in turn sums over every data-parallel rank."""
    sizes = mesh_sizes(mesh)
    return [mesh.get_group(a) for a in DATA_AXES], math.prod(sizes[a] for a in DATA_AXES)


def data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 2-D ``(replicate, shard)`` mesh of FSDP2's HSDP: ``dcn`` x ``dp``
    replicate, ``fsdp`` shards. Built from the 5-D mesh's rank grid with the
    public constructor (``sp`` and ``tp`` must be 1)."""
    sizes = mesh_sizes(mesh)
    if sizes["sp"] * sizes["tp"] != 1:
        raise ValueError("data_mesh: sp and tp must be 1")
    grid = mesh.mesh.reshape(sizes["dcn"] * sizes["dp"], sizes["fsdp"])
    return DeviceMesh(mesh.device_type, grid, mesh_dim_names=("replicate", "shard"))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Dim 0 of the global batch over the data axes, in row-major rank
    order: this rank holds rows ``[index * n, (index + 1) * n)`` of
    ``count * n``."""

    index: int
    count: int

    def local(self, batch: torch.Tensor) -> torch.Tensor:
        if batch.shape[0] % self.count:
            raise ValueError(f"batch {batch.shape[0]} must divide evenly over "
                             f"{self.count} data-parallel ranks")
        n = batch.shape[0] // self.count
        return batch[self.index * n : (self.index + 1) * n]


def batch_sharding(mesh: DeviceMesh) -> BatchSharding:
    """This rank's share of an input batch: dim 0 over ``("dcn", "dp",
    "fsdp")``."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in DATA_AXES:
        index = index * sizes[a] + coord[a]
    return BatchSharding(index, math.prod(sizes[a] for a in DATA_AXES))

